"""The port's BBS+ batch verification against the reference's.

Signatures made with the reference's `crypto_tpu.bbs_plus` (random
params, a key pair, six signatures over four messages from a `random`
seed), carried across by `convert` into plain attribute holders:
`batch_verify_signatures` of the port (`crypto_tpu_torch/bbs_plus/
batch.py`) against the reference's on valid and spoiled sets (one
signature's e or one message off by one), with the pairing on the host
and, under `CRYPTO_TPU_PAIRING_BACKEND=device`, through `TPairing` on the
CPU.  The device-MSM branch runs once, at four signatures, with the
port's `DEVICE_MSM_THRESHOLD` lowered to 4 (the reference's module is
left as it is: its threshold is 256).

PoK proofs made with the reference's protocol (six proofs, one message
revealed), carried across by `convert.protocol_to_port`:
`batch_verify_proofs` of the port against the reference's on the valid
set, one response off by one, one proof made under another key (its
Schnorr legs hold, its pairing leg fails), one revealed message off by
one, and that set with `revealed_list` and `challenges` cut to one entry:
the reference zips the three lists without a length check, so the
surplus proofs skip their Schnorr legs and both packages accept it (the
fault is pinned here and logged in ROADMAP Queue 3).  The device-MSM
branch runs once on the proofs too.
"""

import dataclasses
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.bbs_plus import batch as jbatch
from crypto_tpu.bbs_plus.proof import (MessageOrBlinding,
                                       PoKOfSignatureG1Protocol)
from crypto_tpu.bbs_plus.setup import KeypairG2, SignatureParamsG1
from crypto_tpu.bbs_plus.signature import SignatureG1
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.hashing import compute_random_oracle_challenge
from crypto_tpu.serialize import ByteWriter
from crypto_tpu_torch.bbs_plus import batch as tbatch
from crypto_tpu_torch.convert import carry_point, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
N, MSGS = 6, 4


@pytest.fixture(scope="module")
def signed():
    rng = random.Random(41)
    params = SignatureParamsG1.generate_using_rng(rng, MSGS)
    kp = KeypairG2.generate(rng, params)
    msgs = [[jb.Fr.rand(rng) for _ in range(MSGS)] for _ in range(N)]
    sigs = [SignatureG1.new(rng, m, kp.secret_key, params) for m in msgs]
    return params, kp.public_key, sigs, msgs


def _spoil(signed, what: str):
    """The set with signature 2's e or message (3, 1) off by one."""
    params, pk, sigs, msgs = signed
    sigs, msgs = list(sigs), [list(m) for m in msgs]
    if what == "e":
        s = sigs[2]
        sigs[2] = SignatureG1(A=s.A, e=s.e + jb.Fr(1), s=s.s)
    elif what == "message":
        msgs[3][1] = msgs[3][1] + jb.Fr(1)
    return params, pk, sigs, msgs


def _port(params, pk, sigs, msgs):
    """The reference's objects as the port reads them: by attribute."""
    P = SimpleNamespace(
        g1=carry_point(params.g1, tb.G1), g2=carry_point(params.g2, tb.G2),
        h_0=carry_point(params.h_0, tb.G1),
        h=[carry_point(h, tb.G1) for h in params.h],
        supported_message_count=params.supported_message_count)
    K = SimpleNamespace(w=carry_point(pk.w, tb.G2))
    S = [SimpleNamespace(A=carry_point(s.A, tb.G1), e=tb.Fr(int(s.e)),
                         s=tb.Fr(int(s.s))) for s in sigs]
    M = [[tb.Fr(int(x)) for x in m] for m in msgs]
    return P, K, S, M


def _both(params, pk, sigs, msgs, k=N):
    """(reference, port) verdicts on the first k signatures, from the same
    rng seed; the reference always on its host pairing."""
    ref = jbatch.batch_verify_signatures(sigs[:k], msgs[:k], pk, params,
                                         random.Random(42))
    P, K, S, M = _port(params, pk, sigs, msgs)
    port = tbatch.batch_verify_signatures(S[:k], M[:k], K, P,
                                          random.Random(42), device="cpu")
    return ref, port


@pytest.mark.parametrize("what", ["valid", "e", "message"])
def test_batch_verify_host_pairing_vs_reference(signed, what, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    ref, port = _both(*_spoil(signed, what))
    assert ref is port is (what == "valid")


@pytest.mark.parametrize("what", ["valid", "e"])
def test_batch_verify_device_pairing_vs_reference(signed, what,
                                                  monkeypatch):
    """The 2-pairing product through `TPairing` on the CPU."""
    monkeypatch.setenv(ENV, "device")
    monkeypatch.setattr(jbatch, "_multi_pairing", jb.multi_pairing)
    calls = []
    real = tbatch.tpairing_for

    def counted(name, device):
        calls.append(device)
        return real(name, device)

    monkeypatch.setattr(tbatch, "tpairing_for", counted)
    ref, port = _both(*_spoil(signed, what))
    assert ref is port is (what == "valid")
    assert len(calls) == 1 and calls[0].type == "cpu"


def test_batch_verify_device_msm_branch(signed, monkeypatch):
    """Both N-point MSMs through `msm_device_scheduled` on the CPU (the
    threshold lowered to 4 in the port's module only), each equal to the
    host MSM, and the verdict the reference's."""
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(tbatch, "DEVICE_MSM_THRESHOLD", 4)
    seen = []
    real = tbatch.msm_device_scheduled

    def recorded(curve, points, scalars, device):
        out = real(curve, points, scalars, device=device)
        seen.append(out == tbatch.msm_host(points, scalars))
        return out

    monkeypatch.setattr(tbatch, "msm_device_scheduled", recorded)
    ref, port = _both(*signed, k=4)
    assert ref is port is True
    assert seen == [True, True]


def test_batch_verify_input_checks(signed):
    P, K, S, M = _port(*signed)
    with pytest.raises(tbatch.BBSPlusError):
        tbatch.batch_verify_signatures(S, M[:-1], K, P, device="cpu")
    with pytest.raises(tbatch.BBSPlusError):
        tbatch.batch_verify_signatures(S[:1], [M[0][:-1]], K, P,
                                       device="cpu")
    assert tbatch.batch_verify_signatures([], [], K, P, device="cpu")


@pytest.fixture(scope="module")
def proved():
    """Six PoKs over four messages (message 0 revealed) under one key, and
    one more made from a signature under another key."""
    rng = random.Random(43)
    params = SignatureParamsG1.generate_using_rng(rng, MSGS)
    kp, other = (KeypairG2.generate(rng, params) for _ in range(2))
    proofs, revealed, challenges = [], [], []
    for k in range(N + 1):
        msgs = [jb.Fr.rand(rng) for _ in range(MSGS)]
        sk = (other if k == N else kp).secret_key
        sig = SignatureG1.new(rng, msgs, sk, params)
        mabs = [MessageOrBlinding.reveal_message(m) if i == 0
                else MessageOrBlinding.blind_randomly(m)
                for i, m in enumerate(msgs)]
        prot = PoKOfSignatureG1Protocol.init(rng, sig, params, mabs)
        w = ByteWriter()
        prot.challenge_contribution({0: msgs[0]}, params, w)
        ch = compute_random_oracle_challenge(jb.Fr, w.bytes())
        proofs.append(prot.gen_proof(ch))
        revealed.append({0: msgs[0]})
        challenges.append(ch)
    return params, kp.public_key, proofs, revealed, challenges


def _proof_set(proved, what: str):
    """The six proofs' lists with one spoiled as `what` says."""
    params, pk, proofs, revealed, challenges = proved
    proofs, revealed = list(proofs[:N]), [dict(r) for r in revealed[:N]]
    challenges = challenges[:N]
    if what == "response":
        p = proofs[2]
        resp = list(p.sc_resp_2.responses)
        resp[0] = resp[0] + jb.Fr(1)
        proofs[2] = dataclasses.replace(
            p, sc_resp_2=dataclasses.replace(p.sc_resp_2, responses=resp))
    elif what == "other_key":
        proofs[3], revealed[3] = proved[2][N], dict(proved[3][N])
        challenges = challenges[:3] + [proved[4][N]] + challenges[4:]
    elif what in ("revealed", "short_list"):
        revealed[1][0] = revealed[1][0] + jb.Fr(1)
        if what == "short_list":
            revealed, challenges = revealed[:1], challenges[:1]
    return params, pk, proofs, revealed, challenges


def _both_proofs(params, pk, proofs, revealed, challenges):
    ref = jbatch.batch_verify_proofs(proofs, revealed, challenges, pk,
                                     params, random.Random(44))
    port = tbatch.batch_verify_proofs(
        protocol_to_port(proofs), protocol_to_port(revealed),
        protocol_to_port(challenges), protocol_to_port(pk),
        protocol_to_port(params), random.Random(44), device="cpu")
    return ref, port


@pytest.mark.parametrize("what", ["valid", "response", "other_key",
                                  "revealed", "short_list"])
def test_batch_verify_proofs_vs_reference(proved, what, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    ref, port = _both_proofs(*_proof_set(proved, what))
    assert ref is port is (what in ("valid", "short_list"))


def test_batch_verify_proofs_device_msm_branch(proved, monkeypatch):
    """U and V through `msm_device_scheduled` on the CPU (the port's
    threshold lowered to 4), each equal to the host MSM."""
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(tbatch, "DEVICE_MSM_THRESHOLD", 4)
    seen = []
    real = tbatch.msm_device_scheduled

    def recorded(curve, points, scalars, device):
        out = real(curve, points, scalars, device=device)
        seen.append(out == tbatch.msm_host(points, scalars))
        return out

    monkeypatch.setattr(tbatch, "msm_device_scheduled", recorded)
    ref, port = _both_proofs(*_proof_set(proved, "valid"))
    assert ref is port is True
    assert seen == [True, True]
    assert tbatch.batch_verify_proofs([], [], [], None, None, device="cpu")
