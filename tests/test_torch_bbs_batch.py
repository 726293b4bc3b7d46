"""The port's BBS+ batch signature verification against the reference's.

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
"""

import random
from types import SimpleNamespace

import pytest

from crypto_tpu.bbs_plus import batch as jbatch
from crypto_tpu.bbs_plus.setup import KeypairG2, SignatureParamsG1
from crypto_tpu.bbs_plus.signature import SignatureG1
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.bbs_plus import batch as tbatch
from crypto_tpu_torch.convert import carry_point
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
