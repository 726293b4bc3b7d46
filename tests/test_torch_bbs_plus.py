"""The port's BBS+ signatures and proofs of knowledge against the
reference's (`crypto_tpu.bbs_plus`).

* BASELINE config 2: the parity fixture's `bbs_plus` entries
  (`tests/fixtures/parity_vectors.json`) at 32 messages, reproduced byte
  for byte from the same `random.Random(202)` sequence as
  `tests/test_parity_vectors.py`.
* At 4 and 7 messages, one seed through both packages: params hashed from
  a label, a key pair and a seeded secret key, a signature, a blind
  signature and its unblinding, and a PoK (`init`, contribution,
  challenge, `gen_proof`, two messages revealed and one blinding given):
  every byte equal.
* The reference's proofs carried across by `convert.protocol_to_port`
  verify in the port; spoiled ones (a response, a revealed message, A_bar)
  are rejected by both.
* Four signatures and four PoKs through one lazy `RandomizedPairingChecker`
  on the CPU: 16 deferred pairs, so the device-Miller branch runs on the
  plain versions through `TPairing`; valid, and with one signature spoiled,
  each verdict the reference's (its checker on the host Miller loop).
"""

import dataclasses
import json
import os
import random
from types import SimpleNamespace

import pytest

from crypto_tpu import hashing as jh
from crypto_tpu import serialize as js
from crypto_tpu.bbs_plus import proof as jproof
from crypto_tpu.bbs_plus import setup as jsetup
from crypto_tpu.bbs_plus import signature as jsig
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.utils import checkers as jcheckers
from crypto_tpu_torch import hashing as th
from crypto_tpu_torch import serialize as ts
from crypto_tpu_torch.bbs_plus import proof as tproof
from crypto_tpu_torch.bbs_plus import setup as tsetup
from crypto_tpu_torch.bbs_plus import signature as tsig
from crypto_tpu_torch.convert import protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.utils import checkers as tcheckers
from crypto_tpu_torch.testing import cap_threads

cap_threads()

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "parity_vectors.json")
ENV = "CRYPTO_TPU_PAIRING_BACKEND"
REF = SimpleNamespace(b=jb, setup=jsetup, sig=jsig, proof=jproof, ser=js,
                      h=jh)
PORT = SimpleNamespace(b=tb, setup=tsetup, sig=tsig, proof=tproof, ser=ts,
                       h=th)


def test_parity_fixture_bbs_plus():
    """BASELINE config 2: BBS+ sign and PoK over 32 messages."""
    P = PORT
    F = tb.Fr
    rng = random.Random(202)
    params = P.setup.SignatureParamsG1.new(b"parity-bbs", 32)
    kp = P.setup.KeypairG2.generate(rng, params)
    msgs = [F.rand(rng) for _ in range(32)]
    sig = P.sig.SignatureG1.new(rng, msgs, kp.secret_key, params)
    assert sig.verify(msgs, kp.public_key, params)
    mabs = [P.proof.MessageOrBlinding.reveal_message(m) if i < 4
            else P.proof.MessageOrBlinding.blind_randomly(m)
            for i, m in enumerate(msgs)]
    prot = P.proof.PoKOfSignatureG1Protocol.init(rng, sig, params, mabs)
    revealed = {i: msgs[i] for i in range(4)}
    w = ts.ByteWriter()
    prot.challenge_contribution(revealed, params, w)
    ch = th.compute_random_oracle_challenge(F, w.bytes())
    pok = prot.gen_proof(ch)
    assert pok.verify(revealed, ch, kp.public_key, params)
    sp = ts.serialize_point
    got = {
        "params_g1": sp(params.g1).hex(),
        "params_h0": sp(params.h_0).hex(),
        "params_h5": sp(params.h[5]).hex(),
        "pk_w": sp(kp.public_key.w).hex(),
        "sig_A": sp(sig.A).hex(),
        "sig_e": sig.e.to_bytes_le().hex(),
        "sig_s": sig.s.to_bytes_le().hex(),
        "challenge": ch.to_bytes_le().hex(),
        "A_prime": sp(pok.A_prime).hex(),
    }
    with open(FIXTURE) as f:
        assert got == json.load(f)["bbs_plus"]


def _flow(P, n: int, seed: int):
    """One seeded BBS+ flow in package P: returns (bytes by name, objects)."""
    F = P.b.Fr
    sp = P.ser.serialize_point
    rng = random.Random(seed)
    params = P.setup.SignatureParamsG1.new(b"torch-bbs-%d" % n, n)
    kp = P.setup.KeypairG2.generate(rng, params)
    seeded = P.setup.SecretKey.from_seed(b"seed-%d" % n)
    msgs = [F.rand(rng) for _ in range(n)]
    sig = P.sig.SignatureG1.new(rng, msgs, kp.secret_key, params)
    # blind signing: messages 0 and 1 committed with h_0 * blinding
    blinding = F.rand(rng)
    commitment = params.commit_to_messages([(0, msgs[0]), (1, msgs[1])],
                                           blinding)
    blind = P.sig.SignatureG1.new_with_committed_messages(
        rng, commitment, {i: msgs[i] for i in range(2, n)}, kp.secret_key,
        params)
    unblinded = blind.unblind(blinding)
    revealed = {0: msgs[0], 2: msgs[2]}
    given = F.rand(rng)
    mabs = [P.proof.MessageOrBlinding.reveal_message(m) if i in revealed
            else P.proof.MessageOrBlinding.blind_with(m, given) if i == 1
            else P.proof.MessageOrBlinding.blind_randomly(m)
            for i, m in enumerate(msgs)]
    prot = P.proof.PoKOfSignatureG1Protocol.init(rng, sig, params, mabs)
    w = P.ser.ByteWriter()
    prot.challenge_contribution(revealed, params, w)
    ch = P.h.compute_random_oracle_challenge(F, w.bytes())
    pok = prot.gen_proof(ch)
    out = {
        "params": [sp(p) for p in [params.g1, params.g2, params.h_0]
                   + params.h],
        "keys": [kp.secret_key.x.to_bytes_le(), sp(kp.public_key.w),
                 seeded.x.to_bytes_le()],
        "sig": [sp(sig.A), sig.e.to_bytes_le(), sig.s.to_bytes_le()],
        "blind": [sp(commitment), sp(blind.A), blind.s.to_bytes_le(),
                  unblinded.s.to_bytes_le()],
        "contribution": w.bytes(),
        "proof": [sp(p) for p in (pok.A_prime, pok.A_bar, pok.d,
                                  pok.sc_resp_1.t, pok.T2)]
        + [r.to_bytes_le() for r in (pok.sc_resp_1.response1,
                                     pok.sc_resp_1.response2,
                                     *pok.sc_resp_2.responses)],
        "resp_for_1": pok.get_resp_for_message(1, set(revealed))
        .to_bytes_le(),
    }
    objs = SimpleNamespace(params=params, kp=kp, msgs=msgs, sig=sig,
                           unblinded=unblinded, revealed=revealed, ch=ch,
                           pok=pok, seeded=seeded)
    return out, objs


@pytest.fixture(scope="module", params=[4, 7])
def flows(request):
    return _flow(REF, request.param, 31), _flow(PORT, request.param, 31)


def test_bytes_vs_reference(flows):
    (ref, _), (port, o) = flows
    assert port == ref
    pk, params = o.kp.public_key, o.params
    assert o.sig.verify(o.msgs, pk, params)
    assert o.unblinded.verify(o.msgs, pk, params)
    assert not o.sig.verify(o.msgs[::-1], pk, params)
    assert o.pok.verify(o.revealed, o.ch, pk, params)
    with pytest.raises(tsig.BBSPlusError):
        o.pok.get_resp_for_message(0, set(o.revealed))
    with pytest.raises(tsig.BBSPlusError):
        tsig.SignatureG1.new(random.Random(1), o.msgs[:-1],
                             o.kp.secret_key, params)
    o.seeded.zeroize()
    assert o.seeded.x == tb.Fr(0)


def _spoil(pok, revealed, what, F):
    """The reference's proof and revealed messages with one part off."""
    revealed = dict(revealed)
    if what == "response":
        resp = list(pok.sc_resp_2.responses)
        resp[0] = resp[0] + F(1)
        pok = dataclasses.replace(
            pok, sc_resp_2=dataclasses.replace(pok.sc_resp_2,
                                               responses=resp))
    elif what == "revealed":
        revealed[0] = revealed[0] + F(1)
    elif what == "A_bar":
        pok = dataclasses.replace(pok, A_bar=(pok.A_bar + pok.d).normalize())
    return pok, revealed


@pytest.mark.parametrize("what", ["valid", "response", "revealed", "A_bar"])
def test_reference_proof_in_port(flows, what):
    (_, j), (_, o) = flows
    jpok, jrev = _spoil(j.pok, j.revealed, what, jb.Fr)
    pok, rev = protocol_to_port(jpok), protocol_to_port(jrev)
    pk, params = protocol_to_port(j.kp.public_key), protocol_to_port(j.params)
    assert [ts.serialize_point(p) for p in params.h] \
        == [ts.serialize_point(p) for p in o.params.h]
    ch = protocol_to_port(j.ch)
    if what == "valid":
        assert jpok.verify(jrev, j.ch, j.kp.public_key, j.params)
        assert pok.verify(rev, ch, pk, params)
        return
    with pytest.raises(jsig.BBSPlusError):
        jpok.verify(jrev, j.ch, j.kp.public_key, j.params)
    with pytest.raises(tsig.BBSPlusError):
        pok.verify(rev, ch, pk, params)


def _checker_items(P, seed: int, n: int = 4, msgs_n: int = 4):
    """n signatures and n PoKs (one message revealed) in package P."""
    F = P.b.Fr
    rng = random.Random(seed)
    params = P.setup.SignatureParamsG1.generate_using_rng(rng, msgs_n)
    kp = P.setup.KeypairG2.generate(rng, params)
    sigs, poks = [], []
    for _ in range(n):
        msgs = [F.rand(rng) for _ in range(msgs_n)]
        sig = P.sig.SignatureG1.new(rng, msgs, kp.secret_key, params)
        mabs = [P.proof.MessageOrBlinding.reveal_message(m) if i == 0
                else P.proof.MessageOrBlinding.blind_randomly(m)
                for i, m in enumerate(msgs)]
        prot = P.proof.PoKOfSignatureG1Protocol.init(rng, sig, params, mabs)
        revealed = {0: msgs[0]}
        w = P.ser.ByteWriter()
        prot.challenge_contribution(revealed, params, w)
        ch = P.h.compute_random_oracle_challenge(F, w.bytes())
        sigs.append((sig, msgs))
        poks.append((prot.gen_proof(ch), revealed, ch))
    return params, kp.public_key, sigs, poks


def _check(checkers, P, items, spoil: bool, **kw):
    params, pk, sigs, poks = items
    c = checkers.RandomizedPairingChecker(P.b.Fr(12345), lazy=True, **kw)
    for k, (sig, msgs) in enumerate(sigs):
        if spoil and k == 2:
            sig = dataclasses.replace(sig, e=sig.e + P.b.Fr(1))
        sig.verify_with_pairing_checker(msgs, pk, params, c)
    for pok, revealed, ch in poks:
        pok.verify_with_randomized_pairing_checker(revealed, ch, pk, params,
                                                   c)
    return len(c.pending), c.verify()


@pytest.mark.parametrize("spoil", [False, True])
def test_lazy_checker_vs_reference(spoil, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    ref = _check(jcheckers, REF, _checker_items(REF, 53), spoil)
    monkeypatch.delenv(ENV)
    calls = []
    real = tcheckers.tpairing_for

    def counted(name, device):
        calls.append(device.type)
        return real(name, device)

    monkeypatch.setattr(tcheckers, "tpairing_for", counted)
    port = _check(tcheckers, PORT, _checker_items(PORT, 53), spoil,
                  device="cpu")
    assert port == ref == (16, not spoil)
    assert calls == ["cpu"]
