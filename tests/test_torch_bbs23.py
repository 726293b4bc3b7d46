"""The port's BBS signatures of 2023 and their three proofs of knowledge
against the reference's (`crypto_tpu.bbs_plus.bbs23`).

* At 4 and 6 messages, one seed through both packages: params hashed from
  a label, a key, a signature, and each PoK (`PoKOfSignature23G1`, the
  IETF form and the CDL form: `init` with one blinding given,
  contribution, challenge, `gen_proof`, two messages revealed): every byte
  equal.
* The reference's proofs carried across by `convert.protocol_to_port`
  verify in the port; spoiled ones (a response, a revealed message, A_bar)
  are rejected by both.
* Two proofs of each form through one lazy `RandomizedPairingChecker` on
  the CPU (12 deferred pairs: the device-Miller branch on the plain
  versions through `TPairing`); valid, and with one proof checked against
  another key (its Schnorr legs hold, its pairing fails), each verdict the
  reference's.
"""

import dataclasses
import random
from types import SimpleNamespace

import pytest

from crypto_tpu import hashing as jh
from crypto_tpu import serialize as js
from crypto_tpu.bbs_plus import bbs23 as j23
from crypto_tpu.bbs_plus import setup as jsetup
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.utils import checkers as jcheckers
from crypto_tpu_torch import hashing as th
from crypto_tpu_torch import serialize as ts
from crypto_tpu_torch.bbs_plus import bbs23 as t23
from crypto_tpu_torch.bbs_plus import setup as tsetup
from crypto_tpu_torch.convert import protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.utils import checkers as tcheckers

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
REF = SimpleNamespace(b=jb, m=j23, setup=jsetup, ser=js, h=jh)
PORT = SimpleNamespace(b=tb, m=t23, setup=tsetup, ser=ts, h=th)
KINDS = {"pok23": "PoKOfSignature23G1Protocol",
         "ietf": "PoKOfSignature23IETFProtocol",
         "cdl": "PoKOfSignature23CDLProtocol"}


def _proof_bytes(P, pok) -> list:
    """Every point and scalar of a proof of any of the three forms."""
    out = []
    for f in dataclasses.fields(pok):
        v = getattr(pok, f.name)
        if hasattr(v, "Z"):
            out.append(P.ser.serialize_point(v))
        elif hasattr(v, "responses"):
            out += [r.to_bytes_le() for r in v.responses]
        elif hasattr(v, "response1"):
            out += [P.ser.serialize_point(v.t), v.response1.to_bytes_le(),
                    v.response2.to_bytes_le()]
    return out


def _flow(P, n: int, seed: int):
    F = P.b.Fr
    sp = P.ser.serialize_point
    rng = random.Random(seed)
    params = P.m.SignatureParams23G1.new(b"torch-bbs23-%d" % n, n)
    sk = P.setup.SecretKey.generate(rng)
    pk = P.m.PublicKey23G2.generate(sk, params)
    msgs = [F.rand(rng) for _ in range(n)]
    sig = P.m.Signature23G1.new(rng, msgs, sk, params)
    revealed = {0: msgs[0], 2: msgs[2]}
    out = {"params": [sp(p) for p in [params.g1, params.g2] + params.h],
           "pk": sp(pk.w), "sig": [sp(sig.A), sig.e.to_bytes_le()]}
    proofs = {}
    for kind, cls in KINDS.items():
        prot = getattr(P.m, cls).init(rng, sig, params, msgs, set(revealed),
                                      blindings={1: F.rand(rng)})
        w = P.ser.ByteWriter()
        prot.challenge_contribution(revealed, params, w)
        ch = P.h.compute_random_oracle_challenge(F, w.bytes())
        pok = prot.gen_proof(ch)
        out[kind] = [w.bytes()] + _proof_bytes(P, pok)
        proofs[kind] = (pok, ch)
    return out, SimpleNamespace(params=params, pk=pk, msgs=msgs, sig=sig,
                                revealed=revealed, proofs=proofs)


@pytest.fixture(scope="module", params=[4, 6])
def flows(request):
    return _flow(REF, request.param, 61), _flow(PORT, request.param, 61)


def test_bytes_vs_reference(flows):
    (ref, _), (port, o) = flows
    assert port == ref
    assert o.sig.verify(o.msgs, o.pk, o.params)
    assert not o.sig.verify(o.msgs[::-1], o.pk, o.params)
    for pok, ch in o.proofs.values():
        assert pok.verify(o.revealed, ch, o.pk, o.params)
    ietf = o.proofs["ietf"][0]
    assert ietf.get_resp_for_message(0) == ietf.response.responses[0]


def _spoil(pok, revealed, what, F):
    revealed = dict(revealed)
    if what == "response":
        name = "response" if hasattr(pok, "response") else "sc_resp_2"
        resp = getattr(pok, name)
        rs = list(resp.responses)
        rs[1] = rs[1] + F(1)
        pok = dataclasses.replace(
            pok, **{name: dataclasses.replace(resp, responses=rs)})
    elif what == "revealed":
        revealed[0] = revealed[0] + F(1)
    elif what == "A_bar":
        pok = dataclasses.replace(pok, A_bar=pok.A_bar.double().normalize())
    return pok, revealed


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("what", ["valid", "response", "revealed", "A_bar"])
def test_reference_proof_in_port(flows, kind, what):
    (_, j), _ = flows
    jpok, ch = j.proofs[kind]
    jpok, jrev = _spoil(jpok, j.revealed, what, jb.Fr)
    ref = jpok.verify(jrev, ch, j.pk, j.params)
    port = protocol_to_port(jpok).verify(
        protocol_to_port(jrev), protocol_to_port(ch),
        protocol_to_port(j.pk), protocol_to_port(j.params))
    assert ref is port is (what == "valid")


def _items(P, seed: int):
    """Two proofs of each form over 4 messages, one revealed, and a second
    key's public key."""
    F = P.b.Fr
    rng = random.Random(seed)
    params = P.m.SignatureParams23G1.new(b"torch-bbs23-checker", 4)
    sk = P.setup.SecretKey.generate(rng)
    pk = P.m.PublicKey23G2.generate(sk, params)
    other = P.m.PublicKey23G2.generate(P.setup.SecretKey.generate(rng),
                                       params)
    proofs = []
    for cls in list(KINDS.values()) * 2:
        msgs = [F.rand(rng) for _ in range(4)]
        sig = P.m.Signature23G1.new(rng, msgs, sk, params)
        prot = getattr(P.m, cls).init(rng, sig, params, msgs, {0})
        revealed = {0: msgs[0]}
        w = P.ser.ByteWriter()
        prot.challenge_contribution(revealed, params, w)
        ch = P.h.compute_random_oracle_challenge(F, w.bytes())
        proofs.append((prot.gen_proof(ch), revealed, ch))
    return params, pk, other, proofs


def _check(checkers, P, items, spoil: bool, **kw):
    params, pk, other, proofs = items
    c = checkers.RandomizedPairingChecker(P.b.Fr(777), lazy=True, **kw)
    for k, (pok, revealed, ch) in enumerate(proofs):
        key = other if spoil and k == 4 else pk
        assert pok.verify(revealed, ch, key, params, pairing_checker=c)
    return len(c.pending), c.verify()


@pytest.mark.parametrize("spoil", [False, True])
def test_lazy_checker_vs_reference(spoil, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    ref = _check(jcheckers, REF, _items(REF, 67), spoil)
    monkeypatch.delenv(ENV)
    calls = []
    real = tcheckers.tpairing_for

    def counted(name, device):
        calls.append(device.type)
        return real(name, device)

    monkeypatch.setattr(tcheckers, "tpairing_for", counted)
    port = _check(tcheckers, PORT, _items(PORT, 67), spoil, device="cpu")
    assert port == ref == (12, not spoil)
    assert calls == ["cpu"]
