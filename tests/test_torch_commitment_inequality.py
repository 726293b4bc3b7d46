"""The port's Pedersen commitment keys (`crypto_tpu_torch/utils/
commitment.py`), `utils/ff.py`'s `hadamard_product` and the Schnorr
inequality proofs (`crypto_tpu_torch/schnorr/inequality.py`) against the
reference's (`crypto_tpu/utils/commitment.py`, `crypto_tpu/schnorr/
inequality.py`).

Each object is made in both packages from the same `random.Random` seed:
keys, commitments, challenge contributions and proofs are equal byte for
byte and integer for integer, each package verifies the other's proof
(carried across with `convert.protocol_to_port` and `to_ref`), and a
wrong public value, a spoiled response, another commitment and equal
values are refused by both.
"""

import dataclasses
import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import (canonical, carry_fp12, carry_point,
                                      protocol_to_port)
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()


def to_ref(obj):
    """A port object as the reference's: dataclasses by the class of the
    same name in the reference's module of the same name, classes with `__slots__` slot by slot, points, GT and
    field elements by value, containers item by item."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _ref_class(obj)(**{f.name: to_ref(getattr(obj, f.name))
                                  for f in dataclasses.fields(obj)})
    if hasattr(obj, "curve") and hasattr(obj, "Z"):
        return carry_point(obj, jb.G2 if hasattr(obj.X, "c0") else jb.G1)
    if hasattr(obj, "c1") and hasattr(getattr(obj, "c0", None), "c2"):
        return carry_fp12(obj, jb.Fq12)
    if hasattr(obj, "f") and hasattr(obj, "v"):
        return (jb.Fr if obj.f.p == jb.R else jb.Fq)(int(obj))
    if type(obj).__module__.startswith("crypto_tpu_torch.") and \
            getattr(type(obj), "__slots__", None):
        return _ref_class(obj)(**{s: to_ref(getattr(obj, s))
                                  for s in type(obj).__slots__})
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(to_ref(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_ref(v) for k, v in obj.items()}
    return obj


def _ref_class(obj):
    mod = importlib.import_module(
        "crypto_tpu." + type(obj).__module__[len("crypto_tpu_torch."):])
    return getattr(mod, type(obj).__name__)


def pkg(root):
    """The modules these tests use, of `root`."""
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("commitment", "utils.commitment"), ("ff", "utils.ff"),
        ("ineq", "schnorr.inequality"), ("serialize", "serialize"),
        ("hashing", "hashing"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def challenge_of(P, contribute):
    w = P.serialize.ByteWriter()
    contribute(w)
    return w.bytes(), P.hashing.compute_random_oracle_challenge(P.b.Fr,
                                                                w.bytes())


@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_pedersen_commitment_key(curve):
    keys = [P.commitment.PedersenCommitmentKey.new(
        getattr(P.b, curve), b"ck-parity") for P in (REF, PORT)]
    assert canonical(keys[0]) == canonical(keys[1])
    assert canonical(protocol_to_port(keys[0])) == canonical(keys[1])
    rng_vals = random.Random(5)
    m, r = (rng_vals.randrange(jb.R) for _ in range(2))
    c = [k.commit(P.b.Fr(m), P.b.Fr(r)) for k, P in zip(keys, (REF, PORT))]
    assert canonical(c[0]) == canonical(c[1])
    want = keys[1].g.mul_raw(m) + keys[1].h.mul_raw(r)
    assert c[1] == want.normalize()


def test_pedersen_commitment_key_vec():
    out = []
    for P in (REF, PORT):
        rng = random.Random(6)
        bases = [P.b.G1.rand(rng).normalize() for _ in range(5)]
        h = P.b.G1.rand(rng).normalize()
        msgs = [P.b.Fr.rand(rng) for _ in range(4)]
        r = P.b.Fr.rand(rng)
        ck = P.commitment.PedersenCommitmentKeyVec(bases, h)
        out.append((ck.commit(msgs), ck.commit(msgs, r)))
    assert canonical(out[0]) == canonical(out[1])


def test_hadamard_product():
    a = [tb.Fr(3), tb.Fr(tb.R - 1), tb.Fr(7)]
    b = [tb.Fr(5), tb.Fr(2), tb.Fr(11), tb.Fr(13)]
    got = PORT.ff.hadamard_product(a, b)
    want = REF.ff.hadamard_product([jb.Fr(int(x)) for x in a],
                                   [jb.Fr(int(x)) for x in b])
    assert [int(x) for x in got] == [int(x) for x in want] == \
        [15, tb.R - 2, 77]


def _public_world(P, seed):
    rng = random.Random(seed)
    F = P.b.Fr
    ck = P.commitment.PedersenCommitmentKey.new(P.b.G1, b"ineq-parity")
    m, r, v = F.rand(rng), F.rand(rng), F.rand(rng)
    C = ck.commit(m, r)
    prot = P.ineq.DiscreteLogInequalityProtocol.init_with_public_value(
        rng, m, r, C, v, ck)
    contrib, c = challenge_of(
        P, lambda w: prot.challenge_contribution(C, v, ck, w))
    return dict(ck=ck, m=m, r=r, C=C, v=v, contrib=contrib, c=c,
                proof=prot.gen_proof(c))


def test_inequality_public_value_parity():
    ref, port = _public_world(REF, 41), _public_world(PORT, 41)
    assert ref["contrib"] == port["contrib"]
    assert canonical(ref["proof"]) == canonical(port["proof"])
    # the verifier's contribution equals the prover's
    w = PORT.serialize.ByteWriter()
    port["proof"].challenge_contribution(port["C"], port["v"], port["ck"], w)
    assert w.bytes() == port["contrib"]
    # each package verifies the other's proof
    assert protocol_to_port(ref["proof"]).verify_with_public_value(
        port["C"], port["v"], port["c"], port["ck"])
    assert to_ref(port["proof"]).verify_with_public_value(
        ref["C"], ref["v"], ref["c"], ref["ck"])
    assert port["proof"].response_for_value() == \
        PORT.b.Fr(int(ref["proof"].response_for_value()))


@pytest.mark.parametrize("spoil", ["public_value", "response", "commitment",
                                   "challenge"])
def test_inequality_public_value_refused(spoil):
    for P in (REF, PORT):
        w = _public_world(P, 42)
        F = P.b.Fr
        proof, C, v, c = w["proof"], w["C"], w["v"], w["c"]
        if spoil == "public_value":
            v = v + F(1)
        elif spoil == "response":
            proof = dataclasses.replace(proof, sc_b=dataclasses.replace(
                proof.sc_b, response=proof.sc_b.response + F(1)))
        elif spoil == "commitment":
            C = w["ck"].commit(w["m"] + F(1), w["r"])
        else:
            c = c + F(1)
        assert not proof.verify_with_public_value(C, v, c, w["ck"])


def test_inequality_equal_values_refused():
    for P in (REF, PORT):
        rng = random.Random(43)
        ck = P.commitment.PedersenCommitmentKey.new(P.b.G1, b"ineq-eq")
        m, r = P.b.Fr.rand(rng), P.b.Fr.rand(rng)
        with pytest.raises(P.ineq.InequalityError):
            P.ineq.DiscreteLogInequalityProtocol.init_with_public_value(
                rng, m, r, ck.commit(m, r), m, ck)
        with pytest.raises(P.ineq.InequalityError):
            P.ineq.DiscreteLogInequalityProtocol.init_with_committed_value(
                rng, m, r, ck.commit(m, r), m, r + P.b.Fr(1),
                ck.commit(m, r + P.b.Fr(1)), ck)


def _committed_world(P, seed):
    rng = random.Random(seed)
    F = P.b.Fr
    ck = P.commitment.PedersenCommitmentKey.new(P.b.G1, b"ineq-committed")
    m1, r1, m2, r2 = (F.rand(rng) for _ in range(4))
    C1, C2 = ck.commit(m1, r1), ck.commit(m2, r2)
    prot = P.ineq.DiscreteLogInequalityProtocol.init_with_committed_value(
        rng, m1, r1, C1, m2, r2, C2, ck)
    C = (C1 - C2).normalize()
    contrib, c = challenge_of(
        P, lambda w: prot.challenge_contribution(C, F(0), ck, w))
    return dict(ck=ck, C1=C1, C2=C2, contrib=contrib, c=c,
                proof=prot.gen_proof(c))


def test_inequality_committed_values_parity():
    ref, port = _committed_world(REF, 44), _committed_world(PORT, 44)
    assert ref["contrib"] == port["contrib"]
    assert canonical(ref["proof"]) == canonical(port["proof"])
    assert protocol_to_port(ref["proof"]).verify_with_committed_value(
        port["C1"], port["C2"], port["c"], port["ck"])
    assert to_ref(port["proof"]).verify_with_committed_value(
        ref["C1"], ref["C2"], ref["c"], ref["ck"])
    for P, w in ((REF, ref), (PORT, port)):
        assert not w["proof"].verify_with_committed_value(
            w["C2"], w["C1"], w["c"], w["ck"])


def _unknown_dlog_world(P, seed, equal=False):
    rng = random.Random(seed)
    F = P.b.Fr
    g, h = (P.b.G1.rand(rng).normalize() for _ in range(2))
    k = F.rand(rng)
    y = (g * int(k)).normalize()
    z = (h * int(k)).normalize() if equal else P.b.G1.rand(rng).normalize()
    prot = P.ineq.UnknownDiscreteLogInequalityProtocol.init(rng, k, g, h, y,
                                                            z)
    contrib, c = challenge_of(
        P, lambda w: prot.challenge_contribution(g, h, y, z, w))
    return dict(g=g, h=h, y=y, z=z, contrib=contrib, c=c,
                proof=prot.gen_proof(c))


def test_unknown_dlog_inequality_parity():
    ref, port = _unknown_dlog_world(REF, 45), _unknown_dlog_world(PORT, 45)
    assert ref["contrib"] == port["contrib"]
    assert canonical(ref["proof"]) == canonical(port["proof"])
    args = ("g", "h", "y", "z")
    assert protocol_to_port(ref["proof"]).verify(
        *(port[a] for a in args), port["c"])
    assert to_ref(port["proof"]).verify(*(ref[a] for a in args), ref["c"])
    for w in (ref, port):
        assert not w["proof"].verify(w["g"], w["h"], w["y"], w["h"], w["c"])
        assert not w["proof"].verify(*(w[a] for a in args),
                                     w["c"] + w["c"].f(1))
    for P in (REF, PORT):
        with pytest.raises(P.ineq.InequalityError):
            _unknown_dlog_world(P, 46, equal=True)
