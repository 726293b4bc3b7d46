"""The port's composite proof system (`crypto_tpu_torch/proof_system/`:
`base`, `derived_params`, `statements`, `proof`) against the reference's
(`crypto_tpu/proof_system/`), on the world of the reference's
`tests/test_proof_system.py`: a BBS+ credential over 5 messages, a
2-element positive accumulator holding the user id, and a Pedersen
commitment to it, the user id linked by a witness equality across the
three statements; and the same with non-membership of the user id in a
universal accumulator.

Each world is built in both packages from the same `random.Random`
seed, and the reference's spec and witnesses carried across
(`convert.protocol_to_port`) equal the port's.  `Proof.new` gives the
same statement proofs in both (canonical integers and bytes), each
package's `verify` accepts the other's proof with no checker and with
the lazy and eager `RandomizedPairingChecker` (the port's on the CPU;
once through `TPairing`'s plain kernels), and a wrong nonce, a violated
equality, a forged commitment and a revealed-message mismatch are
rejected, as in the reference's tests.
"""

import dataclasses
import importlib
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import (canonical, carry_fp12, carry_point,
                                      protocol_to_port)
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
MODULES = ("bbs_plus.setup", "bbs_plus.signature", "accumulator.setup",
           "accumulator.core", "accumulator.persistence", "utils.msm",
           "proof_system.base", "proof_system.statements",
           "proof_system.proof")


def _pkg(root, b):
    """The modules of `root` by the last part of their names (the
    accumulator's `setup` as `acc_setup`)."""
    ns = SimpleNamespace(name=root, b=b)
    for m in MODULES:
        name = "acc_setup" if m == "accumulator.setup" else m.split(".")[-1]
        setattr(ns, name, importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = _pkg("crypto_tpu", jb), _pkg("crypto_tpu_torch", tb)


def to_ref(obj):
    """A port object as the reference's: dataclasses by the class of the
    same name in the reference's module of the same name, points, GT and
    field elements by value, containers (sets and dicts too) item by
    item."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = importlib.import_module(
            "crypto_tpu." + type(obj).__module__[len("crypto_tpu_torch."):])
        return getattr(mod, type(obj).__name__)(**{
            f.name: to_ref(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if hasattr(obj, "curve") and hasattr(obj, "Z"):
        return carry_point(obj, jb.G2 if hasattr(obj.X, "c0") else jb.G1)
    if hasattr(obj, "c1") and hasattr(getattr(obj, "c0", None), "c2"):
        return carry_fp12(obj, jb.Fq12)
    if hasattr(obj, "f") and hasattr(obj, "v"):
        return (jb.Fr if obj.f.p == jb.R else jb.Fq)(int(obj))
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(to_ref(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_ref(v) for k, v in obj.items()}
    return obj


def verify(pkg, proof, spec, nonce, mode, seed=9):
    """`proof.verify` of `pkg` with no checker ("none") or the lazy or
    eager checker; the port's on the CPU."""
    cfg = None if mode == "none" else pkg.proof.VerifierConfig(mode == "lazy")
    kw = {"device": "cpu"} if pkg is PORT else {}
    return proof.verify(random.Random(seed), spec, nonce=nonce, config=cfg,
                        **kw)


def prove(pkg, spec, wits, nonce, seed):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg.proof.Proof.new(random.Random(seed), spec, wits, nonce=nonce,
                               **kw)


# ---------------------------------------------------------------------------
# the world of tests/test_proof_system.py
# ---------------------------------------------------------------------------

def build_world(pkg, seed=77, universal=False):
    rng = random.Random(seed)
    F = pkg.b.Fr
    n_msgs = 5
    sig_params = pkg.setup.SignatureParamsG1.new(b"issuer-params", n_msgs)
    issuer = pkg.setup.KeypairG2.generate(rng, sig_params)
    messages = [F.rand(rng) for _ in range(n_msgs)]
    user_id = messages[2]
    signature = pkg.signature.SignatureG1.new(rng, messages,
                                              issuer.secret_key, sig_params)
    accum_params = pkg.acc_setup.AccumSetupParams.new(b"accum-params")
    accum_kp = pkg.acc_setup.AccumKeypair.generate(rng, accum_params)
    state = pkg.persistence.InMemoryState()
    if universal:
        accum = pkg.core.UniversalAccumulator.initialize(
            rng, accum_params, 8, accum_kp.secret_key,
            pkg.persistence.InMemoryInitialElements())
        accum = accum.add_batch([F.rand(rng), F.rand(rng)],
                                accum_kp.secret_key, state)
        wit = accum.get_non_membership_witness(
            user_id, accum_kp.secret_key, state, accum_params)
        Q = pkg.b.G1.rand(rng).normalize()
    else:
        accum = pkg.core.PositiveAccumulator.initialize(accum_params)
        accum = accum.add_batch([user_id, F.rand(rng)], accum_kp.secret_key,
                                state)
        wit = accum.get_membership_witness(user_id, accum_kp.secret_key,
                                           state)
        Q = None
    bases = [pkg.b.G1.rand(rng).normalize() for _ in range(2)]
    blinding = F.rand(rng)
    commitment = pkg.msm.msm(bases, [user_id, blinding]).normalize()
    return SimpleNamespace(
        pkg=pkg, sig_params=sig_params, issuer=issuer, messages=messages,
        user_id=user_id, signature=signature, accum_params=accum_params,
        accum_kp=accum_kp, accum=accum, wit=wit, Q=Q, bases=bases,
        blinding=blinding, commitment=commitment, universal=universal)


def build_spec(w, revealed_ids=(0,), revealed=None):
    st = w.pkg.statements
    spec = w.pkg.base.ProofSpec(context=b"test-context")
    if revealed is None:
        revealed = {i: w.messages[i] for i in revealed_ids}
    s0 = spec.add_statement(st.PoKBBSSignatureG1(
        params=w.sig_params, public_key=w.issuer.public_key,
        revealed_messages=revealed))
    if w.universal:
        s1 = spec.add_statement(st.VBAccumulatorNonMembershipCDH(
            accumulator_value=w.accum.value(), params=w.accum_params,
            public_key=w.accum_kp.public_key, Q=w.Q))
    else:
        s1 = spec.add_statement(st.VBAccumulatorMembershipCDH(
            accumulator_value=w.accum.value(), params=w.accum_params,
            public_key=w.accum_kp.public_key))
    s2 = spec.add_statement(st.PedersenCommitmentStmt(
        bases=w.bases, commitment=w.commitment))
    # user_id: message 2 of the signature == accumulator element == opening 0
    spec.add_witness_equality([(s0, 2), (s1, 0), (s2, 0)])
    return spec


def witnesses(w, user_id=None, element=None, wit=None):
    st = w.pkg.statements
    user_id = w.user_id if user_id is None else user_id
    acc = (st.AccumNonMembershipWit if w.universal
           else st.AccumMembershipWit)(
        element=w.user_id if element is None else element,
        witness=w.wit if wit is None else wit)
    return [st.BBSWitness(signature=w.signature, messages=w.messages), acc,
            [user_id, w.blinding]]


@pytest.fixture(scope="module", params=["membership", "non_membership"])
def worlds(request):
    universal = request.param == "non_membership"
    r, t = build_world(REF, universal=universal), \
        build_world(PORT, universal=universal)
    spec_r, spec_t = build_spec(r), build_spec(t)
    proof_r = prove(REF, spec_r, witnesses(r), b"nonce-1", 5)
    proof_t = prove(PORT, spec_t, witnesses(t), b"nonce-1", 5)
    return SimpleNamespace(r=r, t=t, spec_r=spec_r, spec_t=spec_t,
                           proof_r=proof_r, proof_t=proof_t)


def test_spec_and_witnesses_carried_across(worlds):
    W = worlds
    carried = protocol_to_port(W.spec_r)
    assert type(carried) is PORT.base.ProofSpec
    assert canonical(carried) == canonical(W.spec_t)
    assert canonical(protocol_to_port(witnesses(W.r))) == \
        canonical(witnesses(W.t))
    classes = carried.meta_statements.disjoint_witness_equalities()
    assert classes == [{PORT.base.WitnessRef(0, 2), PORT.base.WitnessRef(1, 0),
                        PORT.base.WitnessRef(2, 0)}]


def test_statement_proofs_equal(worlds):
    W = worlds
    assert canonical(W.proof_t) == canonical(W.proof_r)
    assert canonical(protocol_to_port(W.proof_r)) == canonical(W.proof_t)
    # the carried spec and witnesses prove the same proof in the port
    again = prove(PORT, protocol_to_port(W.spec_r),
                  protocol_to_port(witnesses(W.r)), b"nonce-1", 5)
    assert canonical(again) == canonical(W.proof_t)


@pytest.mark.parametrize("mode", ["none", "lazy", "eager"])
def test_cross_verify(worlds, mode, monkeypatch):
    W = worlds
    monkeypatch.setenv(ENV, "host")
    assert verify(PORT, W.proof_t, W.spec_t, b"nonce-1", mode)
    assert verify(PORT, protocol_to_port(W.proof_r),
                  protocol_to_port(W.spec_r), b"nonce-1", mode)
    assert verify(REF, to_ref(W.proof_t), W.spec_r, b"nonce-1", mode)
    assert verify(REF, W.proof_r, W.spec_r, b"nonce-1", mode)


def test_lazy_checker_through_plain_kernels(monkeypatch):
    """The lazy checker's deferred pairs (BBS+ and the accumulator, four)
    through `TPairing.miller_product` on the CPU's plain kernels."""
    from crypto_tpu_torch.curves import tpairing
    w = build_world(PORT)
    spec = build_spec(w)
    proof = prove(PORT, spec, witnesses(w), b"nonce-1", 5)
    calls = []
    real = tpairing.TPairing.miller_product

    def counted(self, pairs):
        calls.append(len(pairs))
        return real(self, pairs)

    monkeypatch.setattr(tpairing.TPairing, "miller_product", counted)
    monkeypatch.setenv(ENV, "device")
    assert verify(PORT, proof, spec, b"nonce-1", "lazy")
    assert calls == [4]
    bad = prove(PORT, spec, witnesses(w), b"nonce-1", 6)
    bad.statement_proofs[1].inner.A_bar = (
        bad.statement_proofs[1].inner.A_bar + tb.G1.generator()).normalize()
    with pytest.raises(PORT.base.ProofSystemError):
        verify(PORT, bad, spec, b"nonce-1", "lazy")


# ---------------------------------------------------------------------------
# rejections, as in tests/test_proof_system.py, in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    return build_world(REF), build_world(PORT)


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


@pytest.mark.parametrize("pkg_name", ["reference", "port"])
def test_wrong_nonce(both, pkg_name):
    w = both[pkg_name == "port"]
    spec = build_spec(w)
    proof = prove(w.pkg, spec, witnesses(w), b"nonce-1", 11)
    with pytest.raises(w.pkg.base.ProofSystemError):
        verify(w.pkg, proof, spec, b"other-nonce", "none")


@pytest.mark.parametrize("pkg_name", ["reference", "port"])
def test_witness_equality_enforced(both, pkg_name):
    """A different element in the accumulator statement fails the
    equality meta-statement."""
    w0 = both[pkg_name == "port"]
    pkg = w0.pkg
    rng = random.Random(12)
    kp = w0.accum_kp
    state = pkg.persistence.InMemoryState()
    other = pkg.b.Fr.rand(rng)
    accum = pkg.core.PositiveAccumulator.initialize(w0.accum_params)
    accum = accum.add(other, kp.secret_key, state)
    w = SimpleNamespace(**vars(w0))
    w.accum = accum
    wits = witnesses(w, element=other, wit=accum.get_membership_witness(
        other, kp.secret_key, state))
    spec = build_spec(w)
    proof = prove(pkg, spec, wits, b"n", 13)
    with pytest.raises(pkg.base.ProofSystemError, match="equality"):
        verify(pkg, proof, spec, b"n", "none")
    if pkg is PORT:
        ref_spec = build_spec(SimpleNamespace(**{**vars(both[0]),
                                                 "accum": to_ref(accum)}))
        with pytest.raises(REF.base.ProofSystemError, match="equality"):
            verify(REF, to_ref(proof), ref_spec, b"n", "none")


@pytest.mark.parametrize("pkg_name", ["reference", "port"])
def test_forged_commitment_fails(both, pkg_name):
    w = both[pkg_name == "port"]
    spec = build_spec(w)
    wits = witnesses(w, user_id=w.user_id + w.pkg.b.Fr(1))
    proof = prove(w.pkg, spec, wits, b"n", 14)
    with pytest.raises(w.pkg.base.ProofSystemError):
        verify(w.pkg, proof, spec, b"n", "none")


@pytest.mark.parametrize("pkg_name", ["reference", "port"])
def test_revealed_message_mismatch(both, pkg_name):
    w = both[pkg_name == "port"]
    spec = build_spec(w, revealed_ids=(0, 1))
    proof = prove(w.pkg, spec, witnesses(w), b"n", 15)
    assert verify(w.pkg, proof, spec, b"n", "none")
    spec2 = build_spec(w, revealed={0: w.messages[0],
                                    1: w.messages[1] + w.pkg.b.Fr(1)})
    for mode in ("none", "lazy"):
        with pytest.raises(w.pkg.base.ProofSystemError):
            verify(w.pkg, proof, spec2, b"n", mode)


def test_spec_validation_and_setup_params():
    """`validate`'s refusals and `SetupParamsRef` resolution in the port,
    as in the reference."""
    base = PORT.base
    spec = base.ProofSpec()
    spec.add_statement(PORT.statements.PedersenCommitmentStmt(
        bases=[tb.G1.generator()], commitment=tb.G1.generator()))
    spec.add_witness_equality([(0, 0)])
    with pytest.raises(base.ProofSystemError, match="at least 2"):
        spec.validate()
    spec.meta_statements.equalities.clear()
    spec.add_witness_equality([(0, 0), (3, 0)])
    with pytest.raises(base.ProofSystemError, match="out of bounds"):
        spec.validate()
    spec.meta_statements.equalities.clear()
    spec.aggregate_groth16 = [[0]]
    with pytest.raises(base.ProofSystemError, match="SRS"):
        spec.validate()
    ref = spec.add_setup_params([tb.G1.generator().double()])
    stmt = PORT.statements.PedersenCommitmentStmt(
        bases=ref, commitment=tb.G1.generator())
    out = base.resolve_setup_params(stmt, spec.setup_params)
    assert out.bases == [tb.G1.generator().double()] and stmt.bases is ref
    with pytest.raises(base.ProofSystemError, match="out of bounds"):
        base.resolve_setup_params(PORT.statements.PedersenCommitmentStmt(
            bases=base.SetupParamsRef(5), commitment=None), spec.setup_params)
    resolved = spec.resolved_statements("cpu")
    assert resolved[0] is not spec.statements[0]
    assert resolved[0].device == "cpu" and spec.statements[0].device == "cuda"
