"""The port's full Boneh-Boyen signatures (`short_group_sig/bb_sig.py`),
original VB accumulator proofs (`accumulator/proofs_original.py`), KB
positive accumulator (`accumulator/kb_positive.py`) and their composite
statements (`proof_system/statements_accum_original.py`) against the
reference's, mirroring the reference's `tests/test_accum_original_proof.py`
and `tests/test_accum_extra.py::test_kb_positive_accumulator`.

Each world is built in both packages from the same `random.Random`
seed: keys, signatures, protocols (R_E, the prover's GT commitment, as
canonical integers), the challenge contributions byte for byte and the
proofs.  The prover's and verifier's pairings go through the router
(`multi_pairings_routed`), on its host route here, and once through
`TPairing.multi_pairings` on the CPU's plain kernels: both equal the
reference's host values.  Each package's verifier accepts the other's
proof; tampering is refused.  A composite of a BBS+ credential, the
original membership and non-membership statements and a KB positive
membership, the user id linked across all four, is the same proof in
both packages, and each accepts the other's, the port's also with the
lazy checker that takes the original proofs' equations.
"""

import copy
import importlib
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.accumulator import proofs_original as tpo
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import tpairing
from crypto_tpu_torch.testing import cap_threads
from test_torch_proof_system import to_ref

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
MODULES = ("short_group_sig.bb_sig", "accumulator.proofs_original",
           "accumulator.kb_positive", "accumulator.setup", "accumulator.core",
           "accumulator.persistence", "serialize", "hashing",
           "bbs_plus.setup", "bbs_plus.signature", "proof_system.base",
           "proof_system.statements", "proof_system.statements_accum_original",
           "proof_system.proof")


def _pkg(root, b):
    ns = SimpleNamespace(name=root, b=b, port=root == "crypto_tpu_torch")
    for m in MODULES:
        name = {"accumulator.setup": "acc_setup",
                "bbs_plus.setup": "bbs_setup"}.get(m, m.split(".")[-1])
        setattr(ns, name, importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = _pkg("crypto_tpu", jb), _pkg("crypto_tpu_torch", tb)


@pytest.fixture
def routed(monkeypatch):
    """Every routed pairing call of the port's original proofs: (groups,
    pairs, route); the variable unset, so the router decides."""
    monkeypatch.delenv(ENV, raising=False)
    calls = []
    real = tpo.multi_pairings_routed

    def counted(groups, device="cuda"):
        groups = [list(g) for g in groups]
        n = sum(map(len, groups))
        calls.append((len(groups), n, tpairing.pairing_route(n,
                                                             len(groups))))
        return real(groups, device)

    monkeypatch.setattr(tpo, "multi_pairings_routed", counted)
    return calls


def _challenge(pkg, write):
    w = pkg.serialize.ByteWriter()
    write(w)
    return w.bytes(), pkg.hashing.compute_random_oracle_challenge(
        pkg.b.Fr, w.bytes())


def _dev(pkg):
    return {"device": "cpu"} if pkg.port else {}


# ---------------------------------------------------------------------------
# bb_sig
# ---------------------------------------------------------------------------

def _bb_world(pkg, seed=1817):
    rng = random.Random(seed)
    bb = pkg.bb_sig
    params = bb.BBSigParams.new(b"bb-params")
    sk = bb.BBSecretKey.generate(rng)
    pk = bb.BBPublicKey.generate(sk, params)
    m = pkg.b.Fr.rand(rng)
    sig = bb.BBSig.new(rng, m, sk, params)
    prot = bb.PoKBBSigProtocol.init(rng, sig, m, params)
    wb, c = _challenge(pkg, lambda w: prot.challenge_contribution(params, w))
    return SimpleNamespace(params=params, sk=sk, pk=pk, m=m, sig=sig,
                           prot=prot, wb=wb, c=c, proof=prot.gen_proof(c))


def test_bb_sig_and_pok():
    r, t = _bb_world(REF), _bb_world(PORT)
    for name in ("params", "sk", "pk", "m", "sig", "prot", "c", "proof"):
        assert canonical(getattr(r, name)) == canonical(getattr(t, name)), \
            name
    assert r.wb == t.wb
    assert t.sig.verify(t.m, t.pk, t.params)
    assert not t.sig.verify(t.m + tb.Fr(1), t.pk, t.params)
    assert t.proof.verify(t.c, t.pk, t.params)
    assert protocol_to_port(r.proof).verify(t.c, t.pk, t.params)
    assert to_ref(t.proof).verify(r.c, r.pk, r.params)
    assert t.proof.response_for_message() == t.proof.resp1.get_response(1)
    for pkg, w in ((PORT, t), (REF, r)):
        bad = copy.deepcopy(w.proof)
        bad.resp2.responses[0] = bad.resp2.responses[0] + pkg.b.Fr(1)
        assert not bad.verify(w.c, w.pk, w.params)
        bad = copy.deepcopy(w.proof)
        bad.A_r = (bad.A_r + w.params.g1).normalize()
        assert not bad.verify(w.c, w.pk, w.params)


# ---------------------------------------------------------------------------
# proofs_original (tests/test_accum_original_proof.py)
# ---------------------------------------------------------------------------

def _orig_world(pkg, seed=1818):
    rng = random.Random(seed)
    F, po = pkg.b.Fr, pkg.proofs_original
    params = pkg.acc_setup.AccumSetupParams.new(b"orig-accum")
    kp = pkg.acc_setup.AccumKeypair.generate(rng, params)
    prk = po.MembershipProvingKey.new(b"orig-prk")
    st = pkg.persistence.InMemoryState()
    acc = pkg.core.PositiveAccumulator.initialize(params)
    y = F.rand(rng)
    acc = acc.add(y, kp.secret_key, st)
    wit = acc.get_membership_witness(y, kp.secret_key, st)
    V = acc.value()
    prot = po.MembershipProofProtocol.init(rng, y, None, wit, V,
                                           kp.public_key, params, prk,
                                           **_dev(pkg))
    mb, mc = _challenge(pkg, lambda w: prot.challenge_contribution(
        V, kp.public_key, params, prk, w))
    mem = prot.gen_proof(mc)

    nprk = po.NonMembershipProvingKey.new(b"orig-nm-prk")
    ust = pkg.persistence.InMemoryState()
    uacc = pkg.core.UniversalAccumulator.initialize(
        rng, params, 10, kp.secret_key,
        pkg.persistence.InMemoryInitialElements())
    uacc = uacc.add_batch([F.rand(rng) for _ in range(4)], kp.secret_key,
                          ust)
    z = F.rand(rng)
    nwit = uacc.get_non_membership_witness(z, kp.secret_key, ust, params)
    U = uacc.value()
    nprot = po.NonMembershipProofProtocol.init(rng, z, None, nwit, U,
                                               kp.public_key, params, nprk,
                                               **_dev(pkg))
    nb, nc = _challenge(pkg, lambda w: nprot.challenge_contribution(
        U, kp.public_key, params, nprk, w))
    return SimpleNamespace(params=params, kp=kp, prk=prk, V=V, y=y, mb=mb,
                           mc=mc, mem=mem, mprot=prot, nprk=nprk, U=U, z=z,
                           nb=nb, nc=nc, non=nprot.gen_proof(nc),
                           nprot=nprot)


@pytest.fixture(scope="module")
def orig():
    return _orig_world(REF), _orig_world(PORT)


def test_original_proofs_match(orig):
    r, t = orig
    for name in ("kp", "prk", "V", "mc", "mem", "nprk", "U", "nc", "non"):
        assert canonical(getattr(r, name)) == canonical(getattr(t, name)), \
            name
    assert r.mb == t.mb and r.nb == t.nb
    assert canonical(t.mem.R_E) == canonical(r.mem.R_E)
    # the non-membership R_E: the membership's product times e(-r_v K,
    # P_tilde), one routed product in the port, two host ones in the
    # reference
    assert canonical(t.non.mem.R_E) == canonical(r.non.mem.R_E)


def test_prover_pairings_routed(routed):
    _orig_world(PORT, seed=1900)
    assert routed == [(1, 2, "host"), (1, 3, "host")]


def _verify(pkg, w, kind, proof, V=None, **kw):
    args = (w.V if V is None else V, w.mc) if kind == "mem" \
        else (w.U if V is None else V, w.nc)
    prk = w.prk if kind == "mem" else w.nprk
    return proof.verify(*args, w.kp.public_key, w.params, prk, **kw)


@pytest.mark.parametrize("kind", ["mem", "non"])
def test_original_proofs_cross_verify(orig, kind, routed):
    r, t = orig
    proof_t = getattr(t, kind)
    for proof in (proof_t, protocol_to_port(getattr(r, kind))):
        assert _verify(PORT, t, kind, proof, device="cpu")
    assert _verify(REF, r, kind, to_ref(proof_t))
    assert routed and all(route == "host" for *_, route in routed)
    w = tpo.MembershipProofOriginal if kind == "mem" \
        else tpo.NonMembershipProofOriginal
    assert isinstance(proof_t, w)
    assert proof_t.response_for_element() == (
        proof_t.s_y if kind == "mem" else proof_t.mem.s_y)


@pytest.mark.parametrize("spoil", ["mem_value", "mem_s_y", "non_value",
                                   "non_E_d"])
def test_original_proofs_tampered(orig, spoil):
    r, t = orig
    kind = spoil[:3]
    for pkg, w in ((PORT, t), (REF, r)):
        proof = copy.deepcopy(getattr(w, kind))
        V = None
        if spoil == "mem_value":
            V = (w.V * 3).normalize()
        elif spoil == "non_value":
            V = (w.U * 5).normalize()
        elif spoil == "mem_s_y":
            proof.s_y = proof.s_y + pkg.b.Fr(1)
        else:
            proof.E_d = (proof.E_d + w.params.P).normalize()
        assert not _verify(pkg, w, kind, proof, V, **_dev(pkg)), \
            (pkg.name, spoil)


def test_original_verify_on_plain_kernels(orig, monkeypatch):
    """The router's device route: the verifier's product through
    `TPairing.multi_pairings` on the CPU's plain kernels equals R_E."""
    r, t = orig
    monkeypatch.setenv(ENV, "device")
    calls = []
    real = tpairing.TPairing.multi_pairings

    def counted(self, groups):
        calls.append([len(g) for g in groups])
        return real(self, groups)

    monkeypatch.setattr(tpairing.TPairing, "multi_pairings", counted)
    assert _verify(PORT, t, "mem", t.mem, device="cpu")
    assert calls == [[2]]


def test_original_checker_deferral(orig, monkeypatch):
    """`verify_with_pairing_checker`: the equation, R_E its target, in a
    port checker on the CPU; accepted, and refused for another V."""
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    r, t = orig
    monkeypatch.setenv(ENV, "host")
    for kind, V in (("mem", t.V), ("non", t.U)):
        prk = t.prk if kind == "mem" else t.nprk
        c = t.mc if kind == "mem" else t.nc
        for value, want in ((V, True), ((V * 7).normalize(), False)):
            chk = RandomizedPairingChecker(tb.Fr(12345), lazy=True,
                                           device="cpu")
            ok = getattr(t, kind).verify_with_pairing_checker(
                value, c, t.kp.public_key, t.params, prk, chk)
            assert (ok and chk.verify()) == want, (kind, want)


# ---------------------------------------------------------------------------
# kb_positive (tests/test_accum_extra.py::test_kb_positive_accumulator)
# ---------------------------------------------------------------------------

def _kb_world(pkg, seed=1819):
    rng = random.Random(seed)
    kb = pkg.kb_positive
    F = pkg.b.Fr
    params = kb.KBPosSetupParams.new(b"kb-pos-test")
    sk = kb.KBPosSecretKey.generate(rng)
    pk = kb.KBPosPublicKey.generate(sk, params)
    state = pkg.persistence.InMemoryState()
    accum = kb.KBPositiveAccumulator.initialize(rng, params.accum.P)
    elems = [F.rand(rng) for _ in range(4)]
    wits = [accum.add(e, sk, params, state) for e in elems]
    prot = kb.KBPosMembershipProofProtocol.init(rng, elems[0], wits[0],
                                                accum.value, params)
    wb, c = _challenge(pkg, lambda w: prot.challenge_contribution(
        accum.value, params, w))
    accum2 = accum.remove(elems[3], sk, state)
    removed_r = kb.bb_sig_prf(elems[3], sk.sig)
    return SimpleNamespace(params=params, sk=sk, pk=pk, accum=accum,
                           elems=elems, wits=wits, wb=wb, c=c,
                           proof=prot.gen_proof(c), accum2=accum2,
                           w0=wits[0].update_after_removal(removed_r,
                                                           accum2.value),
                           state=state, rng=rng)


def test_kb_positive(routed):
    r, t = _kb_world(REF), _kb_world(PORT)
    for name in ("params", "sk", "pk", "accum", "elems", "wits", "c",
                 "proof", "accum2", "w0"):
        assert canonical(getattr(r, name)) == canonical(getattr(t, name)), \
            name
    assert r.wb == t.wb
    kb = PORT.kb_positive
    for e, w in zip(t.elems, t.wits):
        assert t.accum.verify_membership(e, w, t.pk, t.params, device="cpu")
    assert not t.accum.verify_membership(tb.Fr(5), t.wits[0], t.pk, t.params,
                                         device="cpu")
    assert t.accum2.verify_membership(t.elems[0], t.w0, t.pk, t.params,
                                      device="cpu")
    assert not t.accum2.verify_membership(t.elems[0], t.wits[0], t.pk,
                                          t.params, device="cpu")
    assert t.proof.verify(t.accum.value, t.c, t.pk, t.params)
    assert not t.proof.verify((t.accum.value * 3).normalize(), t.c, t.pk,
                              t.params)
    assert to_ref(t.proof).verify(r.accum.value, r.c, r.pk, r.params)
    assert protocol_to_port(r.proof).verify(t.accum.value, t.c, t.pk,
                                            t.params)
    assert kb.bb_sig_prf(t.elems[0], t.sk.sig) == t.wits[0].signature.r


# ---------------------------------------------------------------------------
# a composite over statements_accum_original
# ---------------------------------------------------------------------------

def _composite_world(pkg, seed=1820):
    rng = random.Random(seed)
    F, po, kb = pkg.b.Fr, pkg.proofs_original, pkg.kb_positive
    sig_params = pkg.bbs_setup.SignatureParamsG1.new(b"issuer-params", 5)
    issuer = pkg.bbs_setup.KeypairG2.generate(rng, sig_params)
    messages = [F.rand(rng) for _ in range(5)]
    uid = messages[2]
    sig = pkg.signature.SignatureG1.new(rng, messages, issuer.secret_key,
                                        sig_params)
    params = pkg.acc_setup.AccumSetupParams.new(b"orig-accum")
    kp = pkg.acc_setup.AccumKeypair.generate(rng, params)
    st = pkg.persistence.InMemoryState()
    acc = pkg.core.PositiveAccumulator.initialize(params).add_batch(
        [uid, F.rand(rng)], kp.secret_key, st)
    mwit = acc.get_membership_witness(uid, kp.secret_key, st)
    ust = pkg.persistence.InMemoryState()
    uacc = pkg.core.UniversalAccumulator.initialize(
        rng, params, 8, kp.secret_key,
        pkg.persistence.InMemoryInitialElements()).add_batch(
        [F.rand(rng) for _ in range(2)], kp.secret_key, ust)
    nwit = uacc.get_non_membership_witness(uid, kp.secret_key, ust, params)
    kparams = kb.KBPosSetupParams.new(b"kb-pos")
    ksk = kb.KBPosSecretKey.generate(rng)
    kpk = kb.KBPosPublicKey.generate(ksk, kparams)
    kacc = kb.KBPositiveAccumulator.initialize(rng, kparams.accum.P)
    kwit = kacc.add(uid, ksk, kparams, pkg.persistence.InMemoryState())

    S, O = pkg.statements, pkg.statements_accum_original
    spec = pkg.base.ProofSpec(context=b"orig-composite")
    s0 = spec.add_statement(S.PoKBBSSignatureG1(
        params=sig_params, public_key=issuer.public_key,
        revealed_messages={0: messages[0]}))
    s1 = spec.add_statement(O.VBAccumulatorMembership(
        accumulator_value=acc.value(), params=params,
        public_key=kp.public_key,
        proving_key=po.MembershipProvingKey.new(b"orig-prk")))
    s2 = spec.add_statement(O.VBAccumulatorNonMembership(
        accumulator_value=uacc.value(), params=params,
        public_key=kp.public_key,
        proving_key=po.NonMembershipProvingKey.new(b"orig-nm-prk")))
    s3 = spec.add_statement(O.KBPositiveAccumulatorMembership(
        accumulator_value=kacc.value, params=kparams, public_key=kpk))
    spec.add_witness_equality([(s0, 2), (s1, 0), (s2, 0), (s3, 0)])
    wits = [S.BBSWitness(signature=sig, messages=messages),
            S.AccumMembershipWit(element=uid, witness=mwit),
            S.AccumNonMembershipWit(element=uid, witness=nwit),
            O.KBPosAccumWitness(element=uid, witness=kwit)]
    proof = pkg.proof.Proof.new(rng, spec, wits, nonce=b"orig",
                                **_dev(pkg))
    return SimpleNamespace(spec=spec, wits=wits, proof=proof)


@pytest.fixture(scope="module")
def composite():
    mp = pytest.MonkeyPatch()
    mp.setenv(ENV, "host")
    try:
        return _composite_world(REF), _composite_world(PORT)
    finally:
        mp.undo()


def test_composite_original_equal(composite):
    r, t = composite
    assert canonical(protocol_to_port(r.spec)) == canonical(t.spec)
    assert canonical(t.proof) == canonical(r.proof)


@pytest.mark.parametrize("mode", ["none", "lazy"])
def test_composite_original_cross_verify(composite, mode, monkeypatch):
    r, t = composite
    monkeypatch.setenv(ENV, "host")

    def cfg(pkg):
        return None if mode == "none" else pkg.proof.VerifierConfig(True)

    assert t.proof.verify(random.Random(1), t.spec, nonce=b"orig",
                          config=cfg(PORT), device="cpu")
    assert to_ref(t.proof).verify(random.Random(1), r.spec, nonce=b"orig",
                                  config=cfg(REF))
    bad = copy.deepcopy(t.proof)
    bad.statement_proofs[1].s_sigma = bad.statement_proofs[1].s_sigma \
        + tb.Fr(1)
    with pytest.raises(PORT.base.ProofSystemError, match="original"):
        bad.verify(random.Random(1), t.spec, nonce=b"orig",
                   config=cfg(PORT), device="cpu")
