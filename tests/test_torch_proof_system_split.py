"""The port's `proof_system/statements_split.py` (prover- and verifier-side
statements, G2 Pedersen, the BBS23-IETF statements, `VeTZ21` and
`VeTZ21Robust`) against the reference's, in one composite split across a
prover's spec and a verifier's spec, on the reference's
`tests/test_statements_new.py` shapes.

The composite: a BBS+ credential (4 messages, 1 revealed), a BBS23
credential under the IETF statement, VB membership (CDH) and KB universal
non-membership (CDH), a G2 Pedersen commitment, `VeTZ21` at N = 4 and
tau = 2 over two hidden BBS+ messages and `VeTZ21Robust` at 8 parties, 5
revealed, over one, all tied by witness equalities.  Both packages prove
from the same `random.Random` seed (the reference's `os.urandom` patched
to draw from that rng, as the port's DKGitH does), and the proofs are
equal as canonical integers, so the challenges are; each package accepts
the other's proof under its verifier spec with no checker and the eager
checker; the lazy checker's 8 deferred pairs go through `TPairing`'s
plain kernels in one Miller product; the auditor decrypts the TZ21
proofs to the BBS+ messages.  Refused by both: a prover-side statement
asked to verify, a wrong nonce, a broken witness equality.  The
parameter guard: a DKGitH proof at (N, tau) = (2, 1) and an RDkgith
proof at another threshold are accepted by the reference under a (16,
32) and a (16, 12) statement, and refused by the port.
"""

import importlib
import os
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads
from test_torch_commitment_inequality import to_ref

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
NONCE = b"split"


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("bbs", "bbs_plus.setup"), ("sig", "bbs_plus.signature"),
        ("b23", "bbs_plus.bbs23"), ("acc", "accumulator.setup"),
        ("core", "accumulator.core"), ("kb", "accumulator.kb_universal"),
        ("pers", "accumulator.persistence"), ("base", "proof_system.base"),
        ("st", "proof_system.statements"),
        ("more", "proof_system.statements_more"),
        ("split", "proof_system.statements_split"),
        ("proof", "proof_system.proof"), ("eg", "utils.elgamal"),
        ("hashing", "hashing"), ("msm", "utils.msm"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def world(P, seed=1919):
    rng = random.Random(seed)
    F = P.b.Fr
    w = SimpleNamespace(P=P)
    uid, a, b = F.rand(rng), F.rand(rng), F.rand(rng)
    w.bbs_params = P.bbs.SignatureParamsG1.new(b"split-bbs", 4)
    w.bbs_kp = P.bbs.KeypairG2.generate(rng, w.bbs_params)
    w.bbs_msgs = [F.rand(rng), uid, a, b]
    w.bbs_sig = P.sig.SignatureG1.new(rng, w.bbs_msgs, w.bbs_kp.secret_key,
                                      w.bbs_params)
    w.b23_params = P.b23.SignatureParams23G1.new(b"split-ietf", 3)
    b23_sk = P.bbs.SecretKey.generate(rng)
    w.b23_pk = P.b23.PublicKey23G2.generate(b23_sk, w.b23_params)
    w.b23_msgs = [uid, F.rand(rng), F.rand(rng)]
    w.b23_sig = P.b23.Signature23G1.new(rng, w.b23_msgs, b23_sk,
                                        w.b23_params)
    w.acc_params = P.acc.AccumSetupParams.new(b"split-acc")
    w.acc_kp = P.acc.AccumKeypair.generate(rng, w.acc_params)
    st = P.pers.InMemoryState()
    vb = P.core.PositiveAccumulator.initialize(w.acc_params)
    w.vb = vb.add(uid, w.acc_kp.secret_key, st)
    w.vb_wit = w.vb.get_membership_witness(uid, w.acc_kp.secret_key, st)
    w.domain = [F.rand(rng) for _ in range(4)]
    ms, nms = P.pers.InMemoryState(), P.pers.InMemoryState()
    kb = P.kb.KBUniversalAccumulator.initialize(
        w.acc_params, w.acc_kp.secret_key, w.domain, ms, nms)
    w.kb = kb.add(w.domain[0], w.acc_kp.secret_key, ms, nms)
    w.nm_wit = w.kb.get_non_membership_witness(w.domain[2],
                                               w.acc_kp.secret_key, nms)
    w.g2_bases = [P.b.G2.rand(rng).normalize() for _ in range(2)]
    w.g2_wits = [F.rand(rng), F.rand(rng)]
    w.g2_comm = P.msm.msm(w.g2_bases, w.g2_wits).normalize()
    w.enc_gen = P.b.G1.generator()
    w.dec_sk, w.enc_pk = P.eg.keygen(rng, w.enc_gen)
    w.ck = [p.normalize() for p in
            P.hashing.n_group_elements(P.b.G1, 0, 3, b"split-ve-ck")]
    return w


def build(w, side, ve=(4, 2), rob=(8, 5), broken=False):
    """(spec, witnesses): `side` "prover" or "verifier"; `broken` proves a
    VeTZ21 witness other than the BBS+ message it is tied to."""
    P, st, split = w.P, w.P.st, w.P.split
    spec = P.base.ProofSpec(context=b"split-composite")
    rev = {0: w.bbs_msgs[0]}
    b23_rev = {1: w.b23_msgs[1]}
    if side == "prover":
        stmts = [
            split.PoKBBSSignatureG1Prover(w.bbs_params, revealed_messages=rev),
            split.PoKBBSSignature23IETFG1Prover(w.b23_params,
                                                revealed_messages=b23_rev),
            split.VBAccumulatorMembershipCDHProver(w.vb.value(),
                                                   w.acc_params),
            split.KBUniversalAccumulatorNonMembershipCDHProver(
                w.kb.non_mem.value(), w.acc_params)]
    else:
        stmts = [
            split.PoKBBSSignatureG1Verifier(w.bbs_params,
                                            w.bbs_kp.public_key, rev),
            split.PoKBBSSignature23IETFG1Verifier(w.b23_params, w.b23_pk,
                                                  b23_rev),
            split.VBAccumulatorMembershipCDHVerifier(
                w.vb.value(), w.acc_params, w.acc_kp.public_key),
            split.KBUniversalAccumulatorNonMembershipCDHVerifier(
                w.kb.non_mem.value(), w.acc_params, w.acc_kp.public_key)]
    stmts += [
        split.PedersenCommitmentG2(w.g2_bases, w.g2_comm),
        split.VeTZ21(comm_key=w.ck, enc_pk=w.enc_pk, enc_gen=w.enc_gen,
                     n_parties=ve[0], reps=ve[1]),
        split.VeTZ21Robust(comm_key=w.ck, enc_pk=w.enc_pk,
                           enc_gen=w.enc_gen, n_parties=rob[0],
                           reps=rob[1])]
    for s in stmts:
        spec.add_statement(s)
    spec.add_witness_equality([(0, 1), (1, 0), (2, 0)])
    spec.add_witness_equality([(0, 2), (5, 0), (6, 0)])
    spec.add_witness_equality([(0, 3), (5, 1)])
    F = P.b.Fr
    ve_wits = [w.bbs_msgs[2], w.bbs_msgs[3] + F(1) if broken
               else w.bbs_msgs[3]]
    wits = [st.BBSWitness(w.bbs_sig, w.bbs_msgs),
            P.more.BBS23Witness(w.b23_sig, w.b23_msgs),
            st.AccumMembershipWit(element=w.bbs_msgs[1], witness=w.vb_wit),
            st.AccumMembershipWit(element=w.domain[2], witness=w.nm_wit),
            list(w.g2_wits), ve_wits, [w.bbs_msgs[2]]]
    return spec, wits


def prove(w, spec, wits, seed):
    rng = random.Random(seed)
    if w.P is REF:
        # the reference's DKGitH draws from os.urandom; hand it the bytes
        # the port's draws from its rng at the same point
        mp = pytest.MonkeyPatch()
        mp.setattr(os, "urandom", rng.randbytes)
        try:
            return w.P.proof.Proof.new(rng, spec, wits, nonce=NONCE)
        finally:
            mp.undo()
    return w.P.proof.Proof.new(rng, spec, wits, nonce=NONCE, **w.P.kw)


def verify(P, proof, spec, mode, nonce=NONCE):
    cfg = None if mode == "none" else P.proof.VerifierConfig(mode == "lazy")
    return proof.verify(random.Random(9), spec, nonce=nonce, config=cfg,
                        **P.kw)


@pytest.fixture(scope="module")
def worlds():
    out = []
    for P in (REF, PORT):
        w = world(P)
        w.prover_spec, w.wits = build(w, "prover")
        w.verifier_spec, _ = build(w, "verifier")
        w.proof = prove(w, w.prover_spec, w.wits, 31)
        out.append(w)
    return tuple(out)


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


def test_specs_carried_and_proofs_equal(worlds):
    r, t = worlds
    for side in ("prover_spec", "verifier_spec"):
        assert canonical(protocol_to_port(getattr(r, side))) == \
            canonical(getattr(t, side))
    assert canonical(protocol_to_port(r.wits)) == canonical(t.wits)
    assert canonical(t.proof) == canonical(r.proof)
    assert canonical(protocol_to_port(r.proof)) == canonical(t.proof)
    ve = t.proof.statement_proofs[5].ve_proof
    assert (ve.n_parties, ve.reps, len(ve.deltas)) == (4, 2, 2)


@pytest.mark.parametrize("mode", ["none", "eager"])
def test_cross_verify(worlds, mode):
    r, t = worlds
    assert verify(PORT, t.proof, t.verifier_spec, mode)
    assert verify(PORT, protocol_to_port(r.proof), t.verifier_spec, mode)
    assert verify(REF, to_ref(t.proof), r.verifier_spec, mode)


def test_lazy_checker_through_plain_kernels(worlds, monkeypatch):
    """BBS+, BBS23-IETF and the two CDH statements defer 2 pairs each: one
    `TPairing.miller_product` of 8 pairs on the CPU's plain kernels."""
    from crypto_tpu_torch.curves import tpairing
    t = worlds[1]
    calls = []
    real = tpairing.TPairing.miller_product

    def counted(self, pairs):
        calls.append(len(pairs))
        return real(self, pairs)

    monkeypatch.setattr(tpairing.TPairing, "miller_product", counted)
    monkeypatch.setenv(ENV, "device")
    assert verify(PORT, t.proof, t.verifier_spec, "lazy")
    assert calls == [8]


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_rejections(worlds, P):
    w = worlds[0] if P is REF else worlds[1]
    with pytest.raises(P.base.ProofSystemError, match="prover-side"):
        verify(P, w.proof, w.prover_spec, "none")
    with pytest.raises(P.base.ProofSystemError):
        verify(P, w.proof, w.verifier_spec, "none", nonce=b"other")
    spec, wits = build(w, "prover", broken=True)
    bad = prove(w, spec, wits, 32)
    with pytest.raises(P.base.ProofSystemError, match="equality"):
        verify(P, bad, w.verifier_spec, "none")


def test_auditor_decrypts(worlds):
    t = worlds[1]
    sps = t.proof.statement_proofs
    ve, rob = sps[5], sps[6]
    ck = t.ck[:3]
    got = ve.ve_proof.compress(subset_size=1).decrypt(t.dec_sk,
                                                      ve.commitment, ck)
    assert got[:2] == t.bbs_msgs[2:4]
    got = rob.ve_proof.compress().decrypt(t.dec_sk, rob.commitment, ck[:2])
    assert got[0] == t.bbs_msgs[2]


def guard_proof(w, variant, params):
    """A composite of the one TZ21 statement `variant` at `params`."""
    split = w.P.split
    cls = split.VeTZ21 if variant == "dkgith" else split.VeTZ21Robust
    spec = w.P.base.ProofSpec(context=b"guard")
    spec.add_statement(cls(comm_key=w.ck, enc_pk=w.enc_pk,
                           enc_gen=w.enc_gen, n_parties=params[0],
                           reps=params[1]))
    return spec


@pytest.mark.parametrize("variant, weak, strong", [
    ("dkgith", (2, 1), (16, 32)), ("rdkgith", (4, 1), (16, 12))])
def test_parameter_guard(worlds, variant, weak, strong):
    """The reference's verifier takes the soundness parameters from the
    proof: a proof at the weak parameters passes under the strong
    statement there.  The port's refuses it, and accepts it under the
    statement it was made for."""
    r, t = worlds
    proofs = []
    for P, w in ((REF, r), (PORT, t)):
        spec = guard_proof(w, variant, weak)
        proofs.append(prove(w, spec, [[w.bbs_msgs[2]]], 33))
        assert verify(P, proofs[-1], spec, "none")
    ref_proof, port_proof = proofs
    assert canonical(port_proof) == canonical(ref_proof)
    assert verify(REF, ref_proof, guard_proof(r, variant, strong), "none")
    with pytest.raises(PORT.base.ProofSystemError, match="parameters"):
        verify(PORT, port_proof, guard_proof(t, variant, strong), "none")
    with pytest.raises(PORT.base.ProofSystemError, match="parameters"):
        verify(PORT, protocol_to_port(ref_proof),
               guard_proof(t, variant, strong), "none")
