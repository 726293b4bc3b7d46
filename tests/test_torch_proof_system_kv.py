"""The port's keyed-verification and detached accumulator statements
(`crypto_tpu_torch/proof_system/statements_kv.py`) and its ECIES
(`utils/ecies.py`) against the reference's, on the shapes of the
reference's `tests/test_proof_system_kv.py` (a 3-element positive
accumulator, a 6-element KB domain, a 10-element universal accumulator).

Each spec is built in both packages from the same `random.Random` seed:
VB keyed-verification membership linked to a Pedersen commitment; the
KB universal KV membership and non-membership statements; the detached
membership and non-membership provers (the randomizer and the ECIES
ephemeral key drawn in the reference's order); a BBDT16 MAC under its
full verifier with an SMC-KV bound check.  The carried specs equal the
port's, the statement proofs are equal (canonical integers and the
ECIES bytes), each package's verifier accepts the other's proof (the
plain, full and detached verifiers), and the rejections of the
reference's tests hold in both: another accumulator key for the full
and the detached verifier, another MAC key, an out-of-range value.
"""

import importlib
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


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("acc", "accumulator.setup"), ("core", "accumulator.core"),
        ("kb", "accumulator.kb_universal"),
        ("pers", "accumulator.persistence"), ("base", "proof_system.base"),
        ("st", "proof_system.statements"),
        ("kv", "proof_system.statements_kv"),
        ("more", "proof_system.statements_more"),
        ("ranges", "proof_system.statements_ranges"),
        ("smc_kv", "smc_range_proof.kv"), ("ccs", "smc_range_proof.ccs"),
        ("mac", "kvac.bbdt16"), ("proof", "proof_system.proof"),
        ("msm", "utils.msm"), ("ecies", "utils.ecies"),
        ("hashing", "hashing"), ("serialize", "serialize"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def world(P, seed=4242):
    rng = random.Random(seed)
    F = P.b.Fr
    w = SimpleNamespace(P=P)
    w.params = P.acc.AccumSetupParams.new(b"kv-accum")
    w.kp = P.acc.AccumKeypair.generate(rng, w.params)
    sk = w.kp.secret_key
    state = P.pers.InMemoryState()
    w.elem = F.rand(rng)
    w.accum = P.core.PositiveAccumulator.initialize(w.params).add_batch(
        [w.elem, F.rand(rng), F.rand(rng)], sk, state)
    w.wit = w.accum.get_membership_witness(w.elem, sk, state)
    w.bases = [P.b.G1.rand(rng).normalize() for _ in range(2)]
    w.blinding = F.rand(rng)
    w.comm = P.msm.msm(w.bases, [w.elem, w.blinding]).normalize()
    w.other_sk = P.acc.AccumSecretKey(alpha=F.rand(rng))
    # the KB universal accumulator
    domain = [F.rand(rng) for _ in range(6)]
    w.member, w.non_member = domain[1], domain[4]
    ms, nms = P.pers.InMemoryState(), P.pers.InMemoryState()
    kb = P.kb.KBUniversalAccumulator.initialize(w.params, sk, domain, ms, nms)
    w.kb = kb.add(w.member, sk, ms, nms)
    w.kb_mem_wit = w.kb.get_membership_witness(w.member, sk, ms)
    w.kb_nm_wit = w.kb.get_non_membership_witness(w.non_member, sk, nms)
    # a universal accumulator for the detached non-membership statement
    ustate = P.pers.InMemoryState()
    members = [F.rand(rng) for _ in range(3)]
    w.u_non_member = F.rand(rng)
    uacc = P.core.UniversalAccumulator.initialize(
        rng, w.params, 10, sk, P.pers.InMemoryInitialElements())
    w.uacc = uacc.add_batch(members, sk, ustate)
    w.u_wit = w.uacc.get_non_membership_witness(w.u_non_member, sk, ustate,
                                                w.params)
    w.Q = P.hashing.group_elem_from_try_and_incr(P.b.G1,
                                                 b"detached-Q").normalize()
    return w


def build(w, name, verifier=False, secret_key=None):
    """(spec, witnesses) of `name`; `verifier` gives the verifier's side
    (the full and the detached verifiers) under `secret_key`."""
    P, kv, st = w.P, w.P.kv, w.P.st
    sk = secret_key or w.kp.secret_key
    spec = P.base.ProofSpec(context=b"kv-" + name.encode())
    if name == "vb_kv":
        stmt = kv.VBAccumulatorMembershipKVFullVerifier(
            accumulator_value=w.accum.value(), secret_key=sk) if verifier \
            else kv.VBAccumulatorMembershipKV(
                accumulator_value=w.accum.value())
        s0 = spec.add_statement(stmt)
        s1 = spec.add_statement(st.PedersenCommitmentStmt(bases=w.bases,
                                                          commitment=w.comm))
        spec.add_witness_equality([(s0, 0), (s1, 0)])
        return spec, [st.AccumMembershipWit(element=w.elem, witness=w.wit),
                      [w.elem, w.blinding]]
    if name == "kb_kv":
        spec.add_statement(
            kv.KBUniversalAccumulatorMembershipKVFullVerifier(
                accumulator_value=w.kb.mem.value(), secret_key=sk)
            if verifier else kv.KBUniversalAccumulatorMembershipKV(
                accumulator_value=w.kb.mem.value()))
        spec.add_statement(
            kv.KBUniversalAccumulatorNonMembershipKVFullVerifier(
                accumulator_value=w.kb.non_mem.value(), secret_key=sk)
            if verifier else kv.KBUniversalAccumulatorNonMembershipKV(
                accumulator_value=w.kb.non_mem.value()))
        return spec, [st.AccumMembershipWit(element=w.member,
                                            witness=w.kb_mem_wit),
                      st.AccumMembershipWit(element=w.non_member,
                                            witness=w.kb_nm_wit)]
    if name == "detached":
        spec.add_statement(kv.DetachedAccumulatorMembershipVerifier(
            params=w.params, public_key=w.kp.public_key, secret_key=sk)
            if verifier else kv.DetachedAccumulatorMembershipProver(
                params=w.params, public_key=w.kp.public_key))
        return spec, [kv.DetachedAccumMembershipWit(
            element=w.elem, witness=w.wit,
            accumulator_value=w.accum.value())]
    assert name == "detached_nm"
    spec.add_statement(kv.DetachedAccumulatorNonMembershipVerifier(
        params=w.params, public_key=w.kp.public_key, secret_key=sk, Q=w.Q)
        if verifier else kv.DetachedAccumulatorNonMembershipProver(
            params=w.params, public_key=w.kp.public_key, Q=w.Q))
    return spec, [kv.DetachedAccumNonMembershipWit(
        element=w.u_non_member, witness=w.u_wit,
        accumulator_value=w.uacc.value())]


NAMES = ("vb_kv", "kb_kv", "detached", "detached_nm")


def prove(w, spec, wits, seed, nonce=b"n"):
    return w.P.proof.Proof.new(random.Random(seed), spec, wits, nonce=nonce,
                               **w.P.kw)


def verify(P, proof, spec, mode="none", nonce=b"n"):
    cfg = None if mode == "none" else P.proof.VerifierConfig(mode == "lazy")
    return proof.verify(random.Random(9), spec, nonce=nonce, config=cfg,
                        **P.kw)


@pytest.fixture(scope="module")
def worlds():
    r, t = world(REF), world(PORT)
    out = {}
    for i, name in enumerate(NAMES):
        spec_r, wits_r = build(r, name)
        spec_t, wits_t = build(t, name)
        out[name] = SimpleNamespace(
            spec_r=spec_r, wits_r=wits_r, spec_t=spec_t, wits_t=wits_t,
            proof_r=prove(r, spec_r, wits_r, 40 + i),
            proof_t=prove(t, spec_t, wits_t, 40 + i))
    return r, t, out


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


@pytest.mark.parametrize("name", NAMES)
def test_spec_carried_and_proofs_equal(worlds, name):
    W = worlds[2][name]
    assert canonical(protocol_to_port(W.spec_r)) == canonical(W.spec_t)
    assert canonical(protocol_to_port(W.wits_r)) == canonical(W.wits_t)
    assert canonical(W.proof_t) == canonical(W.proof_r)
    assert canonical(protocol_to_port(W.proof_r)) == canonical(W.proof_t)


@pytest.mark.parametrize("mode", ["none", "lazy"])
@pytest.mark.parametrize("name,side", [
    ("vb_kv", "prover"), ("vb_kv", "verifier"), ("kb_kv", "prover"),
    ("kb_kv", "verifier"), ("detached", "verifier"),
    ("detached_nm", "verifier")])
def test_cross_verify(worlds, name, side, mode):
    """Each package's statements accept both packages' proofs: the plain
    KV statements (the prover's), the full verifiers and the detached
    verifiers (the detached prover's statement checks nothing)."""
    r, t, out = worlds
    W = out[name]
    if side == "verifier":
        spec_r, spec_t = build(r, name, True)[0], build(t, name, True)[0]
    else:
        spec_r, spec_t = W.spec_r, W.spec_t
    assert verify(PORT, W.proof_t, spec_t, mode)
    assert verify(PORT, protocol_to_port(W.proof_r), spec_t, mode)
    assert verify(REF, to_ref(W.proof_t), spec_r, mode)


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
@pytest.mark.parametrize("name", ["vb_kv", "kb_kv", "detached",
                                  "detached_nm"])
def test_other_key_refused(worlds, P, name):
    w = worlds[0] if P is REF else worlds[1]
    W = worlds[2][name]
    proof = W.proof_r if P is REF else W.proof_t
    spec = build(w, name, True, secret_key=w.other_sk)[0]
    with pytest.raises((P.base.ProofSystemError, ValueError)):
        verify(P, proof, spec)


def test_keyed_part_and_detached_randomized(worlds):
    r, t, out = worlds
    for w, W in ((r, out["vb_kv"]), (t, out["vb_kv"])):
        proof = W.proof_r if w is r else W.proof_t
        keyed = proof.statement_proofs[0].keyed_part()
        assert keyed.verify(w.kp.secret_key)
        assert not keyed.verify(w.other_sk)
    d = out["detached"].proof_t.statement_proofs[0]
    assert d.accumulator != t.accum.value()
    assert d.encrypted.ciphertext == \
        out["detached"].proof_r.statement_proofs[0].encrypted.ciphertext


def test_ecies_parity():
    def enc(P, rng):
        sk = P.b.Fr.rand_nonzero(rng)
        g = P.b.G2.generator()
        pk = (g * int(sk)).normalize()
        e = P.ecies.EciesEncryption.encrypt(rng, b"opening bytes" * 5, pk, g,
                                            P.b.Fr, aad=b"ctx")
        out = dict(e=e, dec=e.decrypt(sk, aad=b"ctx"))
        for bad in (dict(recipient_sk=sk + P.b.Fr(1), aad=b"ctx"),
                    dict(recipient_sk=sk, aad=b"other")):
            with pytest.raises(ValueError):
                e.decrypt(**bad)
        return out

    r = enc(REF, random.Random(5))
    t = enc(PORT, random.Random(5))
    assert canonical(t) == canonical(r)
    assert t["dec"] == b"opening bytes" * 5
    assert t["e"].ciphertext == r["e"].ciphertext and t["e"].tag == \
        r["e"].tag


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_bound_check_smc_kv_and_kvac_full_verifier(P):
    """An SMC-KV bound check linked to a BBDT16 MAC's message under its
    full verifier (`tests/test_proof_system_kv.py`'s last test), in both
    packages from one seed: equal proofs, another MAC key and an
    out-of-range value refused."""
    def run(P):
        rng = random.Random(606)
        F = P.b.Fr
        params_kv = P.smc_kv.SetMembershipCheckParamsKV.new_for_range_proof(
            rng, b"smc-kv-rp", 4)
        ck = P.ccs.MemberCommitmentKey.new(b"smc-kv-ck")
        mac_params = P.mac.MACParams.new(b"kvac-params", 3)
        sk = P.mac.KVACSecretKey.generate(rng)
        msgs = [F(57), F.rand(rng), F.rand(rng)]
        mac = P.mac.MAC.new(rng, msgs, sk, mac_params)

        def spec_of(verifier, mac_sk=sk):
            spec = P.base.ProofSpec(context=b"smckv")
            s0 = spec.add_statement(P.more.PoKBBDT16MACFullVerifier(
                params=mac_params, revealed_messages={1: msgs[1]},
                secret_key=mac_sk))
            s1 = spec.add_statement(
                P.ranges.BoundCheckSmcWithKVVerifier(
                    min_val=18, max_val=100, params=params_kv, comm_key=ck,
                    base=4, secret_key=params_kv.sk) if verifier
                else P.ranges.BoundCheckSmcWithKVProver(
                    min_val=18, max_val=100, params=params_kv, comm_key=ck,
                    base=4))
            spec.add_witness_equality([(s0, 0), (s1, 0)])
            return spec

        wits = [P.more.KVACWitness(mac=mac, messages=msgs), F(57)]
        proof = P.proof.Proof.new(rng, spec_of(False), wits, nonce=b"kv3",
                                  **P.kw)
        assert verify(P, proof, spec_of(True), nonce=b"kv3")
        with pytest.raises(Exception):
            P.proof.Proof.new(rng, spec_of(False),
                              [P.more.KVACWitness(mac=mac, messages=msgs),
                               F(7)], nonce=b"kv4", **P.kw)
        with pytest.raises(P.base.ProofSystemError):
            verify(P, proof,
                   spec_of(True, P.mac.KVACSecretKey.generate(rng)),
                   nonce=b"kv3")
        return proof

    proof = run(P)
    if P is PORT:
        assert canonical(proof) == canonical(run(REF))


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_detached_beside_another_statement_refused(worlds, P):
    """The detached verifier's challenge contribution is not its prover's,
    so beside another statement the recomputed challenge differs and the
    other statement fails: in the reference, and so in the port
    (ROADMAP Queue 3)."""
    w = worlds[0] if P is REF else worlds[1]

    def spec_of(verifier):
        spec, wits = build(w, "detached", verifier)
        s1 = spec.add_statement(w.P.st.PedersenCommitmentStmt(
            bases=w.bases, commitment=w.comm))
        spec.add_witness_equality([(0, 0), (s1, 0)])
        return spec, wits + [[w.elem, w.blinding]]

    spec, wits = spec_of(False)
    proof = prove(w, spec, wits, 50)
    with pytest.raises(P.base.ProofSystemError, match="Pedersen"):
        verify(P, proof, spec_of(True)[0])
