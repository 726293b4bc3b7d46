"""The port's SNARK-backed composite statements
(`crypto_tpu_torch/proof_system/statements_snark.py`: a LegoGroth16
bound check and SAVER verifiable encryption, linked to a BBS+
credential) against the reference's, as in the reference's
`tests/test_proof_system_snark.py`, at 16-bit SAVER chunks.

The CRSs and keys are the reference's, carried across
(`convert.protocol_to_port`; their equality from the same rng is
`test_torch_link.py`'s and `test_torch_saver_proof.py`'s).  The port's
SNARK provers run on the CPU; the reference's `create_proof` is
`stand_in_prover`'s stand-in (the reference's prover compiles its JAX
NTTs on first use), so `Proof.new` in both packages from the same seed
gives the same proof, canonical integers and bytes.  Each package's
`verify` accepts the other's (no checker, lazy and eager checkers), the
auditor's decryption returns the linked message, `ProverConfig` reuse
rerandomises the first proof's SNARK material the same way in both,
`DerivedParamsTracker` derives the shared bound-check key once (also
after the spec is carried across), and an age out of range is refused
at prove time.  The SnarkPack aggregation inside a composite proof runs
the reference's own provers, in the slow lane.
"""

import copy
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.bbs_plus import setup as jbs
from crypto_tpu.bbs_plus import signature as jsig
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.legogroth16 import aggregation as jaggr
from crypto_tpu.legogroth16.bound_check import generate_snark_srs_bound_check
from crypto_tpu.proof_system import base as jbase
from crypto_tpu.proof_system import proof as jproof
from crypto_tpu.proof_system import statements as jst
from crypto_tpu.proof_system import statements_snark as jss
from crypto_tpu.saver import core as js
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.proof_system import base as tbase
from crypto_tpu_torch.proof_system import proof as tproof
from crypto_tpu_torch.proof_system import statements as tst
from crypto_tpu_torch.proof_system import statements_snark as tss
from crypto_tpu_torch.saver import core as ts
from crypto_tpu_torch.testing import cap_threads
from test_torch_proof_system import to_ref
from test_torch_saver import CB, ENV, stand_in_prover

cap_threads()


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


@pytest.fixture(scope="module")
def world():
    """The reference's credential (message 0 the age), bound-check CRS,
    SAVER CRS and keys, and commitment bases; and the same carried to
    the port."""
    rng = random.Random(505)
    F = jb.Fr
    sig_params = jbs.SignatureParamsG1.new(b"issuer", 3)
    issuer = jbs.KeypairG2.generate(rng, sig_params)
    messages = [F(25), F.rand(rng), F.rand(rng)]
    sig = jsig.SignatureG1.new(rng, messages, issuer.secret_key, sig_params)
    bound = generate_snark_srs_bound_check(rng)
    gens = js.EncryptionGens.new(b"ps-saver")
    spk = js.generate_srs(CB, gens, rng)
    g_i = js.get_gs_for_encryption(spk.pk.vk)
    sk, ek, dk = js.keygen(rng, CB, gens, g_i, spk.pk.delta_g1,
                           spk.gamma_g1)
    G, H = (jb.G1.rand(rng).normalize() for _ in range(2))
    ref = SimpleNamespace(sig_params=sig_params, pk=issuer.public_key,
                          messages=messages, sig=sig, bound=bound, gens=gens,
                          spk=spk, g_i=g_i, sk=sk, ek=ek, dk=dk, G=G, H=H)
    return ref, SimpleNamespace(**protocol_to_port(vars(ref)))


def build_spec(w, port, bounds=((18, 100),), saver=True):
    st, ss, base = (tst, tss, tbase) if port else (jst, jss, jbase)
    spec = base.ProofSpec()
    s0 = spec.add_statement(st.PoKBBSSignatureG1(
        params=w.sig_params, public_key=w.pk, revealed_messages={}))
    age = [(s0, 0)]
    for lo, hi in bounds:
        age.append((spec.add_statement(ss.BoundCheckLegoGroth16(
            min_val=lo, max_val=hi, snark_pk=w.bound)), 0))
    if len(age) > 1:
        spec.add_witness_equality(age)
    if saver:
        s = spec.add_statement(ss.SaverStatement(
            chunk_bit_size=CB, enc_gens=w.gens, ek=w.ek, snark_pk=w.spk,
            comm_G=w.G, comm_H=w.H))
        spec.add_witness_equality([(s0, 1), (s, 0)])
    return spec


def witnesses(w, port, n_bounds=1, saver=True):
    st = tst if port else jst
    return [st.BBSWitness(signature=w.sig, messages=w.messages)] \
        + [w.messages[0]] * n_bounds + ([w.messages[1]] if saver else [])


def _prove(port, spec, wits, nonce, seed, config=None):
    if port:
        return tproof.Proof.new(random.Random(seed), spec, wits, nonce=nonce,
                                config=config, device="cpu")
    return jproof.Proof.new(random.Random(seed), spec, wits, nonce=nonce,
                            config=config)


def _verify(port, proof, spec, nonce, mode="none", seed=3):
    mod = tproof if port else jproof
    cfg = None if mode == "none" else mod.VerifierConfig(mode == "lazy")
    kw = {"device": "cpu"} if port else {}
    return proof.verify(random.Random(seed), spec, nonce=nonce, config=cfg,
                        **kw)


@pytest.fixture(scope="module")
def proofs(world):
    """The composite proof in both packages (the reference's prover the
    stand-in), and the second proof of each reusing the first's SNARK
    material through `ProverConfig`."""
    r, t = world
    mp = pytest.MonkeyPatch()
    try:
        stand_in_prover(mp)
        cfg_t, cfg_r = tproof.ProverConfig(), jproof.ProverConfig()
        p_t = _prove(True, build_spec(t, True), witnesses(t, True), b"ve", 7,
                     cfg_t)
        p_r = _prove(False, build_spec(r, False), witnesses(r, False), b"ve",
                     7, cfg_r)
    finally:
        mp.undo()

    def reuse(mod, proof, cfg):
        ct, sp = proof.get_saver_ciphertext_and_proof(2)
        return mod.ProverConfig(
            reuse_legogroth16_proofs={1: mod.OldLegoGroth16Proof(
                v=cfg.commitment_randomness[1],
                proof=proof.get_legogroth16_proof(1))},
            reuse_saver_proofs={2: mod.OldSaverProof(
                v=cfg.commitment_randomness[2], ciphertext=ct, proof=sp)})

    cfg2_t, cfg2_r = reuse(tproof, p_t, cfg_t), reuse(jproof, p_r, cfg_r)
    p2_t = _prove(True, build_spec(t, True), witnesses(t, True), b"r2", 8,
                  cfg2_t)
    p2_r = _prove(False, build_spec(r, False), witnesses(r, False), b"r2", 8,
                  cfg2_r)
    return SimpleNamespace(t=p_t, r=p_r, cfg_t=cfg_t, cfg_r=cfg_r, t2=p2_t,
                           r2=p2_r, cfg2_t=cfg2_t, cfg2_r=cfg2_r)


def test_composite_snark_proof_equal(world, proofs):
    assert canonical(proofs.t) == canonical(proofs.r)
    assert canonical(proofs.cfg_t.commitment_randomness) == \
        canonical(proofs.cfg_r.commitment_randomness)
    assert sorted(proofs.cfg_t.commitment_randomness) == [1, 2]


@pytest.mark.parametrize("mode", ["none", "lazy", "eager"])
def test_composite_snark_cross_verify(world, proofs, mode):
    r, t = world
    assert _verify(True, proofs.t, build_spec(t, True), b"ve", mode)
    assert _verify(True, protocol_to_port(proofs.r), build_spec(t, True),
                   b"ve", mode)
    assert _verify(False, to_ref(proofs.t), build_spec(r, False), b"ve",
                   mode)
    with pytest.raises(tbase.ProofSystemError):
        _verify(True, proofs.t, build_spec(t, True), b"other", mode)


def test_composite_snark_rejections(world, proofs):
    """A changed SAVER ciphertext, a changed bound-check D and another
    bound, in the port (and the ciphertext also in the reference): each
    changes the transcript, and the SAVER statement alone, held to the
    proof's own challenge, refuses the changed ciphertext."""
    r, t = world
    spec = build_spec(t, True)
    bad = copy.deepcopy(proofs.t)
    ct = bad.statement_proofs[2].ciphertext
    ct.enc_chunks[0] = (ct.enc_chunks[0] + t.G).normalize()
    with pytest.raises(tbase.ProofSystemError):
        _verify(True, bad, spec, b"ve")
    with pytest.raises(jbase.ProofSystemError):
        _verify(False, to_ref(bad), build_spec(r, False), b"ve")
    stmt = spec.resolved_statements("cpu")[2]
    c = tss.F.rand(random.Random(4))
    with pytest.raises(tbase.ProofSystemError, match="SAVER"):
        stmt.verify_proof(bad.statement_proofs[2], c)
    bad = copy.deepcopy(proofs.t)
    sp = bad.statement_proofs[1].snark_proof
    sp.d = (sp.d + t.G).normalize()
    for mode in ("none", "lazy"):
        with pytest.raises(tbase.ProofSystemError):
            _verify(True, bad, spec, b"ve", mode)
    with pytest.raises(tbase.ProofSystemError):
        _verify(True, proofs.t, build_spec(t, True, bounds=((18, 99),)),
                b"ve")


def test_auditor_decrypts_linked_message(world, proofs):
    r, t = world
    ct = proofs.t.statement_proofs[2].ciphertext
    dec, nu = ts.decrypt(ct, t.sk, t.dk, t.g_i, CB, device="cpu")
    assert dec == t.messages[1]
    assert ts.verify_decryption(ct, dec, nu, t.dk, t.g_i, t.gens, CB,
                                device="cpu")


def test_prover_config_reuse(world, proofs):
    """The second proof rerandomises the first's SNARK material (no SNARK
    prover runs), the same in both packages; it verifies in both and is
    unlinkable to the first; its config records the fresh randomness."""
    r, t = world
    assert canonical(proofs.t2) == canonical(proofs.r2)
    assert _verify(True, proofs.t2, build_spec(t, True), b"r2", "lazy")
    assert _verify(False, to_ref(proofs.t2), build_spec(r, False), b"r2")
    ct1, sp1 = proofs.t.get_saver_ciphertext_and_proof(2)
    ct2, sp2 = proofs.t2.get_saver_ciphertext_and_proof(2)
    assert ct2.X_r != ct1.X_r and sp2.a != sp1.a
    assert proofs.t2.get_legogroth16_proof(1).a != \
        proofs.t.get_legogroth16_proof(1).a
    assert sorted(proofs.cfg2_t.commitment_randomness) == [1, 2]
    assert canonical(proofs.cfg2_t.commitment_randomness) == \
        canonical(proofs.cfg2_r.commitment_randomness)


def test_derived_params_tracker_dedup(world, monkeypatch):
    """Two bound checks sharing one key derive its prepared key once per
    spec, in a spec built in the port and in the reference's spec carried
    across (the carry keeps the shared key shared)."""
    r, t = world
    bounds = ((18, 100), (0, 60))
    spec = build_spec(t, True, bounds=bounds, saver=False)
    proof = _prove(True, spec, witnesses(t, True, n_bounds=2, saver=False),
                   b"ddp", 9)
    for vspec in (build_spec(t, True, bounds=bounds, saver=False),
                  protocol_to_port(build_spec(r, False, bounds=bounds,
                                              saver=False))):
        assert vspec.statements[1].snark_pk is vspec.statements[2].snark_pk
        assert _verify(True, proof, vspec, b"ddp")
        assert vspec.derive_prepared_parameters().derivations == 1
        assert _verify(True, proof, vspec, b"ddp", "lazy")
        assert vspec.derive_prepared_parameters().derivations == 1


def test_bound_check_out_of_range(world):
    r, t = world
    spec = build_spec(t, True, bounds=((30, 100),), saver=False)
    with pytest.raises(tsnark.LegoGroth16Error):
        _prove(True, spec, witnesses(t, True, saver=False), b"x", 10)


@pytest.mark.slow
def test_snarkpack_in_composite_real_provers(world):
    """Two bound checks and two SAVER statements folded into one SnarkPack
    aggregate each, the reference's own provers beside the port's: the
    same proof, accepted by both, a spoiled aggregate refused by both."""
    r, t = world
    gsrs = jaggr.GenericSRS.setup(random.Random(506), 2)
    srs_r = gsrs.specialize(2)
    srs_t = protocol_to_port(srs_r)

    def spec(w, port, srs):
        s = build_spec(w, port, bounds=((18, 100), (0, 60)), saver=True)
        ss = tss if port else jss
        s.add_statement(ss.SaverStatement(
            chunk_bit_size=CB, enc_gens=w.gens, ek=w.ek, snark_pk=w.spk,
            comm_G=w.G, comm_H=w.H))
        s.add_witness_equality([(0, 2), (4, 0)])
        s.aggregate_legogroth16 = [[1, 2]]
        s.aggregate_groth16 = [[3, 4]]
        s.snark_aggregation_srs = srs
        return s

    def wits(w, port):
        return witnesses(w, port, n_bounds=2) + [w.messages[2]]

    p_t = _prove(True, spec(t, True, srs_t[0]), wits(t, True), b"agg", 11)
    p_r = _prove(False, spec(r, False, srs_r[0]), wits(r, False), b"agg", 11)
    assert canonical(p_t) == canonical(p_r)
    assert isinstance(p_t.statement_proofs[1], tss.BoundCheckProofAggr)
    assert isinstance(p_t.statement_proofs[3], tss.SaverProofAggr)
    assert _verify(True, p_t, spec(t, True, srs_t[1]), b"agg")
    assert _verify(False, to_ref(p_t), spec(r, False, srs_r[1]), b"agg")
    bad = copy.deepcopy(p_t)
    ag = bad.aggregated_legogroth16[0][1]
    ag.z_c = (ag.z_c + tb.G1.generator()).normalize()
    with pytest.raises(tbase.ProofSystemError):
        _verify(True, bad, spec(t, True, srs_t[1]), b"agg")
