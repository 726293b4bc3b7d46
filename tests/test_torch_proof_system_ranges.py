"""The port's range statements in the composite proof system
(`crypto_tpu_torch/proof_system/statements_ranges.py`: the
Bulletproofs++ bound check, the CCS set-membership bound check, its
keyed-verification prover and verifier, public inequality and the Circom
R1CS statement, with its SnarkPack path) against the reference's
(`crypto_tpu/proof_system/statements_ranges.py`), each linked to a BBS+
credential as in the reference's `tests/test_proof_system_ranges.py`.

Each world is built in both packages from the same `random.Random`
seed (the reference's spec carried across with `convert.protocol_to_port`
equals the port's).  `Proof.new` gives the same proof in both, canonical
integers and bytes; each package's `verify` accepts the other's proof
with no checker and with the lazy and eager checkers (the port's on the
CPU), and a wrong nonce, a broken witness equality, other bounds, a
spoiled range proof and a value out of range are refused.  The
Bulletproofs++ statement proves 64 bits; in the default lane its
`num_bits` is cut to 16 in both packages, and the 64-bit composite runs
in the slow lane, as the reference's own 64-bit test does.  The Circom circuit is written by the test
(`testing.r1cs_bytes`).  The reference's pairings run on the host
(`CRYPTO_TPU_PAIRING_BACKEND=host`).
"""

import copy
import dataclasses
import importlib
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads, r1cs_bytes

from test_torch_commitment_inequality import to_ref

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("setup", "bbs_plus.setup"), ("signature", "bbs_plus.signature"),
        ("base", "proof_system.base"), ("proof", "proof_system.proof"),
        ("st", "proof_system.statements"),
        ("sr", "proof_system.statements_ranges"),
        ("rp", "bulletproofs_pp.range_proof"), ("wnla", "bulletproofs_pp.wnla"),
        ("ccs", "smc_range_proof.ccs"), ("kv", "smc_range_proof.kv"),
        ("commitment", "utils.commitment"), ("circom", "legogroth16.circom"),
        ("snark", "legogroth16.snark"), ("aggr", "legogroth16.aggregation"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["dev"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")
VALUE = 5000                         # message 0, the bounded attribute
BOUNDS = (4500, 5500)


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


def world(P, r1cs_path, seed=888):
    """A credential of 4 messages (message 0 the bounded value, message 2
    a Circom wire), the ranges' params, a Pedersen key, a multiply2
    circuit over BLS12-381 and its LegoGroth16 key."""
    rng = random.Random(seed)
    F = P.b.Fr
    messages = [F(VALUE), F.rand(rng), F.rand(rng), F.rand(rng)]
    params = P.setup.SignatureParamsG1.new(b"ps-range-test", 4)
    sk = P.setup.SecretKey.generate(rng)
    pk = P.setup.PublicKeyG2.generate(sk, params)
    sig = P.signature.SignatureG1.new(rng, messages, sk, params)
    smc = P.ccs.SetMembershipCheckParams.new_for_range_proof(rng, b"ps-smc",
                                                             4)
    smc_kv = P.kv.SetMembershipCheckParamsKV.new_for_range_proof(
        rng, b"ps-smc-kv", 4)
    ck = P.ccs.MemberCommitmentKey.new(b"ps-smc-ck")
    ped = P.commitment.PedersenCommitmentKey.new(P.b.G1, b"ps-ineq-ck")
    r = F.rand(rng)
    r1cs = P.circom.parse_r1cs(str(r1cs_path))
    snark_pk = P.snark.generate_random_parameters(
        P.circom.circom_circuit(r1cs), 1, rng, **P.dev)
    return SimpleNamespace(P=P, messages=messages, params=params, pk=pk,
                           sig=sig, smc=smc, smc_kv=smc_kv, ck=ck, ped=ped,
                           ped_r=r, ped_c=ped.commit(messages[1], r),
                           inequal_to=F.rand(rng), r1cs=r1cs,
                           snark_pk=snark_pk)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    path = tmp_path_factory.mktemp("circom") / "multiply2.r1cs"
    path.write_bytes(r1cs_bytes(tb.R, 1, 0, 2, 4,
                                [([(1, 2)], [(1, 3)], [(1, 1)])]))
    return world(REF, path), world(PORT, path)


def make_spec(w, kind, bounds=BOUNDS, link=0):
    """BBS+ and the statement `kind`, its witness 0 equal to message
    `link`."""
    P = w.P
    spec = P.base.ProofSpec()
    s0 = spec.add_statement(P.st.PoKBBSSignatureG1(
        params=w.params, public_key=w.pk, revealed_messages={}))
    lo, hi = bounds
    if kind == "bpp":
        bpp = P.rp.SetupParams.new_for_perfect_range_proof(
            b"ps-bpp", 2, bpp_bits(P), 2)
        stmt = P.sr.BoundCheckBpp(min_val=lo, max_val=hi, bpp_params=bpp)
    elif kind == "smc":
        stmt = P.sr.BoundCheckSmc(min_val=lo, max_val=hi, params=w.smc,
                                  comm_key=w.ck, base=4)
    elif kind in ("smc_kv_prover", "smc_kv_verifier"):
        cls = P.sr.BoundCheckSmcWithKVProver if kind == "smc_kv_prover" \
            else P.sr.BoundCheckSmcWithKVVerifier
        extra = {} if kind == "smc_kv_prover" else \
            {"secret_key": w.smc_kv.sk}
        stmt = cls(min_val=lo, max_val=hi, params=w.smc_kv, comm_key=w.ck,
                   base=4, **extra)
    elif kind == "inequality":
        stmt = P.sr.PublicInequalityStatement(
            commitment=w.ped_c, inequal_to=w.inequal_to, comm_key=w.ped)
    else:
        a, b = w.messages[2], w.messages[3]
        stmt = P.sr.R1CSCircomStatement(r1cs=w.r1cs, snark_pk=w.snark_pk,
                                        public_inputs=[a * b])
    s1 = spec.add_statement(stmt)
    spec.add_witness_equality([(s0, link), (s1, 0)])
    return spec


def bpp_bits(P) -> int:
    """`BoundCheckBpp.num_bits` of package P: 64, or 16 under `bpp16`."""
    bits = P.sr.BoundCheckBpp.num_bits
    return 64 if isinstance(bits, property) else bits


def spoil_kv(pok):
    """A KV digit PoK with its randomizer response off by one (a value
    outside the challenge contribution)."""
    return dataclasses.replace(pok, sc=dataclasses.replace(
        pok.sc, response1=pok.sc.response1 + pok.sc.response1.f(1)))


def witnesses(w, kind, value=None):
    P, m = w.P, w.messages
    bbs = P.st.BBSWitness(signature=w.sig, messages=m)
    if kind == "inequality":
        return [bbs, (m[1], w.ped_r)]
    if kind == "r1cs":
        return [bbs, [m[0].f(1), m[2] * m[3], m[2], m[3]]]
    return [bbs, m[0] if value is None else m[0].f(value)]


LINK = {"bpp": 0, "smc": 0, "smc_kv_prover": 0, "smc_kv_verifier": 0,
        "inequality": 1, "r1cs": 2}


def prove(w, kind, nonce=b"n1", seed=7, **kw):
    spec = make_spec(w, kind, link=LINK[kind], **kw)
    return w.P.proof.Proof.new(random.Random(seed), spec,
                               witnesses(w, kind), nonce=nonce, **w.P.dev)


def verify(w, proof, kind, mode="none", nonce=b"n1", **kw):
    P = w.P
    cfg = None if mode == "none" else P.proof.VerifierConfig(mode == "lazy")
    spec = make_spec(w, kind, link=LINK[kind], **kw)
    return proof.verify(random.Random(3), spec, nonce=nonce, config=cfg,
                        **P.dev)


@pytest.fixture
def bpp16(monkeypatch):
    """The Bulletproofs++ statement at 16 bits in both packages."""
    for P in (REF, PORT):
        monkeypatch.setattr(P.sr.BoundCheckBpp, "num_bits", 16)


KINDS = ["smc", "smc_kv_prover", "smc_kv_verifier", "inequality", "r1cs"]


def test_spec_carried_equal(worlds):
    ref, port = worlds
    for kind in KINDS:
        spec_r = make_spec(ref, kind, link=LINK[kind])
        spec_t = make_spec(port, kind, link=LINK[kind])
        assert canonical(protocol_to_port(spec_r)) == canonical(spec_t)


@pytest.mark.parametrize("kind", KINDS)
def test_composite_parity(worlds, kind):
    ref, port = worlds
    p_r, p_t = prove(ref, kind), prove(port, kind)
    assert canonical(p_r) == canonical(p_t)
    for mode in ("none", "lazy", "eager"):
        assert verify(port, p_t, kind, mode)
        assert verify(port, protocol_to_port(p_r), kind, mode)
    assert verify(ref, to_ref(p_t), kind)
    assert verify(ref, to_ref(p_t), kind, "lazy")


def test_composite_parity_bpp(worlds, bpp16):
    ref, port = worlds
    p_r, p_t = prove(ref, "bpp"), prove(port, "bpp")
    assert canonical(p_r) == canonical(p_t)
    for mode in ("none", "lazy"):
        assert verify(port, p_t, "bpp", mode)
        assert verify(port, protocol_to_port(p_r), "bpp", mode)
    assert verify(ref, to_ref(p_t), "bpp")


def _refusals(w, kind):
    P = w.P
    proof = prove(w, kind)
    out = {}

    def refused(name, fn, err=P.base.ProofSystemError):
        try:
            fn()
        except err:
            out[name] = True
            return
        out[name] = False

    refused("nonce", lambda: verify(w, proof, kind, nonce=b"other"))
    # message 3 instead of the linked message
    refused("equality", lambda: proof.verify(
        random.Random(3), make_spec(w, kind, link=3), nonce=b"n1", **P.dev))
    if kind in ("bpp", "smc", "smc_kv_verifier"):
        refused("bounds", lambda: verify(w, proof, kind,
                                         bounds=(VALUE + 1, BOUNDS[1])))
    return proof, out


@pytest.mark.parametrize("kind", ["bpp", "smc", "smc_kv_verifier",
                                  "inequality", "r1cs"])
def test_composite_refused(worlds, bpp16, kind):
    for w in worlds:
        _, out = _refusals(w, kind)
        assert all(out.values()), out


@pytest.mark.parametrize("kind,spoil", [
    ("bpp", "bpp"), ("smc", "digit"), ("smc_kv_verifier", "kv"),
    ("r1cs", "snark")])
def test_spoiled_range_proofs(worlds, bpp16, kind, spoil):
    """A spoiled Bulletproofs++ proof, set-membership digit, KV digit and
    SNARK, each refused by both packages with every checker mode."""
    for w in worlds:
        P = w.P
        bad = copy.deepcopy(prove(w, kind))
        sp = bad.statement_proofs[1]
        if spoil == "bpp":
            wn = sp.bpp_proof.norm_proof
            wn.n = [wn.n[0] + wn.n[0].f(1)]
        elif spoil == "digit":
            rp = sp.range_proof
            rp.z_v_max = [rp.z_v_max[0] + rp.z_v_max[0].f(1)] + \
                rp.z_v_max[1:]
        elif spoil == "kv":
            poks = sp.range_proof.pok_sigs_min
            poks[0] = spoil_kv(poks[0])
        else:
            sp.snark_proof.c = (sp.snark_proof.c
                                + P.b.G1.generator()).normalize()
        for mode in ("none", "lazy", "eager"):
            with pytest.raises(P.base.ProofSystemError):
                verify(w, bad, kind, mode)


def test_out_of_range_at_prove_time(worlds, bpp16):
    for w in worlds:
        P = w.P
        for kind, value, err in (
                ("bpp", 999, P.wnla.BppError),
                ("smc", 8192, P.ccs.SmcError),
                ("smc_kv_prover", 999, P.ccs.SmcError)):
            spec = make_spec(w, kind)
            with pytest.raises(err):
                P.proof.Proof.new(random.Random(1), spec,
                                  witnesses(w, kind, value), **P.dev)


def test_kv_prover_statement_checks_opening_only(worlds):
    """Without the secret key the prover's statement checks the Schnorr
    opening alone: a spoiled KV digit passes it and fails the verifier's
    statement, in both packages."""
    for w in worlds:
        P = w.P
        bad = copy.deepcopy(prove(w, "smc_kv_prover"))
        poks = bad.statement_proofs[1].range_proof.pok_sigs_max
        poks[0] = spoil_kv(poks[0])
        assert verify(w, bad, "smc_kv_prover")
        with pytest.raises(P.base.ProofSystemError):
            verify(w, bad, "smc_kv_verifier")


def _aggregate(w, srs, n=2):
    P = w.P
    F = P.b.Fr
    spec = P.base.ProofSpec()
    idx = [spec.add_statement(P.sr.R1CSCircomStatement(
        r1cs=w.r1cs, snark_pk=w.snark_pk,
        public_inputs=[F(3 + i) * F(5 + i)])) for i in range(n)]
    spec.aggregate_legogroth16 = [idx]
    spec.snark_aggregation_srs = srs
    wits = [[F(1), F(3 + i) * F(5 + i), F(3 + i), F(5 + i)]
            for i in range(n)]
    return spec, wits


def test_r1cs_snarkpack_aggregation(worlds):
    """Two Circom statements folded into one SnarkPack aggregate (the
    `R1CSCircomProofAggr` path): the same proof in both packages, accepted
    by both, and refused for another public input."""
    ref, port = worlds
    gsrs = REF.aggr.GenericSRS.setup(random.Random(506), 2)
    srs_r = gsrs.specialize(2)
    srs_t = protocol_to_port(srs_r)
    proofs = []
    for w, srs in ((ref, srs_r), (port, srs_t)):
        spec, wits = _aggregate(w, srs[0])
        proofs.append(w.P.proof.Proof.new(random.Random(9), spec, wits,
                                          nonce=b"agg", **w.P.dev))
    p_r, p_t = proofs
    assert canonical(p_r) == canonical(p_t)
    assert all(isinstance(p, PORT.sr.R1CSCircomProofAggr)
               for p in p_t.statement_proofs)
    spec_t, _ = _aggregate(port, srs_t[1])
    assert p_t.verify(random.Random(3), spec_t, nonce=b"agg", device="cpu")
    spec_r, _ = _aggregate(ref, srs_r[1])
    assert p_r.verify(random.Random(3), spec_r, nonce=b"agg")
    spec_t.statements[0].public_inputs = [tb.Fr(999)]
    with pytest.raises(PORT.base.ProofSystemError):
        p_t.verify(random.Random(3), spec_t, nonce=b"agg", device="cpu")


@pytest.mark.slow
def test_bbs_message_bound_check_bpp_64(worlds):
    """The 64-bit Bulletproofs++ bound check in a composite, as the
    reference's `test_bbs_message_bound_check_bpp`: the same proof as the
    reference's, accepted by both."""
    ref, port = worlds
    p_t = prove(port, "bpp")
    assert canonical(p_t) == canonical(prove(ref, "bpp"))
    for mode in ("none", "lazy"):
        assert verify(port, p_t, "bpp", mode)
    assert verify(ref, to_ref(p_t), "bpp")
    with pytest.raises(PORT.base.ProofSystemError):
        verify(port, p_t, "bpp", nonce=b"wrong")
