"""The port's `proof_system/statements_more.py` (PS signatures, BBS23 and
BBDT16 MACs in the composite proof system) and the KB universal
accumulator statements of `statements.py` against the reference's, on
the shapes of the reference's `tests/test_proof_system_more.py` (3
messages a credential, a 6-element KB domain).

Each spec is built in both packages from the same `random.Random` seed:
BBS+ and PS credentials linked by a user id; a BBDT16 MAC (plain and
full verifier); two BBS23 signatures with a shared randomizer; KB
universal membership and non-membership; and all of them in one spec,
the user id linked across BBS+, PS, the MAC and KB membership.  The
carried specs and witnesses equal the port's, `Proof.new` gives the same
statement proofs (canonical integers), and each package's `verify`
accepts the other's proof with no checker and with the lazy and eager
`RandomizedPairingChecker` (the port's on the CPU).  The whole spec's
lazy check (10 deferred pairs: BBS+, PS, BBS23 and both KB statements)
goes through `TPairing`'s plain kernels in one Miller product, and a
proof over a spoiled PS signature is refused there.  A PS credential of
another user id, a MAC under another key and a wrong key holder are
refused.
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
N = 3
NONCE = b"more"


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("ps", "coconut.core"), ("kv", "kvac.bbdt16"),
        ("bbs", "bbs_plus.setup"), ("sig", "bbs_plus.signature"),
        ("b23", "bbs_plus.bbs23"), ("acc", "accumulator.setup"),
        ("kb", "accumulator.kb_universal"),
        ("pers", "accumulator.persistence"), ("base", "proof_system.base"),
        ("st", "proof_system.statements"),
        ("more", "proof_system.statements_more"),
        ("proof", "proof_system.proof"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def world(P, seed=1313):
    rng = random.Random(seed)
    F = P.b.Fr
    uid = F.rand(rng)
    w = SimpleNamespace(P=P, uid=uid)
    w.bbs_params = P.bbs.SignatureParamsG1.new(b"issuerA", N)
    w.bbs_kp = P.bbs.KeypairG2.generate(rng, w.bbs_params)
    w.bbs_msgs = [F.rand(rng), uid, F.rand(rng)]
    w.bbs_sig = P.sig.SignatureG1.new(rng, w.bbs_msgs, w.bbs_kp.secret_key,
                                      w.bbs_params)
    w.ps_params = P.ps.PSSignatureParams.new(b"issuerB", N)
    w.ps_sk = P.ps.PSSecretKey.generate(rng, N)
    w.ps_pk = P.ps.PSPublicKey.generate(w.ps_sk, w.ps_params)
    w.ps_msgs = [uid, F.rand(rng), F.rand(rng)]
    w.ps_sig = P.ps.PSSignature.new(rng, w.ps_msgs, w.ps_sk, w.ps_params)
    w.mac_params = P.kv.MACParams.new(b"kvac-ps", N)
    w.mac_sk = P.kv.KVACSecretKey.generate(rng)
    w.mac_msgs = [F.rand(rng), F.rand(rng), uid]
    w.mac = P.kv.MAC.new(rng, w.mac_msgs, w.mac_sk, w.mac_params)
    w.b23_params = P.b23.SignatureParams23G1.new(b"bbs23-ps", N)
    b23_sk = P.bbs.SecretKey.generate(rng)
    w.b23_pk = P.b23.PublicKey23G2.generate(b23_sk, w.b23_params)
    shared = F.rand(rng)
    w.b23_msgs = [[F.rand(rng), shared, F.rand(rng)],
                  [shared, F.rand(rng), F.rand(rng)]]
    w.b23_sigs = [P.b23.Signature23G1.new(rng, m, b23_sk, w.b23_params)
                  for m in w.b23_msgs]
    w.b23_r = F.rand_nonzero(rng)
    w.acc_params = P.acc.AccumSetupParams.new(b"kb-ps")
    w.acc_sk = P.acc.AccumSecretKey.generate(rng)
    w.acc_pk = P.acc.AccumPublicKey.generate(w.acc_sk, w.acc_params)
    w.domain = [uid] + [F.rand(rng) for _ in range(5)]
    ms, nms = P.pers.InMemoryState(), P.pers.InMemoryState()
    kb = P.kb.KBUniversalAccumulator.initialize(w.acc_params, w.acc_sk,
                                                w.domain, ms, nms)
    kb = kb.add(w.domain[0], w.acc_sk, ms, nms)
    w.kb = kb.add(w.domain[1], w.acc_sk, ms, nms)
    w.mem_wit = w.kb.get_membership_witness(w.domain[0], w.acc_sk, ms)
    w.nm_wit = w.kb.get_non_membership_witness(w.domain[3], w.acc_sk, nms)
    return w


def kb_statements(w, spec):
    st = w.P.st
    return (spec.add_statement(st.KBUniversalAccumulatorMembership(
        accumulator_value=w.kb.mem.value(), params=w.acc_params,
        public_key=w.acc_pk)),
        spec.add_statement(st.KBUniversalAccumulatorNonMembership(
            accumulator_value=w.kb.non_mem.value(), params=w.acc_params,
            public_key=w.acc_pk)))


def kb_wits(w):
    st = w.P.st
    return [st.AccumMembershipWit(element=w.domain[0], witness=w.mem_wit),
            st.AccumMembershipWit(element=w.domain[3], witness=w.nm_wit)]


def build(w, name, mac_sk=None, ps_sig=None, ps_msgs=None):
    """(spec, witnesses) of the spec `name` over the world `w`."""
    P, st, more = w.P, w.P.st, w.P.more
    spec = P.base.ProofSpec(context=b"more-" + name.encode())
    wits = []

    def bbs():
        wits.append(st.BBSWitness(w.bbs_sig, w.bbs_msgs))
        return spec.add_statement(st.PoKBBSSignatureG1(
            params=w.bbs_params, public_key=w.bbs_kp.public_key,
            revealed_messages={}))

    def ps():
        wits.append(more.PSSigWitness(ps_sig or w.ps_sig,
                                      ps_msgs or w.ps_msgs))
        return spec.add_statement(more.PoKPSSignature(
            params=w.ps_params, public_key=w.ps_pk, revealed_messages={}))

    def mac(full):
        wits.append(more.KVACWitness(w.mac, w.mac_msgs))
        revealed = {0: w.mac_msgs[0]}
        if full:
            return spec.add_statement(more.PoKBBDT16MACFullVerifier(
                params=w.mac_params, revealed_messages=revealed,
                secret_key=mac_sk or w.mac_sk))
        return spec.add_statement(more.PoKBBDT16MAC(
            params=w.mac_params, revealed_messages=revealed))

    def b23(i):
        wits.append(more.BBS23Witness(w.b23_sigs[i], w.b23_msgs[i],
                                      sig_randomizer=w.b23_r))
        return spec.add_statement(more.PoKBBSSignature23G1(
            params=w.b23_params, public_key=w.b23_pk, revealed_messages={}))

    if name == "bbs_ps":
        spec.add_witness_equality([(bbs(), 1), (ps(), 0)])
    elif name == "kvac":
        mac(False)
    elif name == "kvac_full":
        mac(True)
    elif name == "bbs23":
        spec.add_witness_equality([(b23(0), 1), (b23(1), 0)])
    elif name == "kb":
        kb_statements(w, spec)
        wits.extend(kb_wits(w))
    elif name == "all":
        s_bbs, s_ps, s_mac = bbs(), ps(), mac(True)
        b23(0)
        s_mem, _ = kb_statements(w, spec)
        wits.extend(kb_wits(w))
        spec.add_witness_equality([(s_bbs, 1), (s_ps, 0), (s_mac, 2),
                                   (s_mem, 0)])
    return spec, wits


NAMES = ("bbs_ps", "kvac", "kvac_full", "bbs23", "kb", "all")


def prove(w, spec, wits, seed):
    return w.P.proof.Proof.new(random.Random(seed), spec, wits, nonce=NONCE,
                               **w.P.kw)


def verify(P, proof, spec, mode, seed=9):
    cfg = None if mode == "none" else P.proof.VerifierConfig(mode == "lazy")
    return proof.verify(random.Random(seed), spec, nonce=NONCE, config=cfg,
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
            proof_r=prove(r, spec_r, wits_r, 20 + i),
            proof_t=prove(t, spec_t, wits_t, 20 + i))
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


@pytest.mark.parametrize("mode", ["none", "lazy", "eager"])
@pytest.mark.parametrize("name", NAMES)
def test_cross_verify(worlds, name, mode):
    W = worlds[2][name]
    assert verify(PORT, W.proof_t, W.spec_t, mode)
    assert verify(PORT, protocol_to_port(W.proof_r), W.spec_t, mode)
    assert verify(REF, to_ref(W.proof_t), W.spec_r, mode)


def test_kvac_key_holder(worlds):
    r, t, out = worlds
    for P, w, W in ((REF, r, out["kvac"]), (PORT, t, out["kvac"])):
        spec = W.spec_r if P is REF else W.spec_t
        proof = W.proof_r if P is REF else W.proof_t
        stmt = spec.statements[0]
        assert stmt.verify_with_key(proof.statement_proofs[0], w.mac_sk)
        other = P.kv.KVACSecretKey.generate(random.Random(3))
        assert not stmt.verify_with_key(proof.statement_proofs[0], other)


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_rejections(worlds, P):
    """A PS credential of another user id breaks the equality; a MAC
    checked by a full verifier under another key is refused."""
    w = worlds[0] if P is REF else worlds[1]
    F = P.b.Fr
    rng = random.Random(31)
    msgs2 = [F.rand(rng), w.ps_msgs[1], w.ps_msgs[2]]
    sig2 = P.ps.PSSignature.new(rng, msgs2, w.ps_sk, w.ps_params)
    spec, wits = build(w, "bbs_ps", ps_sig=sig2, ps_msgs=msgs2)
    proof = prove(w, spec, wits, 32)
    with pytest.raises(P.base.ProofSystemError, match="equality"):
        verify(P, proof, spec, "none")
    spec, wits = build(w, "kvac_full")
    proof = prove(w, spec, wits, 33)
    bad_spec, _ = build(w, "kvac_full",
                        mac_sk=P.kv.KVACSecretKey.generate(rng))
    with pytest.raises(P.base.ProofSystemError, match="keyed"):
        verify(P, proof, bad_spec, "none")


def test_lazy_checker_through_plain_kernels(worlds, monkeypatch):
    """The whole spec's 10 deferred pairs (BBS+, PS, BBS23 and the two KB
    statements) in one `TPairing.miller_product` on the CPU's plain
    kernels.  A proof made over a spoiled PS signature (sigma_2 moved by
    the generator) passes every Schnorr check, and is refused there."""
    from crypto_tpu_torch.curves import tpairing
    t, W = worlds[1], worlds[2]["all"]
    calls = []
    real = tpairing.TPairing.miller_product

    def counted(self, pairs):
        calls.append(len(pairs))
        return real(self, pairs)

    monkeypatch.setattr(tpairing.TPairing, "miller_product", counted)
    monkeypatch.setenv(ENV, "device")
    assert verify(PORT, W.proof_t, W.spec_t, "lazy")
    spoiled = PORT.ps.PSSignature(
        t.ps_sig.sigma_1, (t.ps_sig.sigma_2 + tb.G1.generator()).normalize())
    spec, wits = build(t, "all", ps_sig=spoiled)
    bad = prove(t, spec, wits, 34)
    with pytest.raises(PORT.base.ProofSystemError, match="pairing"):
        verify(PORT, bad, spec, "lazy")
    assert calls == [10, 10]
