"""The port's BBDT16 keyed-verification credentials
(`crypto_tpu_torch/kvac/{bbdt16,keyed_proof}.py`) against the reference's
(`crypto_tpu/kvac/`), on the shapes of the reference's
`tests/test_kvac.py` (4 messages).

Both packages run from the same `random.Random` seed: params, keys,
MACs (direct and blind), the MAC's proof of validity, the PoK of a MAC
(CDH and the original show), the keyed proof's proofs of validity and
invalidity and the public verification key are equal as canonical
integers; each package verifies the other's proofs, and the rejections
of the reference's tests (a wrong message, another key, a wrong revealed
value, a valid keyed proof whose invalidity cannot be proved) hold in
both.  The public verification key's pairing product runs through
`multi_pairings_routed` on the CPU.
"""

import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads
from test_torch_commitment_inequality import to_ref

cap_threads()

N = 4


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("kv", "kvac.bbdt16"), ("kp", "kvac.keyed_proof"),
        ("proof", "bbs_plus.proof"), ("serialize", "serialize"),
        ("hashing", "hashing"), ("msm", "utils.msm"),
        ("ineq", "schnorr.inequality"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def world(P, seed=303):
    rng = random.Random(seed)
    params = P.kv.MACParams.new(b"kvac-params", N)
    sk = P.kv.KVACSecretKey.generate(rng)
    pk = P.kv.KVACPublicKey.generate(sk, params)
    messages = [P.b.Fr.rand(rng) for _ in range(N)]
    mac = P.kv.MAC.new(rng, messages, sk, params)
    return dict(params=params, sk=sk, pk=pk, messages=messages, mac=mac)


@pytest.fixture(scope="module")
def worlds():
    return world(REF), world(PORT)


def run_both(fn, worlds, seed):
    r, t = worlds
    out_r = fn(REF, r, random.Random(seed))
    out_t = fn(PORT, t, random.Random(seed))
    assert canonical(out_t) == canonical(out_r)
    return out_r, out_t


def test_mac_parity(worlds):
    r, t = worlds
    assert canonical(t) == canonical(r)
    assert canonical(protocol_to_port(r)) == canonical(t)
    for P, w in ((REF, r), (PORT, t)):
        assert w["mac"].verify(w["messages"], w["sk"], w["params"])
        bad = list(w["messages"])
        bad[0] = bad[0] + P.b.Fr(1)
        assert not w["mac"].verify(bad, w["sk"], w["params"])
        with pytest.raises(P.kv.KVACError):
            w["mac"].verify(bad[:2], w["sk"], w["params"])


def test_proof_of_validity_parity(worlds):
    def validity(P, w, rng):
        pov = P.kv.ProofOfValidityOfMAC.new(rng, w["mac"], w["sk"], w["pk"],
                                            w["params"])
        other = P.kv.KVACPublicKey.generate(P.kv.KVACSecretKey.generate(rng),
                                            w["params"])
        return dict(pov=pov, ok=pov.verify(w["mac"], w["messages"], w["pk"],
                                           w["params"]),
                    other=pov.verify(w["mac"], w["messages"], other,
                                     w["params"]))

    out_r, out_t = run_both(validity, worlds, 1)
    assert out_t["ok"] and not out_t["other"]
    r = worlds[0]
    assert to_ref(out_t["pov"]).verify(r["mac"], r["messages"], r["pk"],
                                       r["params"])


def test_blind_issuance_parity(worlds):
    def blind(P, w, rng):
        hidden = [1, 3]
        blinding = P.b.Fr.rand(rng)
        commitment = P.msm.msm(
            [w["params"].g] + [w["params"].g_vec[i] for i in hidden],
            [blinding] + [w["messages"][i] for i in hidden]).normalize()
        uncommitted = {i: m for i, m in enumerate(w["messages"])
                       if i not in hidden}
        mac = P.kv.MAC.new_with_committed_messages(
            rng, commitment, uncommitted, w["sk"], w["params"]).unblind(
                blinding)
        return dict(mac=mac, ok=mac.verify(w["messages"], w["sk"],
                                           w["params"]))

    _, out_t = run_both(blind, worlds, 2)
    assert out_t["ok"]


def pok(P, w, rng, revealed_ids=(0,)):
    mabs = [P.proof.MessageOrBlinding.reveal_message(m) if i in revealed_ids
            else P.proof.MessageOrBlinding.blind_randomly(m)
            for i, m in enumerate(w["messages"])]
    prot = P.kv.PoKOfMACProtocol.init(rng, w["mac"], w["params"], mabs)
    revealed = {i: w["messages"][i] for i in revealed_ids}
    wr = P.serialize.ByteWriter()
    prot.challenge_contribution(revealed, w["params"], wr)
    c = P.hashing.compute_random_oracle_challenge(P.b.Fr, wr.bytes())
    return revealed, prot.gen_proof(c), c


def test_pok_of_mac_parity(worlds):
    def show(P, w, rng):
        revealed, proof, c = pok(P, w, rng)
        other = P.kv.KVACSecretKey.generate(rng)
        return dict(proof=proof, c=c,
                    ok=proof.verify(revealed, c, w["sk"], w["params"]),
                    other=proof.verify(revealed, c, other, w["params"]),
                    wrong=proof.verify({0: w["messages"][0] + P.b.Fr(1)}, c,
                                       w["sk"], w["params"]),
                    resp=proof.get_resp_for_message(2, {0}),
                    keyed=proof.to_keyed_proof())

    out_r, out_t = run_both(show, worlds, 3)
    assert out_t["ok"] and not out_t["other"] and not out_t["wrong"]
    r, t = worlds
    assert to_ref(out_t["proof"]).verify({0: r["messages"][0]}, out_r["c"],
                                         r["sk"], r["params"])
    assert protocol_to_port(out_r["proof"]).verify(
        {0: t["messages"][0]}, out_t["c"], t["sk"], t["params"])
    assert out_t["keyed"].verify(t["sk"].x)
    with pytest.raises(PORT.kv.KVACError):
        out_t["proof"].get_resp_for_message(0, {0})


def test_keyed_proof_validity_invalidity_parity():
    def keyed(P, _, rng):
        params = P.kv.MACParams.new(b"kp-test", 2)
        sk = P.kv.KVACSecretKey.generate(rng)
        B_0 = (P.b.G1.generator() * 12345).normalize()
        good = P.kp.KeyedProof(B_0=B_0, C=(B_0 * int(sk.x)).normalize())
        bad = P.kp.KeyedProof(B_0=B_0, C=(B_0 * 999).normalize())
        pvk = P.kp.PublicVerificationKey.new(b"kp-pvk", sk.x)
        pk = (params.g * int(sk.x)).normalize()
        pov = good.create_proof_of_validity(rng, sk.x, pk, params.g)
        poi = bad.create_proof_of_invalidity(rng, sk.x, pk, params.g)
        with pytest.raises(P.ineq.InequalityError):
            good.create_proof_of_invalidity(rng, sk.x, pk, params.g)
        return dict(
            pvk=pvk, pov=pov, poi=poi,
            checks=[good.verify(sk.x), bad.verify(sk.x),
                    good.verify_with_public_verification_key(pvk, **P.kw),
                    bad.verify_with_public_verification_key(pvk, **P.kw),
                    pov.verify(good, pk, params.g),
                    pov.verify(bad, pk, params.g),
                    poi.verify(bad, pk, params.g),
                    poi.verify(good, pk, params.g)])

    out_r, out_t = run_both(keyed, (None, None), 4)
    assert out_t["checks"] == [True, False] * 4


def test_to_keyed_proof_validity_parity(worlds):
    def delegated(P, w, rng):
        _, proof, _ = pok(P, w, rng, revealed_ids=())
        kp = proof.to_keyed_proof()
        g, x = w["params"].g, w["sk"].x
        pk = (g * int(x)).normalize()
        pov = kp.create_proof_of_validity(rng, x, pk, g)
        return dict(kp=kp, pov=pov, ok=kp.verify(x) and pov.verify(kp, pk, g))

    _, out_t = run_both(delegated, worlds, 5)
    assert out_t["ok"]


def test_original_show_parity(worlds):
    def show(P, w, rng):
        f = P.hashing.group_elem_from_try_and_incr(
            P.b.G1, b"pseudonym-base").normalize()
        revealed = {1: w["messages"][1]}
        mabs = [P.proof.MessageOrBlinding.reveal_message(m) if i in revealed
                else P.proof.MessageOrBlinding.blind_randomly(m)
                for i, m in enumerate(w["messages"])]
        prot = P.kv.PoKOfMACOriginalProtocol.init(rng, w["mac"], w["params"],
                                                  mabs, f)
        wr = P.serialize.ByteWriter()
        prot.challenge_contribution(revealed, w["params"], f, wr)
        c = P.hashing.compute_random_oracle_challenge(P.b.Fr, wr.bytes())
        proof = prot.gen_proof(c)
        wr2 = P.serialize.ByteWriter()
        proof.challenge_contribution(revealed, w["params"], f, wr2)
        other = P.kv.KVACSecretKey.generate(rng)
        return dict(
            proof=proof, same=wr2.bytes() == wr.bytes(),
            checks=[proof.verify_schnorr(revealed, c, w["params"], f),
                    proof.verify(revealed, c, w["sk"], w["params"], f),
                    proof.to_keyed_proof().verify(w["sk"].x),
                    proof.verify_schnorr({1: w["messages"][1] + P.b.Fr(1)},
                                         c, w["params"], f),
                    proof.verify(revealed, c, other, w["params"], f)])

    _, out_t = run_both(show, worlds, 6)
    assert out_t["same"] and out_t["checks"] == [True] * 3 + [False] * 2
