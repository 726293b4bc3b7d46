"""The port's PS/Coconut signatures (`crypto_tpu_torch/coconut/`) against
the reference's (`crypto_tpu/coconut/{core,messages_pok}.py`), on the
shapes of the reference's `tests/test_coconut.py` and
`tests/test_coconut_blind_pok.py` (4 messages).

Both packages run from the same `random.Random` seed: params, keys,
signatures (random, deterministic, blind, threshold-aggregated from a
3-of-5 `threshold_keygen`), the signature PoK and the blind-request
`MessagesPoK` are equal as canonical integers; each package verifies the
other's; the port's verifications run on the CPU, its PoK also into a
lazy and an eager `RandomizedPairingChecker`, and its pairing products
without a checker go through `multi_pairings_routed`.  Wrong messages,
too few threshold shares, a wrong revealed value and a tampered
commitment are refused in both.
"""

import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import tpairing
from crypto_tpu_torch.testing import cap_threads
from test_torch_commitment_inequality import to_ref

cap_threads()

N = 4


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("ps", "coconut.core"), ("mpok", "coconut.messages_pok"),
        ("serialize", "serialize"), ("hashing", "hashing"),
        ("checkers", "utils.checkers"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def world(P, seed=88):
    rng = random.Random(seed)
    F = P.b.Fr
    params = P.ps.PSSignatureParams.new(b"ps-params", N)
    sk = P.ps.PSSecretKey.generate(rng, N)
    pk = P.ps.PSPublicKey.generate(sk, params)
    messages = [F.rand(rng) for _ in range(N)]
    sig = P.ps.PSSignature.new(rng, messages, sk, params)
    return dict(rng=rng, params=params, sk=sk, pk=pk, messages=messages,
                sig=sig)


@pytest.fixture(scope="module")
def worlds():
    return world(REF), world(PORT)


def public(w):
    return {k: v for k, v in w.items() if k != "rng"}


def test_keys_and_signature_parity(worlds):
    r, t = worlds
    assert canonical(public(t)) == canonical(public(r))
    assert canonical(protocol_to_port(public(r))) == canonical(public(t))
    assert t["sig"].verify(t["messages"], t["pk"], t["params"], device="cpu")
    assert r["sig"].verify(r["messages"], r["pk"], r["params"])
    sig_r = to_ref(t["sig"])
    assert sig_r.verify(r["messages"], r["pk"], r["params"])
    for P, w in ((REF, r), (PORT, t)):
        bad = list(w["messages"])
        bad[1] = bad[1] + P.b.Fr(1)
        assert not w["sig"].verify(bad, w["pk"], w["params"], **P.kw)
        assert not w["sig"].verify(w["messages"][:3], w["pk"], w["params"],
                                   **P.kw)


def test_deterministic_sign_parity(worlds):
    r, t = worlds
    s_r = REF.ps.PSSignature.new_deterministic(r["messages"], r["sk"])
    s_t = PORT.ps.PSSignature.new_deterministic(t["messages"], t["sk"])
    assert canonical(s_t) == canonical(s_r)
    assert s_t == PORT.ps.PSSignature.new_deterministic(t["messages"],
                                                        t["sk"])
    assert s_t.verify(t["messages"], t["pk"], t["params"], device="cpu")


def test_blind_issuance_parity(worlds):
    def blind(P, w, rng):
        hidden = {0, 2}
        h = P.b.G1.rand(rng).normalize()
        blindings = {j: P.b.Fr.rand(rng) for j in hidden}
        items = [P.ps.MessageCommitment.new(w["params"].g, blindings[i], h, m)
                 if i in hidden else m for i, m in enumerate(w["messages"])]
        blind_sig = P.ps.blind_sign(items, w["sk"], h)
        sig = P.ps.unblind(blind_sig, sorted(blindings.items()), w["pk"], h)
        with pytest.raises(P.ps.PSError):
            P.ps.unblind(blind_sig, [], w["pk"], w["params"].g)
        return items, sig

    r, t = worlds
    out_r, out_t = blind(REF, r, random.Random(3)), blind(PORT, t,
                                                          random.Random(3))
    assert canonical(out_t) == canonical(out_r)
    assert out_t[1].verify(t["messages"], t["pk"], t["params"], device="cpu")


def test_threshold_signing_parity(worlds):
    def threshold(P, w, rng):
        sks, tsk, tpk = P.ps.threshold_keygen(rng, 3, 5, N, w["params"])
        shares = [(i + 1, P.ps.PSSignature.new_deterministic(w["messages"],
                                                              sks[i]))
                  for i in (0, 2, 4)]
        agg = P.ps.aggregate_signatures(shares)
        few = P.ps.aggregate_signatures(shares[:2])
        return dict(sks=sks, tsk=tsk, tpk=tpk, agg=agg, few=few,
                    ok=agg.verify(w["messages"], tpk, w["params"], **P.kw),
                    few_ok=few.verify(w["messages"], tpk, w["params"],
                                      **P.kw))

    r, t = worlds
    out_r = threshold(REF, r, random.Random(4))
    out_t = threshold(PORT, t, random.Random(4))
    assert canonical(out_t) == canonical(out_r)
    assert out_t["ok"] and not out_t["few_ok"]
    # shares over different sigma_1 are refused
    with pytest.raises(PORT.ps.PSError):
        PORT.ps.aggregate_signatures([(1, out_t["agg"]), (2, t["sig"])])


def pok(P, w, seed, revealed=frozenset({1})):
    rng = random.Random(seed)
    prot = P.ps.PSSignaturePoKProtocol.init(rng, w["sig"], w["messages"],
                                            set(revealed), w["pk"],
                                            w["params"])
    wr = P.serialize.ByteWriter()
    prot.challenge_contribution(w["pk"], w["params"], wr)
    c = P.hashing.compute_random_oracle_challenge(P.b.Fr, wr.bytes())
    return prot, prot.gen_proof(c), c


def test_signature_pok_parity(worlds):
    r, t = worlds
    _, proof_r, c_r = pok(REF, r, 5)
    prot_t, proof_t, c_t = pok(PORT, t, 5)
    assert int(c_t) == int(c_r)
    assert canonical(proof_t) == canonical(proof_r)
    wr = PORT.serialize.ByteWriter()
    proof_t.challenge_contribution(t["pk"], t["params"], wr)
    assert PORT.hashing.compute_random_oracle_challenge(tb.Fr,
                                                        wr.bytes()) == c_t
    rev_t, rev_r = {1: t["messages"][1]}, {1: r["messages"][1]}
    assert proof_t.verify(c_t, rev_t, t["pk"], t["params"], device="cpu")
    assert to_ref(proof_t).verify(c_r, rev_r, r["pk"], r["params"])
    assert protocol_to_port(proof_r).verify(c_t, rev_t, t["pk"], t["params"],
                                            device="cpu")
    assert proof_t.response_for_message(0) == \
        proof_t.response.get_response(0)
    for P, w, proof, c in ((REF, r, proof_r, c_r), (PORT, t, proof_t, c_t)):
        assert not proof.verify(c, {1: w["messages"][1] + P.b.Fr(1)},
                                w["pk"], w["params"], **P.kw)
    # two shows of one credential are unlinkable
    assert pok(PORT, t, 6)[1].randomized.sigma_1 != \
        proof_t.randomized.sigma_1


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_signature_pok_into_checker(worlds, lazy):
    """The port's PoK defers its two pairs into a checker: valid, and a
    wrong revealed value fails the checker (the Schnorr check passes,
    since the revealed values are not in the transcript)."""
    _, t = worlds
    _, proof, c = pok(PORT, t, 7)
    for value, want in ((t["messages"][1], True),
                        (t["messages"][1] + tb.Fr(1), False)):
        chk = PORT.checkers.RandomizedPairingChecker(
            tb.Fr.rand(random.Random(8)), lazy=lazy, device="cpu")
        assert proof.verify(c, {1: value}, t["pk"], t["params"],
                            pairing_checker=chk, device="cpu")
        assert chk.verify() is want


def test_verify_pairs_through_router(worlds, monkeypatch):
    """Without a checker the signature's and the PoK's products go through
    `multi_pairings_routed` on the caller's device."""
    _, t = worlds
    from crypto_tpu_torch.coconut import core
    calls = []
    real = tpairing.multi_pairings_routed

    def spy(groups, device="cuda"):
        calls.append(([len(g) for g in groups], str(device)))
        return real(groups, device)

    monkeypatch.setattr(core, "multi_pairings_routed", spy)
    _, proof, c = pok(PORT, t, 9)
    assert t["sig"].verify(t["messages"], t["pk"], t["params"], device="cpu")
    assert proof.verify(c, {1: t["messages"][1]}, t["pk"], t["params"],
                        device="cpu")
    assert calls == [([2], "cpu"), ([2], "cpu")]


def test_blind_request_flow_parity(worlds):
    def flow(P, w, rng):
        hidden = {0, 2}
        prot = P.mpok.MessagesPoKProtocol.init(
            rng, {j: w["messages"][j] for j in hidden}, w["params"])
        wr = P.serialize.ByteWriter()
        prot.challenge_contribution(w["params"], wr)
        c = P.hashing.compute_random_oracle_challenge(P.b.Fr, wr.bytes())
        proof = prot.gen_proof(c)
        com_j, h, o_j = prot.commitments_for_signing()
        items = [com_j[i] if i in hidden else w["messages"][i]
                 for i in range(N)]
        sig = P.ps.unblind(P.ps.blind_sign(items, w["sk"], h),
                           sorted(o_j.items()), w["pk"], h)
        return dict(proof=proof, c=c, sig=sig,
                    ok=proof.verify(c, w["params"]),
                    sig_ok=sig.verify(w["messages"], w["pk"], w["params"],
                                      **P.kw))

    r, t = worlds
    out_r = flow(REF, r, random.Random(10))
    out_t = flow(PORT, t, random.Random(10))
    assert canonical(out_t) == canonical(out_r)
    assert out_t["ok"] and out_t["sig_ok"]
    assert to_ref(out_t["proof"]).verify(out_r["c"], r["params"])
    for P, out, w in ((REF, out_r, r), (PORT, out_t, t)):
        bad = out["proof"]
        bad.com_j[0] = P.ps.MessageCommitment(
            (bad.com_j[0].com + w["params"].g).normalize())
        assert not bad.verify(out["c"], w["params"])
