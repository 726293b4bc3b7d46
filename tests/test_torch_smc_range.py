"""The port's set-membership range proofs (`crypto_tpu_torch/
smc_range_proof/`: CCS set membership and perfect range, the CCS
arbitrary range and CLS sumset range, the keyed-verification and CDH
variants, the batch, CDH and KV single-member proofs) against the
reference's (`crypto_tpu/smc_range_proof/`), after the reference's
`tests/test_smc_range.py`, at bases 2-5 and 4-10 digits.

Each world is made in both packages from the same `random.Random` seed:
the params, challenge contributions (the GT values' bytes among them)
and proofs are equal byte for byte and integer for integer, each
package verifies the other's proof, with no checker and with a lazy
`RandomizedPairingChecker`, and another commitment, other bounds, a
spoiled digit response and another secret key are refused by both.  The
port's pairings run on the CPU: its routed calls on the host route, and
one lazy checker of 8 deferred pairs through `TPairing`'s plain
kernels.  The reference's checker pairs on the host
(`CRYPTO_TPU_PAIRING_BACKEND=host`).
"""

import dataclasses
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

ENV = "CRYPTO_TPU_PAIRING_BACKEND"


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("ccs", "smc_range_proof.ccs"), ("extra", "smc_range_proof.ranges_extra"),
        ("kv", "smc_range_proof.kv"), ("cdh", "smc_range_proof.cdh"),
        ("sm", "smc_range_proof.set_membership"),
        ("wbb", "short_group_sig.weak_bb"), ("serialize", "serialize"),
        ("hashing", "hashing"), ("checkers", "utils.checkers"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["dev"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def _params(P, rng, kind, base):
    if kind == "kv":
        return P.kv.SetMembershipCheckParamsKV.new_for_range_proof(
            rng, b"smc-kv", base)
    return P.ccs.SetMembershipCheckParams.new_for_range_proof(rng, b"smc",
                                                              base)


# case -> (params kind, base, value, bounds: (max,) or (min, max))
RANGES = {
    "perfect": ("pub", 4, 157, (4 ** 4,)),
    "ccs_arbitrary": ("pub", 4, 513, (100, 1000)),
    "cls": ("pub", 5, 7777, (1000, 20000)),
    "kv_perfect": ("kv", 4, 37, (4 ** 3,)),
    "kv_arbitrary": ("kv", 2, 137, (10, 200)),
    "cdh_perfect": ("pub", 4, 37, (256,)),
    "cdh_arbitrary": ("pub", 3, 37, (18, 100)),
    "cls_cdh": ("pub", 4, 37, (18, 100)),
    "cls_kv": ("kv", 4, 37, (18, 100)),
}


def _protocol(P, case):
    return {"perfect": P.ccs.CCSPerfectRangeProtocol,
            "ccs_arbitrary": P.extra.CCSArbitraryRangeProtocol,
            "cls": P.extra.CLSRangeProtocol,
            "kv_perfect": P.kv.CCSPerfectRangeKVProtocol,
            "kv_arbitrary": P.kv.CCSArbitraryRangeKVProtocol,
            "cdh_perfect": P.cdh.CCSPerfectRangeCDHProtocol,
            "cdh_arbitrary": P.cdh.CCSArbitraryRangeCDHProtocol,
            "cls_cdh": P.cdh.CLSRangeCDHProtocol,
            "cls_kv": P.cdh.CLSRangeCDHProtocol}[case]


def _pairing_free(case):
    return case.startswith(("kv", "cdh", "cls_"))


def range_world(P, case, seed=707, value=None):
    kind, base, val, bounds = RANGES[case]
    val = val if value is None else value
    rng = random.Random(seed)
    F = P.b.Fr
    params = _params(P, rng, kind, base)
    ck = P.ccs.MemberCommitmentKey.new(b"smc-ck")
    r = F.rand(rng)
    comm = ck.commit(F(val), r)
    kw = {"kv": True} if case == "cls_kv" else \
        ({} if _pairing_free(case) else P.dev)
    prot = _protocol(P, case).init(rng, val, r, *bounds, base, ck, params,
                                   **kw)
    w = P.serialize.ByteWriter()
    prot.challenge_contribution(comm, ck, params, w)
    c = P.hashing.compute_random_oracle_challenge(F, w.bytes())
    proof = prot.gen_proof(c)
    w2 = P.serialize.ByteWriter()
    proof.challenge_contribution(comm, ck, params, w2)
    assert w2.bytes() == w.bytes()
    return dict(P=P, case=case, params=params, ck=ck, r=r, comm=comm,
                bounds=bounds, contrib=w.bytes(), c=c, proof=proof)


def verify_range(w, proof=None, comm=None, bounds=None, checker=None,
                 sk=None):
    P, case = w["P"], w["case"]
    proof = w["proof"] if proof is None else proof
    args = (w["comm"] if comm is None else comm, w["c"],
            *(w["bounds"] if bounds is None else bounds), w["ck"],
            w["params"])
    if RANGES[case][0] == "kv":
        return proof.verify(*args, w["params"].sk if sk is None else sk)
    return proof.verify(*args, checker, **P.dev)


@pytest.mark.parametrize("case", sorted(RANGES))
def test_range_parity(case, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    ref, port = range_world(REF, case), range_world(PORT, case)
    assert canonical(ref["params"]) == canonical(port["params"])
    assert ref["contrib"] == port["contrib"]
    assert canonical(ref["proof"]) == canonical(port["proof"])
    assert verify_range(port)
    # each package verifies the other's proof
    assert verify_range(port, protocol_to_port(ref["proof"]))
    assert verify_range(ref, to_ref(port["proof"]))


def _spoil_digit(proof):
    """The proof with its first digit's response (z_v, or a PoK's
    message response) off by one."""
    for name in ("z_v", "z_v_min"):
        if hasattr(proof, name):
            zs = list(getattr(proof, name))
            zs[0] = zs[0] + zs[0].f(1)
            return dataclasses.replace(proof, **{name: zs})
    key = "pok_sigs" if hasattr(proof, "pok_sigs") else "pok_sigs_min"
    poks = list(getattr(proof, key))
    sc = poks[0].sc
    poks[0] = dataclasses.replace(poks[0], sc=dataclasses.replace(
        sc, response1=sc.response1 + sc.response1.f(1)))
    return dataclasses.replace(proof, **{key: poks})


@pytest.mark.parametrize("case,spoil", [
    (case, spoil) for case in ("perfect", "ccs_arbitrary", "cls",
                               "kv_arbitrary", "cdh_arbitrary", "cls_kv")
    for spoil in ("commitment", "bounds", "digit", "secret_key")
    if spoil != "secret_key" or RANGES[case][0] == "kv"])
def test_range_refused(case, spoil, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    kind, _, val, bounds = RANGES[case]
    for P in (REF, PORT):
        w = range_world(P, case, seed=708)
        F = P.b.Fr
        if spoil == "commitment":
            ok = verify_range(w, comm=w["ck"].commit(F(val + 1), w["r"]))
        elif spoil == "bounds":
            nb = (bounds[0] * 4,) if len(bounds) == 1 else \
                (val + 1, bounds[1])
            ok = verify_range(w, bounds=nb)
        elif spoil == "digit":
            ok = verify_range(w, proof=_spoil_digit(w["proof"]))
        else:
            ok = verify_range(w, sk=P.wbb.WeakBBSecretKey.generate(
                random.Random(3)))
        assert not ok


@pytest.mark.parametrize("case", ["perfect", "cls", "cdh_perfect",
                                  "cls_cdh"])
def test_range_checker(case, monkeypatch):
    """Both packages' lazy checkers accept the other's proof and refuse
    their own with a spoiled digit (host pairings)."""
    monkeypatch.setenv(ENV, "host")
    ref, port = range_world(REF, case), range_world(PORT, case)
    for w, proof, spoiled in ((ref, to_ref(port["proof"]), False),
                              (port, protocol_to_port(ref["proof"]), False),
                              (ref, ref["proof"], True),
                              (port, port["proof"], True)):
        P = w["P"]
        chk = P.checkers.RandomizedPairingChecker(
            P.b.Fr.rand(random.Random(5)), lazy=True, **P.dev)
        pr = _spoil_digit(proof) if spoiled else proof
        ok = verify_range(w, proof=pr, checker=chk) and chk.verify()
        assert ok is not spoiled


def test_range_checker_plain_kernels(monkeypatch):
    """The port's lazy checker through `TPairing`'s plain kernels: the
    perfect range's 4 digits defer 8 pairs (two a digit), the checker's
    `DEVICE_THRESHOLD`; valid and with one digit spoiled, one device
    Miller product each."""
    monkeypatch.delenv(ENV, raising=False)
    w = range_world(PORT, "perfect")
    calls = []
    real = tpairing.TPairing.miller_product

    def spy(self, pairs):
        calls.append(len(pairs))
        return real(self, pairs)

    monkeypatch.setattr(tpairing.TPairing, "miller_product", spy)
    for proof, want in ((w["proof"], True),
                        (_spoil_digit(w["proof"]), False)):
        chk = PORT.checkers.RandomizedPairingChecker(
            tb.Fr.rand(random.Random(6)), lazy=True, device="cpu")
        assert verify_range(w, proof=proof, checker=chk)
        assert chk.verify() is want
    assert calls == [8, 8]


def test_routed_calls(monkeypatch):
    """The port's prover sends every digit's a (one pair each) in one
    routed call, and its verifier every digit's two pairs in one, each
    group's product held to its digit's a: here through a host stand-in
    of `TPairing.multi_pairings` with the router's threshold at 0."""
    calls = []

    def stand_in(self, groups):
        calls.append([len(g) for g in groups])
        return [tb.multi_pairing(g) for g in groups]

    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(tpairing, "PAIRING_BATCH_THRESHOLD", 0)
    monkeypatch.setattr(tpairing.TPairing, "multi_pairings", stand_in)
    port = range_world(PORT, "ccs_arbitrary")
    assert verify_range(port)
    assert not verify_range(port, proof=_spoil_digit(port["proof"]))
    assert calls == [[1] * 10, [2] * 10, [2] * 10]
    monkeypatch.setenv(ENV, "host")
    ref = range_world(REF, "ccs_arbitrary")
    assert canonical(ref["proof"]) == canonical(port["proof"])


def test_out_of_range_refused():
    for P in (REF, PORT):
        w = None
        for case, value in (("perfect", 4 ** 4), ("ccs_arbitrary", 99),
                            ("ccs_arbitrary", 1000), ("cls", 20000),
                            ("kv_arbitrary", 9), ("cdh_arbitrary", 100),
                            ("cls_kv", 17)):
            with pytest.raises(P.ccs.SmcError):
                w = range_world(P, case, value=value)
        assert w is None


def member_world(P, kind, seed=31):
    rng = random.Random(seed)
    F = P.b.Fr
    members = [F.rand(rng) for _ in range(6)]
    ck = P.ccs.MemberCommitmentKey.new(b"sm-ck")
    if kind == "kv":
        params = P.kv.SetMembershipCheckParamsKV.new(rng, b"sm-kv", members)
    else:
        params = P.ccs.SetMembershipCheckParams.new(rng, b"sm-params",
                                                    members)
    w = P.serialize.ByteWriter()
    if kind == "batch":
        batch = [members[0], members[3], members[3]]
        r = [F.rand(rng) for _ in batch]
        comm = [ck.commit(m, ri) for m, ri in zip(batch, r)]
        prot = P.sm.SetMembershipBatchCheckProtocol.init(rng, batch, r, ck,
                                                         params, **P.dev)
    else:
        member, r = members[2], F.rand(rng)
        comm = ck.commit(member, r)
        if kind == "single":
            prot = P.ccs.SetMembershipProtocol.init(rng, member, r, ck,
                                                    params, **P.dev)
        else:
            prot = {"cdh": P.sm.SetMembershipCheckCDHProtocol,
                    "kv": P.sm.SetMembershipCheckWithKVProtocol}[kind] \
                .init(rng, member, r, ck, params)
    prot.challenge_contribution(comm, ck, params, w)
    c = P.hashing.compute_random_oracle_challenge(F, w.bytes())
    return dict(P=P, kind=kind, params=params, ck=ck, comm=comm,
                contrib=w.bytes(), c=c, proof=prot.gen_proof(c))


def verify_member(w, proof=None, comm=None, sk=None):
    P = w["P"]
    proof = w["proof"] if proof is None else proof
    args = (w["comm"] if comm is None else comm, w["c"], w["ck"],
            w["params"])
    if w["kind"] == "kv":
        return proof.verify(*args, w["params"].sk if sk is None else sk)
    if w["kind"] == "cdh":
        return proof.verify(*args)
    return proof.verify(*args, **P.dev)


@pytest.mark.parametrize("kind", ["single", "batch", "cdh", "kv"])
def test_set_membership_parity(kind, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    ref, port = member_world(REF, kind), member_world(PORT, kind)
    assert canonical(ref["params"]) == canonical(port["params"])
    assert ref["contrib"] == port["contrib"]
    assert canonical(ref["proof"]) == canonical(port["proof"])
    assert verify_member(port)
    assert verify_member(port, protocol_to_port(ref["proof"]))
    assert verify_member(ref, to_ref(port["proof"]))
    for w in (ref, port):
        P, F = w["P"], w["P"].b.Fr
        if kind == "batch":
            other = list(reversed(w["comm"]))
        else:
            other = w["ck"].commit(F(5), F(6))
        assert not verify_member(w, comm=other)
        if kind == "kv":
            assert not verify_member(
                w, sk=P.wbb.WeakBBSecretKey.generate(random.Random(4)))
