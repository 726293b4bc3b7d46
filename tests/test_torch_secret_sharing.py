"""The port's secret sharing (`crypto_tpu_torch/secret_sharing/`) against
the reference's (`crypto_tpu/secret_sharing/{common,schemes}.py`), on the
shapes of the reference's `tests/test_secret_sharing.py` and
`tests/test_ss_extra.py`'s shares accumulator.

Each test runs both packages from the same `random.Random` seed: the
shares, polynomial coefficients, coefficient commitments, Lagrange
bases, DKG results and accumulated shares are equal as canonical
integers, and the rejections (bad parameters, tampered shares, a
malicious dealer, x = 0) hold in both.
"""

import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.secret_sharing.{n}")
            for n in ("common", "schemes")}
    mods["b"] = jb if root == "crypto_tpu" else tb
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])


def both(fn, seed):
    """fn(pkg, rng) in each package from the same seed; the two results as
    canonical forms, asserted equal, and the port's result."""
    r = fn(REF, random.Random(seed))
    t = fn(PORT, random.Random(seed))
    assert canonical(t) == canonical(r)
    return r, t


def test_shamir_parity():
    def deal(P, rng):
        secret, shares, coeffs = P.schemes.shamir_deal_random_secret(rng, 3,
                                                                     5)
        S = P.common.Shares
        return dict(secret=secret, shares=shares, coeffs=coeffs,
                    any3=P.schemes.reconstruct_secret(S(shares.shares[1:4])),
                    two=P.schemes.reconstruct_secret(S(shares.shares[:2])))

    r, t = both(deal, 55)
    assert t["coeffs"][0] == t["secret"] == t["any3"] != t["two"]
    assert canonical(protocol_to_port(r["shares"])) == canonical(t["shares"])


@BOTH
def test_shamir_invalid_params(P):
    F = P.b.Fr
    for thr, total in ((6, 5), (1, 1), (0, 3)):
        with pytest.raises(P.common.SSError):
            P.schemes.shamir_deal_secret(random.Random(1), F(1), thr, total)


def test_lagrange_basis_parity():
    ids = [1, 3, 4, 7]
    r = REF.common.lagrange_basis_at_0_for_all(ids)
    t = PORT.common.lagrange_basis_at_0_for_all(ids)
    assert [int(x) for x in t] == [int(x) for x in r]
    # sum_i l_i(0) f(i) = f(0) for a constant polynomial
    assert int(sum(t, tb.Fr(0))) == 1
    for P in (REF, PORT):
        with pytest.raises(P.common.SSError):
            P.common.lagrange_basis_at_0([0, 2], 2)


def test_feldman_vss_parity():
    def deal(P, rng):
        g = P.b.G1.generator()
        secret = P.b.Fr.rand(rng)
        shares, comms = P.schemes.feldman_deal_secret(rng, secret, 3, 5, g)
        bad = P.common.Share(shares.shares[0].id, 3,
                             shares.shares[0].share + P.b.Fr(1))
        return dict(
            shares=shares, comms=comms,
            ok=[P.schemes.feldman_verify_share(s, comms, g)
                for s in shares.shares],
            bad=P.schemes.feldman_verify_share(bad, comms, g),
            rec=P.schemes.reconstruct_secret(
                P.common.Shares(shares.shares[:3])) == secret,
            c0=comms.commitment_to_secret() == (g * int(secret)).normalize())

    _, t = both(deal, 56)
    assert t["ok"] == [True] * 5 and not t["bad"] and t["rec"] and t["c0"]


def test_pedersen_vss_parity():
    def deal(P, rng):
        g = P.b.G1.generator()
        h = (g * 7).normalize()
        secret = P.b.Fr.rand(rng)
        shares, comms, blinding = P.schemes.pedersen_deal_secret(
            rng, secret, 3, 5, g, h)
        bad = P.schemes.PedersenVSSShare(shares[0].id, 3,
                                         shares[0].share + P.b.Fr(1),
                                         shares[0].blinding_share)
        sub = P.common.Shares([P.common.Share(s.id, 3, s.share)
                               for s in shares[:3]])
        return dict(shares=shares, comms=comms, blinding=blinding,
                    ok=[P.schemes.pedersen_verify_share(s, comms, g, h)
                        for s in shares],
                    bad=P.schemes.pedersen_verify_share(bad, comms, g, h),
                    rec=P.schemes.reconstruct_secret(sub) == secret)

    _, t = both(deal, 57)
    assert t["ok"] == [True] * 5 and not t["bad"] and t["rec"]


def test_feldman_dkg_parity():
    def dkg(P, rng):
        g = P.b.G1.generator()
        n, thr = 4, 3
        parts = [P.schemes.FeldmanDKGParticipant(i, thr, n)
                 for i in range(1, n + 1)]
        dealt = {pt.id: pt.deal(rng, g) for pt in parts}
        for dealer in parts:
            shares, comms = dealt[dealer.id]
            for recv in parts:
                if recv.id != dealer.id:
                    recv.receive(dealer.id, shares.shares[recv.id - 1],
                                 comms, g)
        results = [pt.finish() for pt in parts]
        sk = P.schemes.reconstruct_secret(P.common.Shares(
            [P.common.Share(pt.id, thr, res[0])
             for pt, res in zip(parts, results)][:thr]))
        # a malicious dealer's share, addressed right but off its
        # commitments, is refused
        evil_shares, evil_comms = dealt[1]
        bad = P.common.Share(parts[2].id, thr,
                             evil_shares.shares[2].share + P.b.Fr(1))
        with pytest.raises(P.common.SSError, match="invalid share"):
            parts[2].receive(99, bad, evil_comms, g)
        return dict(results=results,
                    pk_ok=(g * int(sk)).normalize() == results[0][1])

    _, t = both(dkg, 58)
    assert t["pk_ok"] and len({str(r[1].to_affine())
                               for r in t["results"]}) == 1


def test_shares_accumulator_parity():
    def dvss(P, rng):
        g = P.b.G1.generator()
        thr, total = 3, 5
        accs = {i: P.common.SharesAccumulator(participant_id=i,
                                              threshold=thr)
                for i in range(1, total + 1)}
        secrets = []
        for dealer in range(1, total + 1):
            secrets.append(P.b.Fr.rand(rng))
            shares, comms = P.schemes.feldman_deal_secret(
                rng, secrets[-1], thr, total, g)
            for i in range(1, total + 1):
                sh = shares.shares[i - 1]
                if i == dealer:
                    accs[i].add_self_share(sh, comms)
                else:
                    accs[i].add_received_share(dealer, sh, comms, g)
        with pytest.raises(P.common.SSError, match="already"):
            accs[1].add_received_share(2, shares.shares[0], comms, g)
        finals = {i: accs[i].finalize() for i in accs}
        pks = [(i, (g * int(finals[i][0].share)).normalize())
               for i in (1, 3, 5)]
        total_secret = sum(secrets, P.b.Fr(0))
        tpk = finals[1][1]
        return dict(finals=finals,
                    tpk_ok=tpk == (g * int(total_secret)).normalize(),
                    rec=P.common.reconstruct_threshold_public_key(pks, 3)
                    == tpk)

    _, t = both(dvss, 59)
    assert t["tpk_ok"] and t["rec"]


@BOTH
def test_pedersen_share_into_accumulator_raises(P):
    """The reference's `SharesAccumulator.add_received_share` calls
    `pedersen_verify_share` with the key as one argument, which takes g
    and h apart, so a Pedersen share raises TypeError; the port mirrors
    it (ROADMAP Queue 3)."""
    rng = random.Random(60)
    g = P.b.G1.generator()
    h = (g * 7).normalize()
    shares, comms, _ = P.schemes.pedersen_deal_secret(rng, P.b.Fr(5), 2, 3,
                                                      g, h)
    acc = P.common.SharesAccumulator(participant_id=2, threshold=2)
    with pytest.raises(TypeError):
        acc.add_received_share(1, shares[1], comms, (g, h))
