"""Threshold weak-BB issuance (`short_group_sig/threshold_weak_bb.py`) and
the threshold accumulator managers (`accumulator/threshold.py`) against
the reference's and against the values the full key gives.

Each pairwise multiplication of the shared inverse runs a base-OT phase
of 128 OTs (~512 host scalar multiplications; ~6 s in the reference).
The cases compared with the reference share the base OTs of one
reference run (`setup_ote_pair` patched in both packages to return that
pair), so only the OT extension, the Gilboa products and the openings
run per case, under the same seeds on both sides.  One case runs the
port's own base OTs at 2-of-3.
"""

import random

import numpy as np
import pytest

from crypto_tpu.accumulator import core as r_core
from crypto_tpu.accumulator import persistence as r_pers
from crypto_tpu.accumulator import setup as r_setup
from crypto_tpu.accumulator import threshold as r_thr
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.ot import ot_extension as r_ote
from crypto_tpu.secret_sharing import schemes as r_ss
from crypto_tpu.short_group_sig import threshold_weak_bb as r_twbb
from crypto_tpu.short_group_sig import weak_bb as r_wbb
from crypto_tpu_torch.accumulator import core as p_core
from crypto_tpu_torch.accumulator import persistence as p_pers
from crypto_tpu_torch.accumulator import setup as p_setup
from crypto_tpu_torch.accumulator import threshold as p_thr
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.hashing import group_elem_from_try_and_incr
from crypto_tpu_torch.ot import ot_extension as p_ote
from crypto_tpu_torch.secret_sharing import schemes as p_ss
from crypto_tpu_torch.short_group_sig import threshold_weak_bb as p_twbb
from crypto_tpu_torch.short_group_sig import weak_bb as p_wbb
from crypto_tpu_torch.testing import cap_threads

cap_threads()

F = tb.Fr


def affine(P) -> tuple:
    P = P.normalize()
    return None if P.is_infinity() else (int(P.X), int(P.Y))


@pytest.fixture(scope="module")
def shared_pair():
    """One reference base-OT phase (128 OTs), as each package's objects."""
    rs, rr = r_ote.setup_ote_pair(random.Random(77), jb.G1.generator())
    return ((rs, rr), (p_ote.OTESender.from_base(rs.s_bits, rs.seeds),
                       p_ote.OTEReceiver(list(rr.seed_pairs))))


@pytest.fixture
def shared_base_ots(shared_pair, monkeypatch):
    """Both packages' `setup_ote_pair`, as the shared inverse calls it,
    return the shared pair and draw nothing."""
    (rs, rr), (ps, pr) = shared_pair
    monkeypatch.setattr(r_twbb, "setup_ote_pair", lambda rng, g: (rs, rr))
    monkeypatch.setattr(p_twbb, "setup_ote_pair", lambda rng, g: (ps, pr))


def weak_bb_world(t: int, n: int, signer_ids, seed: int):
    """Each package's (g1, key, shares, message) from the same seed."""
    out = {}
    for name, b, wbb, ss in (("ref", jb, r_wbb, r_ss),
                             ("port", tb, p_wbb, p_ss)):
        rng = random.Random(seed)
        sk = wbb.WeakBBSecretKey.generate(rng)
        shares, _ = ss.shamir_deal_secret(rng, sk.x, t, n)
        out[name] = dict(
            sk=sk, rng=rng, message=b.Fr.rand(rng),
            shares={s.id: s.share for s in shares.shares
                    if s.id in signer_ids})
    return out


def run_weak_bb(world: dict, signer_ids, g1_label: bytes) -> dict:
    """Each package's threshold signature A, from its own signers."""
    from crypto_tpu.hashing import group_elem_from_try_and_incr as r_hash
    out = {}
    for name, twbb, b, hash_ in (("ref", r_twbb, jb, r_hash),
                                 ("port", p_twbb, tb,
                                  group_elem_from_try_and_incr)):
        w = world[name]
        g1 = hash_(b.G1, g1_label).normalize()
        signers = {i: twbb.ThresholdWeakBBSigner.init(
            w["rng"], i, w["shares"][i], list(signer_ids))
            for i in signer_ids}
        sig = twbb.run_threshold_weak_bb(w["rng"], signers, w["message"], g1)
        out[name] = (sig, g1, signers)
    return out


@pytest.mark.parametrize("t,n,signer_ids", [(2, 3, (1, 3)),
                                            (3, 5, (1, 2, 5))])
def test_threshold_weak_bb_vs_reference_and_full_key(shared_base_ots, t, n,
                                                     signer_ids):
    """The same signature as the reference from the same seed, equal to
    g1 * 1/(e + x) from the dealt key."""
    world = weak_bb_world(t, n, signer_ids, 600 + n)
    runs = run_weak_bb(world, signer_ids, b"twbb-g1")
    (ref_sig, _, ref_signers), (sig, g1, signers) = runs["ref"], \
        runs["port"]
    assert affine(sig.A) == affine(ref_sig.A)
    assert [(int(s.r), int(s.lx)) for s in signers.values()] == \
        [(int(s.r), int(s.lx)) for s in ref_signers.values()]
    w = world["port"]
    full = p_wbb.WeakBBSig.new(w["message"], w["sk"], g1)
    assert affine(sig.A) == affine(full.A)
    assert sig.A.Z.is_one()


def test_shared_inverse_with_the_ports_own_base_ots():
    """2-of-3 with the port's base OTs (two phases of 128 OTs): A equals
    g1 * 1/(e + x)."""
    world = weak_bb_world(2, 3, (2, 3), 700)["port"]
    g1 = group_elem_from_try_and_incr(tb.G1, b"own-base-ots").normalize()
    signers = {i: p_twbb.ThresholdWeakBBSigner.init(
        world["rng"], i, world["shares"][i], [2, 3]) for i in (2, 3)}
    A = p_twbb.shared_inverse_times_base(world["rng"], signers,
                                         world["message"], g1)
    assert affine(A) == affine(
        g1 * int((world["message"] + world["sk"].x).inverse()))


def accumulator_world(seed: int):
    """Each package's params, keypair, state and accumulator over the same
    3 elements, and the Shamir shares of alpha held by managers 1-3 of 5."""
    out = {}
    for name, setup, core, pers, ss in (
            ("ref", r_setup, r_core, r_pers, r_ss),
            ("port", p_setup, p_core, p_pers, p_ss)):
        rng = random.Random(seed)
        params = setup.AccumSetupParams.new(b"thresh-accum")
        kp = setup.AccumKeypair.generate(rng, params)
        state = pers.InMemoryState()
        elems = [F.rand(rng) for _ in range(3)]
        acc = core.PositiveAccumulator.initialize(params).add_batch(
            elems, kp.secret_key, state)
        shares, _ = ss.shamir_deal_secret(rng, kp.secret_key.alpha, 2, 3)
        out[name] = dict(rng=rng, kp=kp, state=state, elems=elems, acc=acc,
                         sub={s.id: s.share for s in shares.shares[:2]})
    assert affine(out["port"]["acc"].value()) == \
        affine(out["ref"]["acc"].value())
    return out


@pytest.mark.parametrize("op", ["membership_witness", "remove"])
def test_threshold_accumulator_vs_reference_and_full_key(shared_base_ots,
                                                         op):
    """2-of-3 managers: the witness of an element and the value after a
    removal equal the reference's from the same seed and the full key's
    `compute_membership_witness` and `remove`."""
    world = accumulator_world(71)
    got = {}
    for name, thr in (("ref", r_thr), ("port", p_thr)):
        w = world[name]
        managers = thr.make_threshold_managers(w["rng"], w["sub"])
        if op == "membership_witness":
            got[name] = thr.threshold_membership_witness(
                w["rng"], managers, w["elems"][0], w["acc"].value()).C
        else:
            got[name] = thr.threshold_remove(w["rng"], managers,
                                             w["elems"][1],
                                             w["acc"].value())
    assert affine(got["port"]) == affine(got["ref"])
    w = world["port"]
    sk = w["kp"].secret_key
    if op == "membership_witness":
        full = w["acc"].compute_membership_witness(w["elems"][0], sk).C
    else:
        full = w["acc"].remove(w["elems"][1], sk, w["state"]).value()
    assert affine(got["port"]) == affine(full)


def test_degenerate_mask_refused(shared_base_ots):
    """A zero mask (every r_i = 0) is refused, as in the reference."""
    signers = {i: p_twbb.ThresholdWeakBBSigner(i, F(0), F(i))
               for i in (1, 2)}
    with pytest.raises(ValueError, match="degenerate"):
        p_twbb.shared_inverse_times_base(random.Random(1), signers, F(5),
                                         tb.G1.generator())


def test_point_mul_is_the_reference_host_product():
    """The port's host scalar multiplication (plain integers and a signed
    recoding on G1, the field objects' loop on G2) equals the reference's
    double-and-add on both curves' G1, at the edges of the scalar and of
    its recoding, unreduced (`mul_raw`) on a point of order 3 outside the
    subgroup, and on G2."""
    from crypto_tpu.curves import bn254 as jbn
    from crypto_tpu_torch.curves import bn254 as tbn

    def ints(P):
        return None if P.is_infinity() else tuple(
            int(c) if not hasattr(c, "c0") else (int(c.c0), int(c.c1))
            for c in P.to_affine())

    rng = np.random.default_rng(8)
    for tc, rc in ((tb.G1, jb.G1), (tbn.G1, jbn.G1)):
        r = tc.scalar_field.p
        P, R = tc.generator() * 977, rc.generator() * 977
        assert ints(P) == ints(R)
        ks = [0, 1, 2, 3, 15, 16, 17, 31, 33, (1 << 32) - 1, 1 << 32,
              (1 << 32) + 1, r - 1, r, r + 5, -3] + [
            int.from_bytes(rng.bytes(32), "little") % r for _ in range(8)]
        for k in ks:
            assert ints(P * k) == ints(R * k), k
            assert ints(P.mul_raw(k)) == ints(R.mul_raw(k)), k
        assert (tc.infinity() * 5).is_infinity()
    # a point of order 3 on BLS12-381's E(Fq): its odd multiples reach
    # infinity, so the table is refused and the loop runs
    h, x = tb.G1.cofactor, 1
    while True:
        x += 1
        ys = tb.G1.y_from_x(tb.Fq(x))
        if ys is None:
            continue
        T = tb.G1.point_from_affine(tb.Fq(x), ys[0]).mul_raw(
            h // 3 * tb.R)
        if not T.is_infinity():
            break
    assert not T.double().is_infinity() and (T.double() + T).is_infinity()
    Tr = jb.G1.point_from_affine(jb.Fq(int(T.to_affine()[0])),
                                 jb.Fq(int(T.to_affine()[1])))
    for k in (1, 2, 3, 4, 5, (1 << 40) + 1, (1 << 40) + 2):
        assert ints(T.mul_raw(k)) == ints(Tr.mul_raw(k)), k
    Q, Qr = tb.G2.generator(), jb.G2.generator()
    assert ints(Q * 12345) == ints(Qr * 12345)
