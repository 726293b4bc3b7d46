"""The port's accumulator host layers against the reference's.

Exact (canonical integers) on inputs from `random` seeds: the Fq2 square
root (both branches, Tonelli-Shanks included), the try-and-increment
hashes, `AccumSetupParams.new` and the keys, the zeroize and polynomial
helpers, the d/v polynomials in both forms (the coefficients also at 256
additions, through the port's NTT on the CPU), `Omega.new`/`evaluate`
and the public-info updates, the positive and universal accumulators with
their witnesses and pairing checks, the single-element updates and the
host branch of the batched updates below the device threshold.  Every
port call that takes `device=` gets "cpu".
"""

import random

import pytest

from crypto_tpu import hashing as jhash
from crypto_tpu.accumulator import batch_utils as jbu
from crypto_tpu.accumulator import core as jcore
from crypto_tpu.accumulator import setup as jsetup
from crypto_tpu.accumulator import witness as jwit
from crypto_tpu.accumulator.persistence import InMemoryInitialElements \
    as JInitial
from crypto_tpu.accumulator.persistence import InMemoryState as JState
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.utils import ff as jff
from crypto_tpu_torch import hashing as thash
from crypto_tpu_torch.accumulator import batch_utils as tbu
from crypto_tpu_torch.accumulator import core as tcore
from crypto_tpu_torch.accumulator import setup as tsetup
from crypto_tpu_torch.accumulator import witness as twit
from crypto_tpu_torch.accumulator.persistence import InMemoryInitialElements \
    as TInitial
from crypto_tpu_torch.accumulator.persistence import InMemoryState as TState
from crypto_tpu_torch.convert import carry_point, point_ints
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.utils import ff as tff

ENV = ("CRYPTO_TPU_FORCE_DEVICE_ACCUM", "CRYPTO_TPU_NO_DEVICE_ACCUM")


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def ints(xs):
    return [int(x) for x in xs]


def tfr(xs):
    return [tb.Fr(int(x)) for x in xs]


def jfr(xs):
    return [jb.Fr(int(x)) for x in xs]


def same_point(t, j) -> bool:
    """A port point equals a reference point (both normalised)."""
    return point_ints(t.normalize()) == point_ints(j.normalize())


def _fp2_case(case: str, rng):
    """(reference element, port element) of an Fq2 case."""
    p = tb.P
    if case == "square":
        a = (rng.randrange(p), rng.randrange(p))
        x = jb.Fq2(*a).square()
        c = (int(x.c0), int(x.c1))
    elif case == "non-square":
        while True:
            c = (rng.randrange(p), rng.randrange(p))
            if jb.Fq2(*c).norm().sqrt() is None:
                break
    elif case == "zero":
        c = (0, 0)
    elif case == "pure-u":
        c = (0, rng.randrange(1, p))
    else:      # a base-field nonresidue: the complex method fails, TS runs
        while True:
            v = rng.randrange(1, p)
            if pow(v, (p - 1) // 2, p) != 1:
                break
        c = (v, 0)
    return jb.Fq2(*c), tb.Fq2(*c)


@pytest.mark.parametrize("case", ["square", "non-square", "zero", "pure-u",
                                  "tonelli-shanks"])
def test_fp2_sqrt_vs_reference(case):
    jx, tx = _fp2_case(case, random.Random(11))
    jr, tr = jx.sqrt(), tx.sqrt()
    if jr is None:
        assert tr is None and case == "non-square"
        return
    assert (int(tr.c0), int(tr.c1)) == (int(jr.c0), int(jr.c1))
    assert tr.square() == tx
    assert tr.is_gt_half() == jr.is_gt_half()


@pytest.mark.parametrize("label", [b"", b"bench-accum", b"dev-upd"])
def test_try_and_increment_vs_reference(label):
    data = thash.concat_slices(label, b" : x")
    assert thash.blake2b512(data) == jhash.blake2b512(data)
    assert int(thash.field_elem_from_try_and_incr(tb.Fr, data)) == \
        int(jhash.field_elem_from_try_and_incr(jb.Fr, data))
    e, fl = thash.field_from_random_bytes_wide(tb.Fq, data * 3, flag_bits=2)
    je, jfl = jhash.field_from_random_bytes_wide(jb.Fq, data * 3, flag_bits=2)
    assert (int(e), fl) == (int(je), jfl)
    for tc, jc in ((tb.G1, jb.G1), (tb.G2, jb.G2)):
        t = thash.group_elem_from_try_and_incr(tc, data)
        assert same_point(t, jhash.group_elem_from_try_and_incr(jc, data))
        assert t.is_on_curve() and t.mul_raw(tb.R).is_infinity()


def test_setup_and_keys_vs_reference():
    for label in (b"bench-accum", b"dev-upd"):
        t, j = tsetup.AccumSetupParams.new(label), \
            jsetup.AccumSetupParams.new(label)
        assert same_point(t.P, j.P) and same_point(t.P_tilde, j.P_tilde)
    t = tsetup.AccumSetupParams.generate_using_rng(random.Random(3))
    j = jsetup.AccumSetupParams.generate_using_rng(random.Random(3))
    assert same_point(t.P, j.P) and same_point(t.P_tilde, j.P_tilde)
    tk = tsetup.AccumKeypair.generate(random.Random(4), t)
    jk = jsetup.AccumKeypair.generate(random.Random(4), j)
    assert int(tk.secret_key.alpha) == int(jk.secret_key.alpha)
    assert same_point(tk.public_key.Q_tilde, jk.public_key.Q_tilde)
    assert tk.public_key.is_valid()
    ts = tsetup.AccumSecretKey.generate_using_seed(b"seed-1")
    assert int(ts.alpha) == \
        int(jsetup.AccumSecretKey.generate_using_seed(b"seed-1").alpha)
    ts.zeroize()
    assert ts.alpha.is_zero()


def test_ff_vs_reference():
    rng = random.Random(5)
    a = [rng.randrange(tb.R) for _ in range(4)]
    b = [rng.randrange(tb.R) for _ in range(3)]
    x = rng.randrange(tb.R)
    assert ints(tff.multiply_poly(tfr(a), tfr(b))) == \
        ints(jff.multiply_poly(jfr(a), jfr(b)))
    assert int(tff.poly_eval(tfr(a), tb.Fr(x))) == \
        int(jff.poly_eval(jfr(a), jb.Fr(x)))


@pytest.mark.parametrize("n_add,n_rem", [(0, 0), (1, 0), (3, 2), (0, 3),
                                         (4, 1)])
def test_batch_polys_vs_reference(n_add, n_rem):
    rng = random.Random(6 + n_add * 7 + n_rem)
    alpha = rng.randrange(1, tb.R)
    adds = [rng.randrange(tb.R) for _ in range(n_add)]
    rems = [rng.randrange(tb.R) for _ in range(n_rem)]
    x = rng.randrange(tb.R)
    ta, ja = tb.Fr(alpha), jb.Fr(alpha)
    tx, jx = tb.Fr(x), jb.Fr(x)
    pairs = [
        (tbu.poly_d_eval(tfr(adds), tx), jbu.poly_d_eval(jfr(adds), jx)),
        (tbu.poly_v_A_eval(tfr(adds), ta, tx),
         jbu.poly_v_A_eval(jfr(adds), ja, jx)),
        (tbu.poly_v_D_eval(tfr(rems), ta, tx),
         jbu.poly_v_D_eval(jfr(rems), ja, jx)),
        (tbu.poly_v_AD_eval(tfr(adds), tfr(rems), ta, tx),
         jbu.poly_v_AD_eval(jfr(adds), jfr(rems), ja, jx)),
    ]
    assert [int(t) for t, _ in pairs] == [int(j) for _, j in pairs]
    tc = tbu.poly_v_AD_coeffs(tfr(adds), tfr(rems), ta, device="cpu")
    assert ints(tc) == ints(jbu.poly_v_AD_coeffs(jfr(adds), jfr(rems), ja))
    assert tff.poly_eval(tc, tx) == pairs[3][0]


def test_poly_coeffs_ntt_vs_reference():
    """256 additions: the last products reach 256 coefficients and go
    through `poly_mul_ntt` (the port's on the CPU, the reference's in
    JAX)."""
    rng = random.Random(8)
    alpha = rng.randrange(1, tb.R)
    adds = [rng.randrange(tb.R) for _ in range(256)]
    tc = tbu.poly_v_A_coeffs(tfr(adds), tb.Fr(alpha), device="cpu")
    assert len(tc) == 256
    assert ints(tc) == ints(jbu.poly_v_A_coeffs(jfr(adds), jb.Fr(alpha)))


@pytest.fixture(scope="module")
def accums():
    """The same positive accumulator in both packages: 12 elements, 3
    members' witnesses, a batch of 3 additions and 2 removals."""
    rng = random.Random(9)
    jp = jsetup.AccumSetupParams.new(b"test-accum")
    jk = jsetup.AccumKeypair.generate(random.Random(10), jp)
    elems = [rng.randrange(tb.R) for _ in range(12)]
    ja = jcore.PositiveAccumulator.initialize(jp).add_batch(
        jfr(elems), jk.secret_key, JState())
    tp = tsetup.AccumSetupParams.new(b"test-accum")
    tk = tsetup.AccumKeypair.generate(random.Random(10), tp)
    ta = tcore.PositiveAccumulator.initialize(tp).add_batch(
        tfr(elems), tk.secret_key, TState())
    adds = [rng.randrange(tb.R) for _ in range(3)]
    return dict(jp=jp, jk=jk, ja=ja, tp=tp, tk=tk, ta=ta, elems=elems,
                members=elems[:3], adds=adds, rems=elems[8:10])


def test_positive_accumulator_vs_reference(accums):
    a = accums
    assert same_point(a["ta"].value(), a["ja"].value())
    tst, jst = TState(), JState()
    for e in a["elems"]:
        tst.add(e)
        jst.add(e)
    tsk, jsk = a["tk"].secret_key, a["jk"].secret_key
    y = a["adds"][0]
    steps = [
        (a["ta"].add(tb.Fr(y), tsk, tst), a["ja"].add(jb.Fr(y), jsk, jst)),
        (a["ta"].remove(tb.Fr(a["elems"][0]), tsk, tst),
         a["ja"].remove(jb.Fr(a["elems"][0]), jsk, jst)),
        (a["ta"].add_batch(tfr(a["adds"][1:]), tsk, tst),
         a["ja"].add_batch(jfr(a["adds"][1:]), jsk, jst)),
        (a["ta"].remove_batch(tfr(a["rems"]), tsk, tst),
         a["ja"].remove_batch(jfr(a["rems"]), jsk, jst)),
    ]
    for t, j in steps:
        assert same_point(t.value(), j.value())
    with pytest.raises(tcore.AccumulatorError):
        a["ta"].add(tb.Fr(a["elems"][1]), tsk, tst)
    # witnesses: one alone, and the batch (below the device table's 512)
    m = tfr(a["members"])
    w0 = a["ta"].compute_membership_witness(m[0], tsk)
    ws = a["ta"].compute_membership_witnesses_for_batch(m, tsk, device="cpu")
    jws = a["ja"].compute_membership_witnesses_for_batch(
        jfr(a["members"]), jsk)
    assert all(same_point(t.C, j.C) for t, j in zip(ws, jws))
    assert w0.C == ws[0].C
    tpk, tp = a["tk"].public_key, a["tp"]
    assert a["ta"].verify_membership(m[1], ws[1], tpk, tp)
    assert not a["ta"].verify_membership(m[1], ws[2], tpk, tp)


def test_universal_accumulator_vs_reference(accums):
    a = accums
    tsk, jsk = a["tk"].secret_key, a["jk"].secret_key
    tu = tcore.UniversalAccumulator.initialize(
        random.Random(12), a["tp"], 8, tsk, TInitial())
    ju = jcore.UniversalAccumulator.initialize(
        random.Random(12), a["jp"], 8, jsk, JInitial())
    assert int(tu.f_V) == int(ju.f_V) and same_point(tu.V, ju.V)
    tst, jst = TState(), JState()
    tu = tu.add_batch(tfr(a["members"]), tsk, tst)
    ju = ju.add_batch(jfr(a["members"]), jsk, jst)
    assert int(tu.f_V) == int(ju.f_V) and same_point(tu.V, ju.V)
    y = a["adds"][0]
    tw = tu.get_non_membership_witness(tb.Fr(y), tsk, tst, a["tp"])
    jw = ju.get_non_membership_witness(jb.Fr(y), jsk, jst, a["jp"])
    assert int(tw.d) == int(jw.d) and same_point(tw.C, jw.C)
    assert tu.verify_non_membership(tb.Fr(y), tw, a["tk"].public_key,
                                    a["tp"])
    with pytest.raises(tcore.AccumulatorError):
        tu.get_non_membership_witness(tb.Fr(a["members"][0]), tsk, tst,
                                      a["tp"])


def test_single_and_host_batch_updates_vs_reference(accums):
    """The one-element updates, and the batched ones on the host branch
    (3 members, below `DEVICE_THRESHOLD`, on the CPU)."""
    a = accums
    tsk, jsk = a["tk"].secret_key, a["jk"].secret_key
    m, y = a["members"], a["adds"][0]
    tw = a["ta"].compute_membership_witness(tb.Fr(m[0]), tsk)
    jw = a["ja"].compute_membership_witness(jb.Fr(m[0]), jsk)
    t1 = twit.update_membership_after_addition(tw, tb.Fr(m[0]), tb.Fr(y),
                                               a["ta"].value())
    j1 = jwit.update_membership_after_addition(jw, jb.Fr(m[0]), jb.Fr(y),
                                               a["ja"].value())
    assert same_point(t1.C, j1.C)
    t2 = twit.update_membership_after_removal(tw, tb.Fr(m[0]), tb.Fr(y),
                                              a["ta"].value())
    j2 = jwit.update_membership_after_removal(jw, jb.Fr(m[0]), jb.Fr(y),
                                              a["ja"].value())
    assert same_point(t2.C, j2.C)
    tn = tcore.NonMembershipWitness(tw.C, tb.Fr(5))
    jn = jcore.NonMembershipWitness(jw.C, jb.Fr(5))
    for tf, jf in ((twit.update_non_membership_after_addition,
                    jwit.update_non_membership_after_addition),
                   (twit.update_non_membership_after_removal,
                    jwit.update_non_membership_after_removal)):
        t3 = tf(tn, tb.Fr(m[1]), tb.Fr(y), a["ta"].value())
        j3 = jf(jn, jb.Fr(m[1]), jb.Fr(y), a["ja"].value())
        assert same_point(t3.C, j3.C) and int(t3.d) == int(j3.d)
    tws = [tcore.NonMembershipWitness(w.C, tb.Fr(3)) for w in
           a["ta"].compute_membership_witnesses_for_batch(
               tfr(m), tsk, device="cpu")]
    jws = [jcore.NonMembershipWitness(w.C, jb.Fr(3)) for w in
           a["ja"].compute_membership_witnesses_for_batch(jfr(m), jsk)]
    t4 = twit.update_non_membership_batch_with_sk(
        tfr(a["adds"]), tfr(a["rems"]), tfr(m), tws, a["ta"].value(), tsk,
        device="cpu")
    j4 = jwit.update_non_membership_batch_with_sk(
        jfr(a["adds"]), jfr(a["rems"]), jfr(m), jws, a["ja"].value(), jsk)
    assert [int(w.d) for w in t4] == [int(w.d) for w in j4]
    assert all(same_point(t.C, j.C) for t, j in zip(t4, j4))


def test_omega_vs_reference(accums):
    """Omega.new's points and a public-info update with them; the update
    equals the one made with the secret key (host branch)."""
    a = accums
    tsk, jsk = a["tk"].secret_key, a["jk"].secret_key
    adds, rems, m = a["adds"], a["rems"], a["members"]
    to = tbu.Omega.new(tfr(adds), tfr(rems), a["ta"].value(), tsk,
                       device="cpu")
    jo = jbu.Omega.new(jfr(adds), jfr(rems), a["ja"].value(), jsk)
    assert len(to.points) == len(jo.points)
    assert all(same_point(t, j) for t, j in zip(to.points, jo.points))
    y, s = tb.Fr(m[1]), tb.Fr(7)
    assert same_point(to.evaluate(y, s), jo.evaluate(jb.Fr(m[1]), jb.Fr(7)))
    tw = a["ta"].compute_membership_witness(y, tsk)
    pub = twit.update_with_public_info_multiple_batches(
        tw, y, [(tfr(adds), tfr(rems), to)])
    jpub = jwit.update_membership_with_public_info(
        a["ja"].compute_membership_witness(jb.Fr(m[1]), jsk), jb.Fr(m[1]),
        jfr(adds), jfr(rems), jo)
    assert same_point(pub.C, jpub.C)
    (sk_upd,) = twit.update_membership_batch_with_sk(
        tfr(adds), tfr(rems), [y], [tw], a["ta"].value(), tsk, device="cpu")
    assert pub.C == sk_upd.C
    assert carry_point(sk_upd.C, jb.G1) == jpub.C
