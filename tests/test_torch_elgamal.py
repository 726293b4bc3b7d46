"""The port's ElGamal family and discrete-log solvers against the
reference's (`crypto_tpu_torch/utils/elgamal.py`,
`crypto_tpu/utils/elgamal.py`).

Keys and the plain, hashed and batched-hashed ciphertexts from the same
`random` seeds equal the reference's element for element and decrypt to
their messages; a rerandomised ciphertext likewise.  Baby-step giant-step
in G1 and in GT (the SAVER decryption's group) finds the same logs as the
reference's and as brute force, at 0, at the bound, and returns None
past it.  The field-vector helpers of `utils/ff.py` equal the
reference's.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.utils import elgamal as jel
from crypto_tpu.utils import ff as jff
from crypto_tpu_torch.convert import canonical, carry_fp12, carry_point
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads
from crypto_tpu_torch.utils import elgamal as tel
from crypto_tpu_torch.utils import ff as tff

cap_threads()


def _g(seed):
    """The same base in both packages."""
    p = tb.G1.rand(random.Random(seed)).normalize()
    return p, carry_point(p, jb.G1)


def test_keys_and_ciphertexts():
    gp, gr = _g(1511)
    rp, rr = random.Random(1512), random.Random(1512)
    skp, pkp = tel.keygen(rp, gp)
    skr, pkr = jel.keygen(rr, gr)
    assert canonical((skp, pkp)) == canonical((skr, pkr))

    msg = tb.G1.rand(random.Random(1513)).normalize()
    ctp, r1 = tel.Ciphertext.new(rp, msg, pkp, gp)
    ctr, r2 = jel.Ciphertext.new(rr, carry_point(msg, jb.G1), pkr, gr)
    assert canonical((ctp, r1)) == canonical((ctr, r2))
    assert ctp.decrypt(skp) == msg
    rep, _ = ctp.rerandomize(rp, pkp, gp)
    rer, _ = ctr.rerandomize(rr, pkr, gr)
    assert canonical(rep) == canonical(rer)
    assert rep.decrypt(skp) == msg and canonical(rep) != canonical(ctp)

    m = tb.Fr(1514)
    hp, _ = tel.HashedElgamalCiphertext.new(rp, m, pkp, gp)
    hr, _ = jel.HashedElgamalCiphertext.new(rr, jb.Fr(1514), pkr, gr)
    assert canonical(hp) == canonical(hr)
    assert hp.decrypt(skp) == m

    ms = [tb.Fr(v) for v in (0, 1, tb.R - 1, 12345)]
    bp, _ = tel.BatchedHashedElgamalCiphertext.new(rp, ms, pkp, gp)
    br, _ = jel.BatchedHashedElgamalCiphertext.new(
        rr, [jb.Fr(int(v)) for v in ms], pkr, gr)
    assert canonical(bp) == canonical(br)
    assert bp.decrypt(skp) == ms


@pytest.mark.parametrize("x", [0, 1, 37, 255, 256])
def test_bsgs_in_g1(x):
    gp, gr = _g(1515)
    bound = 255
    got = tel.solve_discrete_log_bsgs(bound, gp, gp.mul_raw(x))
    want = jel.solve_discrete_log_bsgs(bound, gr, gr.mul_raw(x))
    assert got == want == (x if x <= bound else None)
    assert tel.solve_discrete_log_brute_force(bound, gp, gp.mul_raw(x)) \
        == got


@pytest.fixture(scope="module")
def gt_base():
    gp, _ = _g(1516)
    return tb.pairing(gp, tb.G2.rand(random.Random(1517)).normalize())


@pytest.mark.parametrize("x", [0, 1, 200, 1023, 1024])
def test_bsgs_in_gt(gt_base, x):
    """The SAVER decryption's solver: GT is multiplicative."""
    b = gt_base
    br = carry_fp12(b, jb.Fq12)
    bound = 1023
    got = tel.solve_discrete_log_bsgs(bound, b, b ** x)
    want = jel.solve_discrete_log_bsgs(bound, br, br ** x)
    assert got == want == (x if x <= bound else None)
    if x <= 200:
        assert tel.solve_discrete_log_brute_force(bound, b, b ** x) == x


def test_field_vector_helpers():
    rng = random.Random(1518)
    v = [rng.randrange(tb.R) for _ in range(5)]
    w = [rng.randrange(tb.R) for _ in range(5)]
    x, y = rng.randrange(tb.R), rng.randrange(tb.R)
    tp, tr = [tb.Fr(a) for a in v], [jb.Fr(a) for a in v]
    up, ur = [tb.Fr(a) for a in w], [jb.Fr(a) for a in w]
    for got, want in (
            (tff.powers(tb.Fr(x), 6), jff.powers(jb.Fr(x), 6)),
            (tff.powers_starting_from(tb.Fr(y), tb.Fr(x), 4),
             jff.powers_starting_from(jb.Fr(y), jb.Fr(x), 4)),
            (tff.scale(tp, tb.Fr(x)), jff.scale(tr, jb.Fr(x))),
            (tff.add_vecs(tp, up), jff.add_vecs(tr, ur)),
            ([tff.inner_product(tp, up)], [jff.inner_product(tr, ur)]),
            ([tff.sum_vec(tp)], [jff.sum_vec(tr)])):
        assert [int(a) for a in got] == [int(a) for a in want]
