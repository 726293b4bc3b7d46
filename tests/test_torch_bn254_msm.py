"""The port's MSM over BN254 (`msm_device_scheduled(bn254.G1 / G2, ...,
device="cpu")`, the level, Fq2 and gather kernels' plain versions at 8
limbs) against the reference and the host.

* The reference's `msm_device_scheduled(bn.G1, ..., c=8, nbits=32)` on 8
  points (its own BN254 test, `tests/test_bn254.py`) against the port's
  on the same inputs.
* G1 at n = 16, c = 8 with every edge case: an infinite base, zero
  scalars and a duplicated base whose digits agree in window 0 only, so
  the fast levels flag window 0 alone and its rerun on the total formula
  makes the sum exact; `safe=True` on the same inputs, with no flag.
  Both against the host sums of the port's and the reference's G1.
* One G2 MSM at n = 16, c = 8 (the reference's G2 MSM is not run: its
  XLA compiles take tens of minutes) with duplicates, a base and its
  negation, infinity and zero scalars, against both host sums, on the
  total Fq2 levels with no flag and no rerun.
"""

import logging
import random

import pytest

from crypto_tpu.curves import bn254 as jbn
from crypto_tpu.ops import msm_v2 as jm
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.ops import msm_v2 as tm
from crypto_tpu_torch.testing import cap_threads

cap_threads()

N, C, NBITS = 16, 8, 16


def _affine(p):
    return convert.point_ints(p.normalize())


def _ref_host_sum(curve, points, scalars):
    """The reference's host sum of the same points (carried across)."""
    acc = curve.infinity()
    for q, s in zip(points, scalars):
        acc = acc + convert.carry_point(q, curve).mul_raw(s)
    return acc


def test_g1_msm_8_points_vs_reference():
    """The reference's own BN254 MSM test's shape: 8 points, 32-bit
    scalars, c = 8."""
    rng = random.Random(99)
    G = tbn.G1.generator()
    pts = [G.mul_raw(rng.randrange(1, tbn.R)) for _ in range(8)]
    scs = [rng.randrange(1, 1 << 32) for _ in range(8)]
    ref = jm.msm_device_scheduled(
        jbn.G1, [convert.carry_point(q, jbn.G1).normalize() for q in pts],
        scs, c=8, nbits=32)
    got = tm.msm_device_scheduled(tbn.G1, pts, scs, c=8, nbits=32,
                                  device="cpu")
    assert _affine(got) == _affine(ref)
    want = tbn.G1.infinity()
    for q, s in zip(pts, scs):
        want = want + q.mul_raw(s)
    assert got == want


def _g1_inputs():
    """Bases 3 and 7 equal with scalars that share only window 0's digit
    (0x34, which no other scalar's window 0 holds); base 5 at infinity;
    scalars 9 and 12 zero."""
    rng = random.Random(61)
    G = tbn.G1.generator()
    scal = []
    while len(scal) < N:
        s = rng.randrange(1, 1 << NBITS)
        if s & 0xFF not in (0x34, 0x100 - 0x34):
            scal.append(s)
    pts = [G.mul_raw(rng.randrange(1, tbn.R)) for _ in range(N)]
    pts[7] = pts[3]
    scal[3], scal[7] = 0x1234, 0x5634
    pts[5] = tbn.G1.infinity()
    scal[9] = scal[12] = 0
    return pts, scal


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
def test_g1_msm_edges_vs_both_hosts(safe, caplog):
    pts, scal = _g1_inputs()
    timings = {}
    with caplog.at_level(logging.WARNING, logger="crypto_tpu_torch.msm"):
        got = tm.msm_device_scheduled(tbn.G1, pts, scal, c=C, nbits=NBITS,
                                      device="cpu", timings=timings,
                                      safe=safe)
    want = tbn.G1.infinity()
    for q, s in zip(pts, scal):
        want = want + q.mul_raw(s)
    assert got == want
    assert _affine(got) == _affine(_ref_host_sum(jbn.G1, pts, scal))
    if safe:
        assert timings["rerun_windows"] == [] and "zero_chunks" not in \
            timings
    else:
        assert timings["rerun_windows"] == [0]
        assert timings["rerun_trace"]["level_pairs"]
        assert any("colliding pair in window 0" in r.getMessage()
                   for r in caplog.records)


def test_g2_msm_edges_vs_both_hosts():
    rng = random.Random(53)
    G = tbn.G2.generator()
    pts = [G.mul_raw(rng.randrange(1, tbn.R)) for _ in range(N)]
    scal = [rng.randrange(1, 1 << NBITS) for _ in range(N)]
    pts[4] = tbn.G2.infinity()
    scal[6] = scal[9] = 0
    for i in (2, 5, 8, 11):                          # one base, one bucket
        pts[i], scal[i] = pts[2], 0x1234
    pts[7], scal[7] = -pts[3], scal[3]               # Q and -Q
    pts[12] = pts[13]
    timings = {}
    got = tm.msm_device_scheduled(tbn.G2, pts, scal, c=C, nbits=NBITS,
                                  device="cpu", timings=timings)
    want = tbn.G2.infinity()
    for q, s in zip(pts, scal):
        want = want + q.mul_raw(s)
    assert got == want
    assert _affine(got) == _affine(_ref_host_sum(jbn.G2, pts, scal))
    assert timings["rerun_windows"] == [] and "zero_chunks" not in timings
