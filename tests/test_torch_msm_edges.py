"""The port's MSM on its edge paths, against the host: duplicate bases
(a collision of the fast levels, rerun with the total formula, and a
count profile outside the Poisson model), all-equal scalars (occupancy
above MAX_PROFILE_RANK: the grid of per-round pads), the chunked level
inside an MSM, and the `pad` argument.  CPU, small sizes.
"""

import logging
import random

import pytest
import torch

from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.ops import msm_v2 as tm
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.testing import cap_threads

cap_threads()

rng = random.Random(71)
G = tb.G1.generator()


def _points(n):
    dlogs = [rng.randrange(1, tb.R) for _ in range(n)]
    return [G.mul_raw(d) for d in dlogs], dlogs


def test_duplicate_bases(caplog):
    """Eight equal bases in one bucket: the fast levels' zero denominator
    flags window 0, which is rerun with the total formula.  The first
    level (32 windows x 128 lanes = 4,096 pairs) takes the chunked level,
    whose zero total at thread t spoils pairs t + j*512: one in every
    fourth window, all of which are flagged and rerun."""
    p0 = G.mul_raw(rng.randrange(1, tb.R))
    timings = {}
    with caplog.at_level(logging.WARNING, logger="crypto_tpu_torch.msm"):
        got = tm.msm_device_scheduled(tb.G1, [p0] * 8, [7] * 8, c=8,
                                      device="cpu", timings=timings)
    assert got == p0.mul_raw(56)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("outside the Poisson model" in m for m in msgs)
    assert any("colliding pair in window 0" in m and "rerunning" in m
               for m in msgs)
    assert timings["rerun_windows"] == list(range(0, 32, 4))


def test_all_equal_scalars_grid_path(monkeypatch):
    n = 300
    pts, dlogs = _points(n)
    s = 0xBEEF              # digits -17, -65, 1: three windows, all full
    grids = []
    real = tm._grid_bands

    def spy(occ, B):
        grids.append(occ)
        return real(occ, B)

    monkeypatch.setattr(tm, "_grid_bands", spy)
    # the five grid rounds over three windows run in three pieces, whose
    # bucket sums are added
    monkeypatch.setattr(tm, "SLOT_CAP", 1 << 16)
    got = tm.msm_device_scheduled(tb.G1, pts, [s] * n, nbits=16,
                                  device="cpu")
    assert got == G.mul_raw(s * sum(dlogs) % tb.R)
    assert grids == [n] * 3 and n > tm.MAX_PROFILE_RANK
    assert len(tm._pieces(real(n, 128), 3)) == 3


def test_chunked_levels_inside_msm(monkeypatch):
    """Lower the chunked threshold so both (fast) level paths run in one
    MSM."""
    n = 64
    pts, dlogs = _points(n)
    scs = [rng.randrange(0, 1 << 16) for _ in range(n)]
    widths = {"chunked": 0, "narrow": 0}
    real_prefix = ck.chunked_level_prefix_fast
    real_level = ck.affine_level_fast

    def prefix(*a):
        widths["chunked"] += 1
        return real_prefix(*a)

    def level(*a):
        widths["narrow"] += 1
        return real_level(*a)

    monkeypatch.setattr(tm, "CHUNK_MIN_PAIRS", 300)
    monkeypatch.setattr(ck, "chunked_level_prefix_fast", prefix)
    monkeypatch.setattr(ck, "affine_level_fast", level)
    got = tm.msm_device_scheduled(tb.G1, pts, scs, c=8, nbits=16,
                                  device="cpu")
    assert got == G.mul_raw(sum(s * d for s, d in zip(scs, dlogs)) % tb.R)
    assert widths["chunked"] > 0 and widths["narrow"] > 0


def test_pad_argument():
    pts, dlogs = _points(16)
    scs = [rng.randrange(0, 1 << 16) for _ in range(16)]
    got = tm.msm_device_scheduled(tb.G1, pts, scs, c=8, nbits=16, pad=16,
                                  device="cpu")
    assert got == G.mul_raw(sum(s * d for s, d in zip(scs, dlogs)) % tb.R)
    with pytest.raises(ValueError, match="pad"):
        tm.msm_device_scheduled(tb.G1, pts, [5] * 16, c=8, nbits=16, pad=4,
                                device="cpu")


def test_msm_of_no_points_is_infinity():
    """An empty MSM returns infinity, as the reference's does (it pads N
    to at least 2 with infinity and zero scalars), for every form the
    scalars may take."""
    got = tm.msm_device_scheduled(tb.G1, [], [], device="cpu")
    assert got == tb.G1.infinity() and got.is_infinity()
    digits = tm.device_digits(torch.zeros((0, 32), dtype=torch.uint8), 8,
                              tb.Fr.bits)
    assert tm.msm_device_scheduled(tb.G1, [], digits, c=8,
                                   device="cpu").is_infinity()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_msm_equals_host_sum(n):
    """N = 1, 2 and 3 against the host sum, full-range scalars: the sizes
    below the reference's pad to 2 and just above it."""
    pts, _ = _points(n)
    scs = [rng.randrange(tb.R) for _ in range(n)]
    want = tb.G1.infinity()
    for p, s in zip(pts, scs):
        want = want + p.mul_raw(s)
    assert tm.msm_device_scheduled(tb.G1, pts, scs, device="cpu") == want
