"""The port's MSM on its default doubling-free levels, with the per-window
rerun, against the reference `crypto_tpu.ops.msm_v2.msm_device_scheduled`
and the host, at the reference test's sizes (n = 16, c = 8, nbits = 16;
`tests/test_pallas_interpret.py`).  CPU, plain versions.

Distinct bases must run with no rerun and no warning.  Two equal bases
whose digits agree in window 0 only collide in that window's bucket: the
fast levels flag window 0 alone, the rerun names it in a warning, and the
result is exact, on the bands path and on the grid path (`pad=`).
`safe=True` gives the same result with no flag.
"""

import logging
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.ops import msm_v2 as jm
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.ops import msm_v2 as tm
from crypto_tpu_torch.testing import cap_threads

cap_threads()

N, C, NBITS = 16, 8, 16
G = tb.G1.generator()


def _inputs(collide: bool):
    """(dlogs, scalars).  With `collide`, bases 3 and 7 are equal and their
    scalars share only the low byte (window 0's digit, 52), which no other
    scalar's window-0 digit matches."""
    rng = random.Random(97)
    dlogs = [rng.randrange(1, 1 << 40) for _ in range(N)]
    scal = []
    while len(scal) < N:
        s = rng.randrange(1, 1 << NBITS)
        if s & 0xFF not in (0x34, 0x100 - 0x34):
            scal.append(s)
    if collide:
        dlogs[7] = dlogs[3]
        scal[3], scal[7] = 0x1234, 0x5634
    return dlogs, scal


def _host(dlogs, scal):
    return G.mul_raw(sum(s * d for s, d in zip(scal, dlogs)) % tb.R)


def _affine(p):
    return [int(v) for v in p.normalize().to_affine()]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's MSM of both input sets, as affine ints."""
    jG = jb.G1.generator()
    out = {}
    for collide in (False, True):
        dlogs, scal = _inputs(collide)
        ref = jm.msm_device_scheduled(jb.G1, [jG.mul_raw(d) for d in dlogs],
                                      scal, c=C, nbits=NBITS)
        out[collide] = _affine(ref)
    return out


def _msm(collide: bool, caplog, **kw):
    dlogs, scal = _inputs(collide)
    timings = {}
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="crypto_tpu_torch.msm"):
        got = tm.msm_device_scheduled(tb.G1, [G.mul_raw(d) for d in dlogs],
                                      scal, c=C, nbits=NBITS, device="cpu",
                                      timings=timings, **kw)
    assert got == _host(dlogs, scal)
    return got, timings, [r.getMessage() for r in caplog.records]


def test_distinct_bases_no_rerun(reference, caplog):
    got, timings, msgs = _msm(False, caplog)
    assert _affine(got) == reference[False]
    assert timings["rerun_windows"] == [] and not msgs
    assert not any(bool(z.any()) for *_, z in timings["zero_chunks"])


def test_collision_reruns_only_its_window(reference, caplog):
    got, timings, msgs = _msm(True, caplog)
    assert _affine(got) == reference[True]
    assert timings["rerun_windows"] == [0]
    assert msgs == ["msm_v2: colliding pair in window 0 (duplicate bases?), "
                    "rerunning with total-formula kernels"]
    assert timings["rerun_trace"]["level_pairs"]


def test_grid_path_collision_rerun(reference, caplog):
    got, timings, msgs = _msm(True, caplog, pad=8)
    assert _affine(got) == reference[True]
    assert timings["rerun_windows"] == [0]
    assert any("colliding pair in window 0" in m for m in msgs)


@pytest.mark.parametrize("collide", [False, True])
def test_safe_matches_fast(reference, collide, caplog):
    got, timings, msgs = _msm(collide, caplog, safe=True)
    assert _affine(got) == reference[collide]
    assert timings["rerun_windows"] == [] and not msgs
    assert "zero_chunks" not in timings
