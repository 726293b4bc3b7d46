"""The port's G2 MSM (`msm_device_scheduled(G2, ..., device="cpu")`, plain
versions) against the host sums of the port's and the reference's G2, at
n = 16, c = 8, nbits = 16 (the reference MSM tests' sizes).

The reference's own G2 `msm_device_scheduled` is not run: its XLA
compiles of the G2 MSM run for tens of minutes on the CPU.  One MSM (a
plain CPU G2 MSM takes about 20 s) holds every case: distinct bases, an
infinite base, zero scalars, four equal bases with equal scalars (one
bucket in every window: doublings), a base and its negation with equal
scalars (P + (-P)), and two equal bases with other digits.  It must be
exact on the total formula with no flag and no rerun, and launch no G1
level kernel: `safe=False` runs no fast path on G2, so the `zero_chunks`
trace stays empty.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.ops import msm_v2 as tm
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.ops.kernels import field_kernels as fk
from crypto_tpu_torch.testing import cap_threads

cap_threads()

N, C, NBITS = 16, 8, 16
G1_LEVEL = ("affine_level", "chunked_level_prefix", "chunked_level_down",
            "affine_level_fast", "chunked_level_prefix_fast",
            "chunked_level_down_fast")


def _inputs():
    """(dlogs, scalars); a dlog of None is the point at infinity."""
    rng = random.Random(53)
    dlogs = [rng.randrange(1, tb.R) for _ in range(N)]
    scal = [rng.randrange(1, 1 << NBITS) for _ in range(N)]
    dlogs[4] = None                                  # infinity
    scal[6] = scal[9] = 0                            # zero scalars
    for i in (2, 5, 8, 11):                          # one base, one bucket
        dlogs[i], scal[i] = dlogs[2], 0x1234
    dlogs[7], scal[7] = tb.R - dlogs[3], scal[3]     # Q and -Q
    dlogs[12] = dlogs[13]                            # equal bases
    return dlogs, scal


@pytest.fixture(scope="module")
def run():
    """The MSM, with every G1 level kernel refusing to run, and the
    kernels it called."""
    dlogs, scal = _inputs()
    called = {"gather_rows_t": 0, "affine_level_pre_fq2": 0}
    mp = pytest.MonkeyPatch()

    def refuse(*a, **k):
        raise AssertionError("a G1 level kernel ran on G2")

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            called[name] += 1
            return real(*a, **k)
        mp.setattr(mod, name, wrapped)

    for name in G1_LEVEL:
        mp.setattr(ck, name, refuse)
    spy(fk, "gather_rows_t")
    spy(ck, "affine_level_pre_fq2")
    try:
        G = tb.G2.generator()
        bases = [tb.G2.infinity() if d is None else G.mul_raw(d)
                 for d in dlogs]
        timings = {}
        got = tm.msm_device_scheduled(tb.G2, bases, scal, c=C, nbits=NBITS,
                                      device="cpu", timings=timings)
    finally:
        mp.undo()
    total = sum(s * d for s, d in zip(scal, dlogs) if d is not None) % tb.R
    return got, total, timings, called


def _affine(p):
    return [int(c) for v in p.normalize().to_affine() for c in (v.c0, v.c1)]


def test_g2_msm_equals_port_host_sum(run):
    got, total, _, _ = run
    assert got == tb.G2.generator().mul_raw(total)


def test_g2_msm_equals_reference_host_sum(run):
    got, total, _, _ = run
    assert _affine(got) == _affine(jb.G2.generator().mul_raw(total))


def test_g2_msm_runs_total_formula_without_flags(run):
    _, _, timings, called = run
    assert timings["rerun_windows"] == [] and "zero_chunks" not in timings
    assert timings["level_pairs"] and timings["slots"]
    # one gather each of x and y per layout, the Fq2 pre once a level
    assert called["gather_rows_t"] == 2 * len(timings["slots"])
    assert called["affine_level_pre_fq2"] == len(timings["level_pairs"])


def test_g2_msm_of_no_points_is_infinity():
    """An empty G2 MSM returns infinity, as the reference's does (it pads
    N to at least 2 with infinity and zero scalars)."""
    got = tm.msm_device_scheduled(tb.G2, [], [], device="cpu")
    assert got == tb.G2.infinity() and got.is_infinity()
