#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crypto_tpu_torch/csrc` and drives
the port's paths on the card, each with every launch count set to 0 just
before it and read just after:

* bench points: 2^20 distinct BLS12-381 G1 points with known discrete
  logs, built by the full-add and normalize kernels (`make_bench_points`);
* the 2^20 MSM (c = 16, full-range 255-bit scalars) through
  `msm_device_scheduled` on its default doubling-free levels, five timed
  runs, each checked against the known discrete logs, none rerun (then,
  outside the counted paths, three runs each of `safe=True` and the
  default in turns);
* the rerun path: the same MSM with one base duplicated and the digits set
  so that the pair collides in one window's bucket; the flagged windows
  must be exactly those that share a spoiled chunk, and they are rerun
  through the total-formula kernels;
* the edge MSMs (8 duplicate bases, whose window is rerun through the
  total-formula pre/post; 300 points with one scalar, the grid path);
* the Jacobian add, mixed add and double of `make_add_fns` at 2^20 rows;
* G2 bench points: 2^20 distinct BLS12-381 G2 points with known discrete
  logs, built by the total `TCurve` add and `to_affine` over Fq2;
* the 2^20 G2 MSM (c = 16, full-range scalars), three timed runs, each
  checked against the known discrete logs, on the reference's Fq2
  configuration: the Fq2 pre/post at every level, the Fq2 mul in the
  inversions and the tail, the Fq2 square in the tail, and no G1 level
  kernel;
* the 2^20 G2 MSM with its squares through the square kernel and through
  the product kernel, in turns (timed, outside the counted paths);
* the G2 edge MSMs (duplicate bases, a base and its negation, infinity,
  zero scalars; 300 points with one scalar), checked against the host
  sum with no rerun.

Every MSM lays out its bucket slots through the gather kernel.  Then it
holds every kernel against its plain PyTorch version bit for bit at the
shapes a path gave it, and profiles one more 2^20 G1 MSM and one more G2
MSM for the device's busy share.  It fails if a kernel of a path was not
launched on it.  One line per phase; before the last line the card's name
and power limit and a JSON object of the kernels' launches and times; the
last line is the result object.  Exits non-zero on any failure, and when
there is no CUDA device.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_LOG = 20
SEED = 20251016
MSM_RUNS = 5                        # timed 2^20 MSMs, fresh scalars each
G2_MSM_RUNS = 3                     # timed 2^20 G2 MSMs, fresh scalars each
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
# 32-bit integer multiply-adds: 64 per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# x 132 SMs x 1.98 GHz boost clock (H100 SXM)
H100_IMAD_PER_S = 132 * 64 * 1.98e9
FQ_LIMBS = 12
FQ_BYTES = 4 * FQ_LIMBS            # one Fq element, 12 x 32-bit limbs
FQ2_BYTES = 2 * FQ_BYTES           # one Fq2 element


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, wide_products: float) -> tuple:
    """Least time for the work: bytes over the memory rate, or the 32x32
    -> 64-bit products (two 32-bit multiply-adds each) over the integer
    rate, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * wide_products / H100_IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> int:
    """Largest |kernel - plain| over the outputs' int32 words."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


# (path, total formula) -> the level kernels it dispatches to
LEVEL_KERNELS = {
    ("chunked", False): ("chunked_level_prefix_fast",
                         "chunked_level_down_fast"),
    ("pre_post", False): ("affine_level_pre_fast", "affine_level_post_fast"),
    ("chunked", True): ("chunked_level_prefix", "chunked_level_down"),
    ("pre_post", True): ("affine_level_pre", "affine_level_post"),
}
SAFE_KERNELS = LEVEL_KERNELS[("chunked", True)] \
    + LEVEL_KERNELS[("pre_post", True)]
G1_LEVEL_KERNELS = sum(LEVEL_KERNELS.values(), ())
# what a G2 MSM launches: the gather, the Fq2 level, mul and square, and
# mont_mul (the base-field Fermat root of every Fq2 inversion)
G2_KERNELS = ("gather_cols", "affine_level_pre_fq2", "affine_level_post_fq2",
              "fq2_mul", "fq2_sqr", "mont_mul")
FQ2_KERNELS = G2_KERNELS[1:5]


def level_kernels(fast_widths, safe_widths, threshold: int) -> set:
    """The kernels a G1 run dispatches to: the gather and mont_mul always,
    the chunked level for calls of at least `threshold` pairs, pre/post for
    the narrower ones; the fast variants for the fast calls, the total
    formula for the rerun's."""
    names = {"gather_cols", "mont_mul"}
    for widths, safe in ((fast_widths, False), (safe_widths, True)):
        if any(w >= threshold for w in widths):
            names.update(LEVEL_KERNELS[("chunked", safe)])
        if any(w < threshold for w in widths):
            names.update(LEVEL_KERNELS[("pre_post", safe)])
    return names


def rerun_widths(timings: dict) -> list:
    return (timings["rerun_trace"] or {}).get("level_pairs", [])


def spoiled_windows(timings: dict) -> list:
    """The windows that a run's zero denominators touched, from the level
    calls' records: a zero at chunk t of a call of M pairs in K strips
    spoils pairs t + j*(M/K), and pair l lies in window l // (M/windows)."""
    out = set()
    for M, windows, K, zero in timings.get("zero_chunks", []):
        T = zero.numel()
        for t in torch.nonzero(zero).flatten().tolist():
            out.update((t + j * T) // (M // windows) for j in range(K)
                       if t + j * T < M)
    return sorted(out)


def drive(counted, fn):
    """fn() with every launch count set to 0 just before it; returns its
    result and the counts read just after."""
    for f in counted:
        f.launches = 0
    out = fn()
    return out, {f.__name__: f.launches for f in counted}


def require(path: str, launches: dict, names) -> None:
    missing = sorted(k for k in names if launches[k] == 0)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def floats(timings: dict) -> dict:
    return {k: v for k, v in timings.items() if isinstance(v, float)}


def timed_call(fn):
    """(fn(), milliseconds of that one call on the card)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
    from crypto_tpu_torch.fields.tfield import tfield_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.ops.kernels import build
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    from crypto_tpu_torch.ops.kernels import point_kernels as pk

    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    phase("card", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.time()
    build.load_library()
    phase("build", seconds=round(time.time() - t0, 3),
          nvcc_seconds=round(build.build_info["seconds"], 3),
          lib=build.build_info["path"])

    counted = (fk.mont_mul, ck.affine_level_pre, ck.affine_level_post,
               ck.chunked_level_prefix, ck.chunked_level_down,
               ck.affine_level_pre_fast, ck.affine_level_post_fast,
               ck.chunked_level_prefix_fast, ck.chunked_level_down_fast,
               pk.jacobian_add, pk.jacobian_add_mixed, pk.jacobian_double,
               pk.jacobian_normalize, fk.fq2_mul, fk.fq2_sqr,
               ck.affine_level_pre_fq2, ck.affine_level_post_fq2,
               fk.gather_cols)
    thr = msm_v2.CHUNK_MIN_PAIRS
    paths = {}            # path -> (launches, level widths)

    # ---- bench points: 2^20 distinct points, full add + normalize ------
    n = 1 << N_LOG
    tc = tcurve_for(bls.G1, dev)
    F = tc.F
    G = bls.G1.generator()
    t0 = time.time()
    (points, dlog), bp_launches = drive(counted,
                                        lambda: make_bench_points(tc, n))
    torch.cuda.synchronize()
    t_points = time.time() - t0
    require("bench points", bp_launches, ("jacobian_add",
                                          "jacobian_normalize"))
    if (bp_launches["jacobian_add"], bp_launches["jacobian_normalize"]) \
            != (2, 1):
        raise AssertionError(f"bench points: expected 2 full adds and 1 "
                             f"normalize, got {bp_launches}")
    logs = [dlog(i) for i in range(n)]
    sample = list(range(0, n, n // 64))
    got = tc.unpack(TPoints(*(t[:, sample] for t in points)))
    if any(g != G.mul_raw(logs[i]) for g, i in zip(got, sample)):
        raise AssertionError("bench points disagree with their discrete "
                             "logs")
    paths["bench_points_2^20"] = (bp_launches, [])
    phase("bench_points", n=n, seconds=round(t_points, 3),
          full_add_launches=bp_launches["jacobian_add"],
          normalize_launches=bp_launches["jacobian_normalize"],
          sample_checked=len(sample), correct=True)

    # ---- the main path: 2^20 points, c = 16, fast levels ----------------
    _, warm_sb = make_bench_scalars(bls.R, n, SEED)
    msm_v2.msm_device_scheduled(bls.G1, points, warm_sb, c=16)

    secs, main_runs = [], []
    for run in range(MSM_RUNS):
        sc, sb = make_bench_scalars(bls.R, n, SEED + 1 + run)
        timings = {}
        torch.cuda.synchronize()

        def timed():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bls.G1, points, sb, c=16,
                                              timings=timings)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed)
        expect = G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % bls.R)
        if result != expect:
            raise AssertionError("2^20 MSM disagrees with the known-dlog "
                                 "result")
        if timings["rerun_windows"] or any(launches[k] for k in
                                           SAFE_KERNELS + FQ2_KERNELS):
            raise AssertionError(
                f"2^20 MSM on distinct bases reran windows "
                f"{timings['rerun_windows']} or launched a total-formula "
                f"or an Fq2 kernel: {launches}")
        widths = timings["level_pairs"]
        require("2^20 MSM", launches, level_kernels(widths, [], thr))
        secs.append(dt)
        main_runs.append((launches, widths))
        phase("msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(timings), rerun_windows=[],
              gather_launches=launches["gather_cols"], correct=True)
    main_launches, main_widths = main_runs[0]
    paths["msm_2^20"] = main_runs[0]
    med = statistics.median(secs)
    phase("msm", n=n, c=16, runs=MSM_RUNS, seconds=secs, median_s=med,
          spread=max(secs) / min(secs), points_per_s=n / med,
          level_pairs=main_widths, slots=timings["slots"],
          chunk_min_pairs=thr,
          bench_points_seconds=round(t_points, 3), card=repr(card),
          correct=True)

    # ---- the 2^20 MSM on the total-formula levels (safe=True) against the
    # default, in turns on one scalar set (safe, fast, fast, safe, ...)
    sc, sb = make_bench_scalars(bls.R, n, SEED + 40)
    expect = G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % bls.R)
    msm_turns = {True: [], False: []}
    for safe in (True, False, False, True, True, False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = msm_v2.msm_device_scheduled(bls.G1, points, sb, c=16,
                                          safe=safe)
        msm_turns[safe].append(time.perf_counter() - t)
        if res != expect:
            raise AssertionError(f"2^20 MSM with safe={safe} disagrees with "
                                 f"the known-dlog result")
    phase("msm_safe_vs_fast", n=n, safe_s=msm_turns[True],
          fast_s=msm_turns[False],
          safe_median_s=statistics.median(msm_turns[True]),
          fast_median_s=statistics.median(msm_turns[False]), correct=True)

    # ---- the rerun path: a duplicated base collides in one window -------
    sc, sb = make_bench_scalars(bls.R, n, SEED + 50)
    digits = msm_v2.device_digits(sb, 16, bls.Fr.bits)
    dh = digits.cpu().numpy()
    W, B, w0 = dh.shape[0], 1 << 15, 5
    i_b = next(k for k in range(11, n) if dh[w0, k] != 0)
    j_b = next(k for k in range(n // 2, n)
               if all(dh[w, k] != dh[w, i_b] for w in range(W) if w != w0))
    v0 = int(dh[w0, i_b])
    # window w0's bucket |v0| - 1 keeps only bases i_b and j_b: the others
    # move to the buckets after it, one each
    lane = np.arange(n)
    moved = np.nonzero((np.abs(dh[w0]) == abs(v0)) & (lane != i_b)
                       & (lane != j_b))[0]
    new = np.sign(dh[w0, moved]) * ((abs(v0) + np.arange(moved.size)) % B
                                    + 1)
    logs_r = list(logs)
    logs_r[j_b] = logs[i_b]
    shift = 1 << (16 * w0)
    expect_s = sum(s * d for s, d in zip(sc, logs_r))
    expect_s += (v0 - int(dh[w0, j_b])) * shift * logs_r[j_b]
    expect_s += sum((int(a) - int(b)) * shift * logs_r[k]
                    for k, a, b in zip(moved, new, dh[w0, moved]))
    dh[w0, moved] = new
    dh[w0, j_b] = v0
    pts_r = TPoints(*(t.clone() for t in points))
    for t in pts_r:
        t[:, j_b] = t[:, i_b]
    t_rr = {}
    t0 = time.perf_counter()
    res_r, rr_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bls.G1, pts_r, torch.from_numpy(dh).to(dev), c=16, timings=t_rr))
    dt_r = time.perf_counter() - t0
    if res_r != G.mul_raw(expect_s % bls.R):
        raise AssertionError("2^20 rerun MSM disagrees with the known-dlog "
                             "result")
    spoiled = spoiled_windows(t_rr)
    if w0 not in spoiled or t_rr["rerun_windows"] != spoiled:
        raise AssertionError(f"rerun path: collision in window {w0}, "
                             f"spoiled windows {spoiled}, rerun "
                             f"{t_rr['rerun_windows']}")
    rr_widths = rerun_widths(t_rr)
    require("2^20 rerun", rr_launches,
            level_kernels(t_rr["level_pairs"], rr_widths, thr))
    paths["rerun_2^20"] = (rr_launches, rr_widths)
    phase("rerun_msm", n=n, collision_window=w0, bases=[i_b, j_b],
          moved_from_bucket=int(moved.size), rerun_windows=spoiled,
          level_pairs=t_rr["level_pairs"], rerun_level_pairs=rr_widths,
          seconds=dt_r, phases=floats(t_rr), correct=True)

    # ---- edge MSMs on the card: the small-MSM path --------------------
    p0 = G.mul_raw(random.Random(SEED).randrange(1, bls.R))
    m_eq = 300
    sub = TPoints(*(t[:, :m_eq].contiguous() for t in points))
    s_eq = 0x1234567890ABCDEF
    t_dup, t_eq = {}, {}

    def edges():
        return (msm_v2.msm_device_scheduled(bls.G1, [p0] * 8, [7] * 8,
                                            timings=t_dup),
                msm_v2.msm_device_scheduled(bls.G1, sub, [s_eq] * m_eq,
                                            timings=t_eq))

    (dup, eq_res), edge_launches = drive(counted, edges)
    if dup != p0.mul_raw(56):
        raise AssertionError("duplicate-base MSM disagrees with the host")
    if eq_res != G.mul_raw(s_eq * sum(logs[:m_eq]) % bls.R):
        raise AssertionError("all-equal-scalar MSM disagrees with the host")
    if 0 not in t_dup["rerun_windows"] \
            or t_dup["rerun_windows"] != spoiled_windows(t_dup) \
            or t_eq["rerun_windows"]:
        raise AssertionError(f"edge MSMs: rerun {t_dup['rerun_windows']} "
                             f"and {t_eq['rerun_windows']}")
    edge_widths = t_dup["level_pairs"] + t_eq["level_pairs"]
    edge_safe = rerun_widths(t_dup)
    require("edge MSM", edge_launches,
            level_kernels(edge_widths, edge_safe, thr)
            | set(LEVEL_KERNELS[("pre_post", True)]))
    paths["edge_msm"] = (edge_launches, edge_widths)
    phase("edge_msm", duplicate_bases=True, all_equal_scalars_n=m_eq,
          level_pairs=edge_widths, rerun_windows=t_dup["rerun_windows"],
          rerun_level_pairs=edge_safe, correct=True)

    # ---- the point kernels of make_add_fns at 2^20 rows -----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pts = points.X.shape[1]

    def level_inputs(M: int, pts=points, Fx=F):
        """M pairs of real points of `pts` (over the field `Fx`): generic
        pairs, doublings, P + (-P) and infinite operands on either or both
        sides."""
        i1 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        i2 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        lane = torch.arange(M, device=dev)
        i2 = torch.where(lane % 7 < 2, i1, i2)             # same x
        x1, y1 = pts.X[:, i1], pts.Y[:, i1]
        x2, y2 = pts.X[:, i2], pts.Y[:, i2]
        y2 = torch.where((lane % 7 == 1)[None], Fx.neg(y2), y2)  # P + (-P)
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    def point_inputs(M: int):
        """(X1, Y1, Z1) Jacobian with random Z, (x2, y2, Z2) affine, over
        level_inputs' pairs (P + P gives the degenerate flag) with Z = 0
        where a mask says infinity."""
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        z = points.X[:, torch.randint(0, n_pts, (M,), generator=gen,
                                      device=dev)]
        zz = F.mul(z, z)
        one, zero = F.ones((M,)), F.zeros((M,))
        J = (F.mul(x1, zz), F.mul(y1, F.mul(zz, z)),
             torch.where((m1 != 0)[None], zero, z))
        Q = (x2, y2, torch.where((m2 != 0)[None], zero, one))
        return J, Q, (x1, y1, x2, y2)

    pt_in = point_inputs(n)
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(tc)
    J, Q, aff = pt_in
    (s_add, s_mix, s_dbl), af_launches = drive(counted, lambda: (
        add_fn(TPoints(*J), TPoints(*Q)),
        affine_add_fn(TPoints(aff[0], aff[1], J[2]),
                      TPoints(aff[2], aff[3], J[2])),
        double_fn(TPoints(*J))))
    require("add_fns", af_launches, ("jacobian_add", "jacobian_add_mixed",
                                     "jacobian_double"))
    if not (int(s_add[1]) and int(s_mix[1])):
        raise AssertionError("make_add_fns: P + P did not raise the flag")
    paths["add_fns_2^20"] = (af_launches, [])
    phase("add_fns", rows=n, full_add_flag=int(s_add[1]),
          mixed_add_flag=int(s_mix[1]), launches={
              k: af_launches[k] for k in ("jacobian_add",
                                          "jacobian_add_mixed",
                                          "jacobian_double")})

    # ---- G2 bench points: 2^20 points over Fq2 -------------------------
    tc2 = tcurve_for(bls.G2, dev)
    F2 = tc2.F
    G2 = bls.G2.generator()
    not_g2 = G1_LEVEL_KERNELS + ("jacobian_add", "jacobian_add_mixed",
                                 "jacobian_double", "jacobian_normalize")
    t0 = time.time()
    (points2, dlog2), bp2_launches = drive(
        counted, lambda: make_bench_points(tc2, n))
    torch.cuda.synchronize()
    t_points2 = time.time() - t0
    require("G2 bench points", bp2_launches, ("fq2_mul", "fq2_sqr",
                                              "mont_mul"))
    if any(bp2_launches[k] for k in not_g2):
        raise AssertionError(f"G2 bench points launched a G1 kernel: "
                             f"{bp2_launches}")
    logs2 = [dlog2(i) for i in range(n)]
    sample2 = list(range(0, n, n // 16))
    got2 = tc2.unpack(TPoints(*(t[:, sample2] for t in points2)))
    t0 = time.perf_counter()
    want2 = [G2.mul_raw(logs2[i]) for i in sample2]
    t_mul2 = (time.perf_counter() - t0) / len(sample2)  # one host G2 mul
    if got2 != want2:
        raise AssertionError("G2 bench points disagree with their discrete "
                             "logs")
    paths["g2_bench_points_2^20"] = (bp2_launches, [])
    phase("g2_bench_points", n=n, seconds=round(t_points2, 3),
          fq2_mul_launches=bp2_launches["fq2_mul"],
          fq2_sqr_launches=bp2_launches["fq2_sqr"],
          mont_mul_launches=bp2_launches["mont_mul"],
          host_g2_mul_raw_s=t_mul2, sample_checked=len(sample2),
          correct=True)

    # ---- the G2 MSM: 2^20 points, c = 16, the reference's Fq2 levels ----
    def g2_msm_checks(where: str, launches: dict, timings: dict) -> None:
        """A G2 MSM runs the Fq2 kernels, the gather and mont_mul, no G1
        level or point kernel, and no flag or rerun."""
        require(where, launches, G2_KERNELS)
        if any(launches[k] for k in not_g2) or timings["rerun_windows"] \
                or "zero_chunks" in timings:
            raise AssertionError(f"{where}: a G1 kernel, a flag or a rerun: "
                                 f"{launches}, rerun "
                                 f"{timings['rerun_windows']}")

    _, warm2 = make_bench_scalars(bls.R, n, SEED + 60)
    msm_v2.msm_device_scheduled(bls.G2, points2, warm2, c=16)
    secs2, g2_runs = [], []
    for run in range(G2_MSM_RUNS):
        sc2, sb2 = make_bench_scalars(bls.R, n, SEED + 61 + run)
        t2 = {}
        torch.cuda.synchronize()

        def timed2():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bls.G2, points2, sb2, c=16,
                                              timings=t2)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed2)
        expect = G2.mul_raw(sum(s * d for s, d in zip(sc2, logs2)) % bls.R)
        if result != expect:
            raise AssertionError("2^20 G2 MSM disagrees with the known-dlog "
                                 "result")
        g2_msm_checks("2^20 G2 MSM", launches, t2)
        secs2.append(dt)
        g2_runs.append((launches, t2))
        phase("g2_msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(t2), rerun_windows=[], correct=True)
    g2_launches, t2 = g2_runs[0]
    g2_widths = t2["level_pairs"]
    paths["g2_msm_2^20"] = (g2_launches, g2_widths)
    med2 = statistics.median(secs2)
    phase("g2_msm", n=n, c=16, runs=G2_MSM_RUNS, seconds=secs2,
          median_s=med2, spread=max(secs2) / min(secs2),
          points_per_s=n / med2, g1_points_per_s=n / med,
          g2_over_g1_time=med2 / med, level_pairs=g2_widths,
          slots=t2["slots"], launches={k: g2_launches[k] for k in G2_KERNELS},
          card=repr(card), correct=True)

    # ---- the G2 MSM with its squares through the square kernel (the
    # default) against the Karatsuba product kernel, in turns on one
    # scalar set (product, square, square, product, product, square)
    sq_turns = {"product": [], "square": []}
    for kind in ("product", "square", "square", "product", "product",
                 "square"):
        if kind == "product":
            F2.square = lambda a: F2.mul(a, a)
        tt = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = msm_v2.msm_device_scheduled(bls.G2, points2, sb2, c=16,
                                          timings=tt)
        sq_turns[kind].append((time.perf_counter() - t, tt["tail"]))
        F2.__dict__.pop("square", None)
        if res != expect:
            raise AssertionError(f"2^20 G2 MSM with squares by {kind} "
                                 f"disagrees with the known-dlog result")
    out = {}
    for k, v in sq_turns.items():
        out[f"{k}_s"] = [s for s, _ in v]
        out[f"{k}_tail_s"] = [tail for _, tail in v]
        out[f"{k}_median_s"] = statistics.median(s for s, _ in v)
    phase("g2_square_vs_product", n=n, **out, correct=True)

    # ---- G2 edge MSMs: duplicates, P and -P, infinity, zero scalars, and
    # all-equal scalars (the grid path); the total formula, no rerun
    hr = random.Random(SEED + 70)
    q0, q1, *qs = (G2.mul_raw(hr.randrange(1, bls.R)) for _ in range(8))
    e_pts = [q0] * 6 + [q1, -q1, bls.G2.infinity(), q0.double()] + qs
    e_sc = [7] * 6 + [9, 9, 5, 0, 0, 3, 7, 11, 2, 13]
    e_expect = bls.G2.infinity()
    for p, s in zip(e_pts, e_sc):
        e_expect = e_expect + p.mul_raw(s)
    sub2 = TPoints(*(t[:, :m_eq].contiguous() for t in points2))
    t_e1, t_e2 = {}, {}
    (e_res, eq2_res), edge2_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bls.G2, e_pts, e_sc, timings=t_e1),
        msm_v2.msm_device_scheduled(bls.G2, sub2, [s_eq] * m_eq,
                                    timings=t_e2)))
    if e_res != e_expect:
        raise AssertionError("G2 edge MSM disagrees with the host sum")
    if eq2_res != G2.mul_raw(s_eq * sum(logs2[:m_eq]) % bls.R):
        raise AssertionError("G2 all-equal-scalar MSM disagrees with the "
                             "host")
    for tt in (t_e1, t_e2):
        g2_msm_checks("G2 edge MSM", edge2_launches, tt)
    g2_edge_widths = t_e1["level_pairs"] + t_e2["level_pairs"]
    paths["g2_edge_msm"] = (edge2_launches, g2_edge_widths)
    phase("g2_edge_msm", points=len(e_pts), all_equal_scalars_n=m_eq,
          level_pairs=g2_edge_widths, rerun_windows=[], correct=True)
    phase("launches", **{k: v[0] for k, v in paths.items()})
    never = [f.__name__ for f in counted
             if not any(v[0][f.__name__] for v in paths.values())]
    if never:
        raise AssertionError(f"kernels launched on no path: {never}")

    # ---- kernels vs plain, at the shapes a path gave them -------------
    def row(name, src, rep, path, err, ms, plain_ms, bound, shape,
            library_ms=None):
        return dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=paths[path][0][name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                    library_ms=library_ms, path=path, shape=shape)

    rows = []
    csrc = "crypto_tpu_torch/csrc/"
    ref = "crypto_tpu/ops/pallas/curve_kernels.py:"
    mul_products = 2 * FQ_LIMBS * FQ_LIMBS + FQ_LIMBS   # per Montgomery mul

    def agree(name, kernel_out, plain_out, where):
        err = max_err(kernel_out, plain_out)
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"{where}")
        return err

    # mont_mul at the tail's width (16 windows x 2^15 buckets), Fq and Fr
    for fld, M in ((bls.Fq, 16 << 15), (bls.Fr, 1 << 16)):
        Fx = tfield_for(fld, dev)
        L = Fx.L
        # random field elements, then the edges 0, 1, p-1 and all-ones limbs
        hr = random.Random(SEED)
        ra = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        rb = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        edges_ = Fx.pack([0, 1, fld.p - 1, fld.p - 1], mont=False)
        ra[:, :4] = edges_
        rb[:, :4] = edges_.flip(1)
        ra[:, 4] = -1
        rb[:, 5] = -1
        rb[:, 6] = -1
        ra[:, 6] = -1
        plain, plain_ms = timed_call(lambda: fk.mont_mul_plain(ra, rb,
                                                               Fx.mod))
        err = agree("mont_mul", (fk.mont_mul(ra, rb, Fx.mod),), (plain,),
                    f"on {fld.name}")
        if fld is bls.Fq:
            rows.append(row(
                "mont_mul", csrc + "mont_mul.cu",
                "crypto_tpu/ops/pallas/field_kernels.py:386", "msm_2^20",
                err, cuda_ms(lambda: fk.mont_mul(ra, rb, Fx.mod)), plain_ms,
                bound_ms(3 * FQ_BYTES * M, (2 * L * L + L) * M), [L, M]))
    phase("check_mont_mul", fq_pairs=16 << 15, fr_pairs=1 << 16,
          bit_exact=True)

    def check_pre_post(M: int, path: str | None, fast: bool):
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        if fast:
            pre, post = ck.affine_level_pre_fast, ck.affine_level_post_fast
            pre_p = ck.affine_level_pre_fast_plain
            post_p = ck.affine_level_post_fast_plain
        else:
            pre, post = ck.affine_level_pre, ck.affine_level_post
            pre_p, post_p = (ck.affine_level_pre_plain,
                             ck.affine_level_post_plain)
        ins = (x1, y1, m1, x2, y2, m2)
        kd = pre(F, *ins)
        pd, pre_ms = timed_call(lambda: pre_p(F, *ins))
        e_pre = agree(pre.__name__, kd, pd, f"at M={M}")
        d = kd[0].clone()
        d[0] |= F.is_zero(d).to(torch.int32)    # as pair_add_t does
        dinv = msm_v2.batch_inv_t(F, d)
        args = (x1, y1, x2, y2, dinv, m1, m2) if fast else \
            (x1, y1, x2, y2, dinv, kd[1], m1, m2)
        pp, post_ms = timed_call(lambda: post_p(F, *args))
        e_post = agree(post.__name__, post(F, *args), pp, f"at M={M}")
        if path is None:
            return
        nmul = 3 * M if fast else 3 * M + int(kd[1].sum())
        pre_bytes = M * (3 * FQ_BYTES + 12) if fast else \
            M * (5 * FQ_BYTES + 16)
        post_bytes = M * (7 * FQ_BYTES + 8) if fast else \
            M * (7 * FQ_BYTES + 12)
        lines = ("739", "752") if fast else ("533", "548")
        rows.append(row(pre.__name__, csrc + "affine_level.cu",
                        ref + lines[0], path, e_pre,
                        cuda_ms(lambda: pre(F, *ins)), pre_ms,
                        bound_ms(pre_bytes, 0), [12, M]))
        rows.append(row(post.__name__, csrc + "affine_level.cu",
                        ref + lines[1], path, e_post,
                        cuda_ms(lambda: post(F, *args)), post_ms,
                        bound_ms(post_bytes, nmul * mul_products), [12, M]))

    for fast, widths in ((False, edge_safe), (True, edge_widths)):
        w_pre = max(w for w in widths if w < thr)
        pre_widths = [w_pre, w_pre - 3 if w_pre > 3 else w_pre + 3,
                      min(main_widths)]          # and a 2^20 level width
        check_pre_post(pre_widths[0], "edge_msm", fast)
        for w in pre_widths[1:]:
            check_pre_post(w, None, fast)
        phase("check_affine_level_fast" if fast else "check_affine_level",
              pairs=pre_widths, path="edge_msm", bit_exact=True)

    def chunked_inputs(M: int):
        pad = (-M) % msm_v2.CHUNK_PAD
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        x1, y1, x2, y2 = (msm_v2._pad_cols(t, pad, 0)
                          for t in (x1, y1, x2, y2))
        m1, m2 = msm_v2._pad_cols(m1, pad, 1), msm_v2._pad_cols(m2, pad, 1)
        return x1, y1, m1, x2, y2, m2

    def check_chunked(M: int, path: str | None, fast: bool):
        ins = chunked_inputs(M)
        Mp = ins[0].shape[1]
        if fast:
            prefix, down = (ck.chunked_level_prefix_fast,
                            ck.chunked_level_down_fast)
            prefix_p = ck.chunked_level_prefix_fast_plain
            down_p = ck.chunked_level_down_fast_plain
        else:
            prefix, down = ck.chunked_level_prefix, ck.chunked_level_down
            prefix_p = ck.chunked_level_prefix_plain
            down_p = ck.chunked_level_down_plain
        kq = prefix(F, *ins)
        pq, prefix_ms = timed_call(lambda: prefix_p(F, *ins))
        e_pre = agree(prefix.__name__, kq, pq, f"at M={M}")
        total = kq[1].clone()
        total[0] |= F.is_zero(total).to(torch.int32)    # as pair_add_t does
        tinv = msm_v2.batch_inv_t(F, total)
        args = ins + (kq[0], tinv) + (() if fast else (kq[2],))
        pdn, down_ms = timed_call(lambda: down_p(F, *args))
        e_down = agree(down.__name__, down(F, *args), pdn, f"at M={M}")
        if path is None:
            return
        K = ck.CHUNK_K
        strips = Mp - Mp // K
        if fast:
            pre_b, pre_mul = Mp * (3 * FQ_BYTES + 12), strips
            down_b, down_mul = Mp * (7 * FQ_BYTES + 8), 2 * strips + 3 * Mp
            lines = ("669", "683")
        else:
            ndbl = int(kq[2].sum())
            pre_b, pre_mul = Mp * (5 * FQ_BYTES + 16), strips
            down_b = Mp * (7 * FQ_BYTES + 12)
            down_mul = 2 * strips + 3 * Mp + ndbl
            lines = ("844", "860")
        rows.append(row(prefix.__name__, csrc + "chunked_level.cu",
                        ref + lines[0], path, e_pre,
                        cuda_ms(lambda: prefix(F, *ins)), prefix_ms,
                        bound_ms(pre_b + Mp // K * FQ_BYTES,
                                 pre_mul * mul_products), [12, Mp]))
        rows.append(row(down.__name__, csrc + "chunked_level.cu",
                        ref + lines[1], path, e_down,
                        cuda_ms(lambda: down(F, *args)), down_ms,
                        bound_ms(down_b + Mp // K * FQ_BYTES,
                                 down_mul * mul_products), [12, Mp]))

    for fast, path, widths in ((False, "rerun_2^20", rr_widths),
                               (True, "msm_2^20", main_widths)):
        w_chunk = min(w for w in widths if w >= thr)
        check_chunked(w_chunk, path, fast)
        check_chunked(w_chunk + 5, None, fast)
        phase("check_chunked_level_fast" if fast else "check_chunked_level",
              pairs=[w_chunk, w_chunk + 5], path=path, bit_exact=True)

    # the safe and the fast chunked level on the same 2^20 level's inputs,
    # timed in turns (safe, fast, fast, safe)
    ins = chunked_inputs(min(main_widths))
    sq = ck.chunked_level_prefix(F, *ins)
    s_args = ins + (sq[0], msm_v2.batch_inv_t(F, sq[1]), sq[2])
    fq = ck.chunked_level_prefix_fast(F, *ins)
    f_tot = fq[1].clone()
    f_tot[0] |= F.is_zero(f_tot).to(torch.int32)
    f_args = ins + (fq[0], msm_v2.batch_inv_t(F, f_tot))
    turns = {"safe": [[], []], "fast": [[], []]}
    for kind in ("safe", "fast", "fast", "safe"):
        pre_fn, down_fn, a = (
            (ck.chunked_level_prefix, ck.chunked_level_down, s_args)
            if kind == "safe" else
            (ck.chunked_level_prefix_fast, ck.chunked_level_down_fast,
             f_args))
        turns[kind][0].append(cuda_ms(lambda: pre_fn(F, *ins)))
        turns[kind][1].append(cuda_ms(lambda: down_fn(F, *a)))
    phase("compare_chunked", pairs=ins[0].shape[1],
          safe_prefix_ms=turns["safe"][0], fast_prefix_ms=turns["fast"][0],
          safe_down_ms=turns["safe"][1], fast_down_ms=turns["fast"][1])

    # the point kernels: full add at the bench points' 2^14 and 2^20 rows,
    # mixed add, double and normalize at 2^20
    for M in (1 << 14, n):
        Jm, Qm, _ = pt_in if M == n else point_inputs(M)
        args = Jm + Qm
        pa, add_ms = timed_call(lambda: pk.jacobian_add_plain(F, *args))
        e_add = agree("jacobian_add", pk.jacobian_add(F, *args), pa,
                      f"at M={M}")
        if int(pa[3].sum()) == 0:
            raise AssertionError("full-add check inputs hold no P + P")
    rows.append(row("jacobian_add", csrc + "jacobian.cu", ref + "334",
                    "bench_points_2^20", e_add,
                    cuda_ms(lambda: pk.jacobian_add(F, *args)), add_ms,
                    bound_ms(n * (9 * FQ_BYTES + 4), 16 * n * mul_products),
                    [12, n]))
    pm, mix_ms = timed_call(lambda: pk.jacobian_add_mixed_plain(F, *aff))
    e_mix = agree("jacobian_add_mixed", pk.jacobian_add_mixed(F, *aff), pm,
                  f"at M={n}")
    rows.append(row("jacobian_add_mixed", csrc + "jacobian.cu", ref + "347",
                    "add_fns_2^20", e_mix,
                    cuda_ms(lambda: pk.jacobian_add_mixed(F, *aff)), mix_ms,
                    bound_ms(n * (7 * FQ_BYTES + 4), 6 * n * mul_products),
                    [12, n]))
    pdb, dbl_ms = timed_call(lambda: pk.jacobian_double_plain(F, *J))
    e_dbl = agree("jacobian_double", pk.jacobian_double(F, *J), pdb,
                  f"at M={n}")
    rows.append(row("jacobian_double", csrc + "jacobian.cu", ref + "360",
                    "add_fns_2^20", e_dbl,
                    cuda_ms(lambda: pk.jacobian_double(F, *J)), dbl_ms,
                    bound_ms(n * 6 * FQ_BYTES, 7 * n * mul_products),
                    [12, n]))
    phase("check_jacobian", full_add_rows=[1 << 14, n], mixed_add_rows=n,
          double_rows=n, bit_exact=True)
    fermat = bls.P - 2
    norm_muls = (fermat.bit_length() - 1) + (bin(fermat).count("1") - 1) + 4
    pn, norm_ms = timed_call(lambda: pk.jacobian_normalize_plain(F, *J))
    e_norm = agree("jacobian_normalize", pk.jacobian_normalize(F, *J), pn,
                   f"at M={n}")
    rows.append(row("jacobian_normalize", csrc + "normalize.cu",
                    ref + "390", "bench_points_2^20", e_norm,
                    cuda_ms(lambda: pk.jacobian_normalize(F, *J), reps=2),
                    norm_ms,
                    bound_ms(n * 6 * FQ_BYTES, norm_muls * n * mul_products),
                    [12, n]))
    phase("check_normalize", points=n, infinite=int(F.is_zero(J[2]).sum()),
          muls_per_point=norm_muls, bit_exact=True)

    # ---- the Fq2 mul at the first product-tree width of the G2 MSM's
    # narrowest level, and a ragged count; random curve coordinates and
    # the edges 0, 1, u, (p-1)(1 + u) and a square
    w_fq2 = min(g2_widths) // 2
    gen2 = torch.Generator(device=dev).manual_seed(SEED + 2)
    fq2_edges = F2.pack([bls.Fq2(0, 0), bls.Fq2(1, 0), bls.Fq2(0, 1),
                         bls.Fq2(bls.P - 1, bls.P - 1)])
    for M in (w_fq2, w_fq2 - 3):
        a = points2.X[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        b = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4], b[:, :4] = fq2_edges, fq2_edges.flip(1)
        b[:, 4] = a[:, 4]
        pm, fq2_ms = timed_call(lambda: fk.fq2_mul_plain(F2.base, a, b))
        e_fq2 = agree("fq2_mul", (fk.fq2_mul(F2.base, a, b),), (pm,),
                      f"at M={M}")
        if M == w_fq2:
            rows.append(row(
                "fq2_mul", csrc + "fq2_mul.cu", ref + "1066", "g2_msm_2^20",
                e_fq2, cuda_ms(lambda: fk.fq2_mul(F2.base, a, b)), fq2_ms,
                bound_ms(3 * FQ2_BYTES * M, 3 * mul_products * M), [24, M]))
    phase("check_fq2_mul", pairs=[w_fq2, w_fq2 - 3], path="g2_msm_2^20",
          bit_exact=True)

    # ---- the Fq2 square at the G2 tail's widest (the first reduction of
    # 16 windows x 2^15 buckets: 2^18 sums), and a ragged count, on the
    # same kind of inputs
    w_sq = 16 << 14
    for M in (w_sq, w_sq - 5):
        a = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4] = fq2_edges
        ps, sqr_ms = timed_call(lambda: fk.fq2_sqr_plain(F2.base, a))
        e_sq = agree("fq2_sqr", (fk.fq2_sqr(F2.base, a),), (ps,),
                     f"at M={M}")
        if M == w_sq:
            rows.append(row(
                "fq2_sqr", csrc + "fq2_mul.cu", ref + "908", "g2_msm_2^20",
                e_sq, cuda_ms(lambda: fk.fq2_sqr(F2.base, a)), sqr_ms,
                bound_ms(2 * FQ2_BYTES * M, 2 * mul_products * M), [24, M]))
    phase("check_fq2_sqr", elements=[w_sq, w_sq - 5], path="g2_msm_2^20",
          bit_exact=True)

    # ---- the Fq2 level at the G2 MSM's narrowest level, a ragged count
    # and the G2 edge MSMs' widest level
    def check_fq2_level(M: int, path: str | None):
        ins = level_inputs(M, points2, F2)
        kd = ck.affine_level_pre_fq2(F2, *ins)
        pd, pre_ms = timed_call(lambda: ck.affine_level_pre_plain(F2, *ins))
        e_pre = agree("affine_level_pre_fq2", kd, pd, f"at M={M}")
        ndbl, ninf = int(kd[1].sum()), int(kd[2].sum())
        if M > 64 and not (ndbl and ninf):
            raise AssertionError("Fq2 level check inputs hold no doubling "
                                 "or no infinite result")
        x1, y1, m1, x2, y2, m2 = ins
        args = (x1, y1, x2, y2, msm_v2.batch_inv_t(F2, kd[0]), kd[1], m1,
                m2)
        pp, post_ms = timed_call(lambda: ck.affine_level_post_plain(F2,
                                                                    *args))
        e_post = agree("affine_level_post_fq2",
                       ck.affine_level_post_fq2(F2, *args), pp, f"at M={M}")
        if path is None:
            return
        rows.append(row("affine_level_pre_fq2", csrc + "affine_level_fq2.cu",
                        ref + "1014", path, e_pre,
                        cuda_ms(lambda: ck.affine_level_pre_fq2(F2, *ins)),
                        pre_ms, bound_ms(M * (5 * FQ2_BYTES + 16), 0),
                        [24, M]))
        rows.append(row("affine_level_post_fq2",
                        csrc + "affine_level_fq2.cu", ref + "1029", path,
                        e_post,
                        cuda_ms(lambda: ck.affine_level_post_fq2(F2, *args)),
                        post_ms,
                        bound_ms(M * (7 * FQ2_BYTES + 12),
                                 (8 * M + 2 * ndbl) * mul_products),
                        [24, M]))

    w_lvl = min(g2_widths)
    check_fq2_level(w_lvl, "g2_msm_2^20")
    check_fq2_level(w_lvl + 5, None)
    check_fq2_level(max(g2_edge_widths), None)
    phase("check_affine_level_fq2",
          pairs=[w_lvl, w_lvl + 5, max(g2_edge_widths)], path="g2_msm_2^20",
          bit_exact=True)

    # ---- the gather at the G2 MSM's layout: (24, 2^20) coordinates into
    # its slots, each point once a window at random slots, the rest empty
    # (-1); and a ragged count with indices past the source (a zero
    # column on both sides).  The library call is index_select on the
    # clamped index with a zero fill, timed here and used nowhere.
    W2 = (bls.Fr.bits + 16) // 16
    src = points2.X
    for M in (max(t2["slots"]), n + 3):
        live = min(M, W2 * n)
        idx = torch.full((M,), -1, dtype=torch.int64, device=dev)
        pos = torch.randperm(M, generator=gen2, device=dev)[:live]
        idx[pos] = torch.cat([torch.randperm(n, generator=gen2, device=dev)
                              for _ in range(W2)])[:live]
        if M == n + 3:
            idx[:3] = torch.tensor([n, n + 9, -5], device=dev)
        pg, gather_ms = timed_call(lambda: fk.gather_cols_plain(src, idx))
        e_g = agree("gather_cols", (fk.gather_cols(src, idx),), (pg,),
                    f"at M={M}")
        if M == n + 3:      # index_select would fault on the indices >= N
            break

        def library():
            return src.index_select(1, idx.clamp(min=0)).masked_fill_(
                idx < 0, 0)

        agree("index_select", (library(),), (pg,), f"at M={M}")
        cols = int(torch.unique(idx[idx >= 0]).numel())
        rows.append(row("gather_cols", csrc + "gather.cu",
                        "crypto_tpu/ops/pallas/field_kernels.py:356",
                        "g2_msm_2^20", e_g,
                        cuda_ms(lambda: fk.gather_cols(src, idx)), gather_ms,
                        bound_ms(FQ2_BYTES * (cols + M) + 8 * M, 0),
                        [24, M], library_ms=cuda_ms(library)))
        g_live = live
    phase("check_gather", slots=[max(t2["slots"]), n + 3], live=g_live,
          path="g2_msm_2^20", bit_exact=True)

    # ---- device busy share of one more 2^20 MSM of each curve ----------
    from torch.profiler import ProfilerActivity, profile

    def device_profile(name: str, fn) -> None:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                k = by_name.setdefault(e.name[:48], [0, 0])
                k[0] += 1
                k[1] += e.time_range.elapsed_us()
        busy_us, reach = 0, None          # union of the kernels' intervals
        for start, end in sorted(spans):
            if reach is None or start > reach:
                busy_us += end - start
                reach = end
            elif end > reach:
                busy_us += end - reach
                reach = end
        busy = busy_us / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        phase(name, wall_s=round(wall, 4),
              device_busy_s=round(busy, 4) if busy else "not measured",
              idle_share=round(1 - busy / wall, 4) if busy
              else "not measured",
              device_launches=len(spans),
              top_ms=[(k, cnt, round(us / 1e3, 3))
                      for k, (cnt, us) in top])

    device_profile("profile", lambda: msm_v2.msm_device_scheduled(
        bls.G1, points, sb, c=16))
    device_profile("profile_g2", lambda: msm_v2.msm_device_scheduled(
        bls.G2, points2, sb, c=16))
    phase("total", seconds=round(time.time() - t_start, 3))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
