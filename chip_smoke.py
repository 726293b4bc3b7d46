#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crypto_tpu_torch/csrc`, runs the
BLS12-381 G1 MSM at 2^20 distinct points with known discrete logs (c = 16,
full-range 255-bit scalars) through `msm_device_scheduled`, checks it on
the host, holds every kernel against its plain PyTorch version bit for bit
at the shapes the MSM gave it, runs the duplicate-base and all-equal-scalar
edge MSMs, profiles one more 2^20 MSM for the device's busy share, and
fails unless every kernel launched during the 2^20 MSM.
One line per phase; before the last line the card's name and power limit
and a JSON object of the kernels' launches and times; the last line is
the result object.  Exits non-zero on any failure, and when there is no
CUDA device.
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
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
# 32-bit integer multiply-adds: 64 per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# x 132 SMs x 1.98 GHz boost clock (H100 SXM)
H100_IMAD_PER_S = 132 * 64 * 1.98e9
FQ_BYTES = 48                       # one Fq element, 12 x 32-bit limbs


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


LEVEL_KERNELS = {"chunked": ("chunked_level_prefix", "chunked_level_down"),
                 "pre_post": ("affine_level_pre", "affine_level_post")}


def path_kernels(widths, threshold: int) -> set:
    """The kernels a run's level calls are dispatched to: mont_mul always,
    the chunked level for calls of at least `threshold` pairs, pre/post for
    the narrower ones."""
    names = {"mont_mul"}
    if any(w >= threshold for w in widths):
        names.update(LEVEL_KERNELS["chunked"])
    if any(w < threshold for w in widths):
        names.update(LEVEL_KERNELS["pre_post"])
    return names


def drive(counted, fn):
    """fn() with every launch count set to 0 just before it; returns its
    result and the counts read just after."""
    for f in counted:
        f.launches = 0
    out = fn()
    return out, {f.__name__: f.launches for f in counted}


def require(path: str, launches: dict, widths, threshold: int) -> None:
    missing = sorted(k for k in path_kernels(widths, threshold)
                     if launches[k] == 0)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


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
               ck.chunked_level_prefix, ck.chunked_level_down)
    thr = msm_v2.CHUNK_MIN_PAIRS

    # ---- the main path: 2^20 points, c = 16 ---------------------------
    n = 1 << N_LOG
    tc = tcurve_for(bls.G1, dev)
    F = tc.F
    t0 = time.time()
    points, dlog = make_bench_points(tc, n)
    torch.cuda.synchronize()
    t_points = time.time() - t0
    logs = [dlog(i) for i in range(n)]
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
        expect = bls.G1.generator().mul_raw(
            sum(s * d for s, d in zip(sc, logs)) % bls.R)
        if result != expect:
            raise AssertionError("2^20 MSM disagrees with the known-dlog "
                                 "result")
        widths = timings.pop("level_pairs")
        require("2^20 MSM", launches, widths, thr)
        secs.append(dt)
        main_runs.append((launches, widths))
        phase("msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=timings, correct=True)
    main_launches, main_widths = main_runs[0]
    med = statistics.median(secs)
    phase("msm", n=n, c=16, runs=MSM_RUNS, seconds=secs, median_s=med,
          spread=max(secs) / min(secs), points_per_s=n / med,
          level_pairs=main_widths, chunk_min_pairs=thr,
          bench_points_seconds=round(t_points, 3), card=repr(card),
          correct=True)

    # ---- edge MSMs on the card: the small-MSM path --------------------
    G = bls.G1.generator()
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
    edge_widths = t_dup["level_pairs"] + t_eq["level_pairs"]
    require("edge MSM", edge_launches, edge_widths, thr)
    phase("edge_msm", duplicate_bases=True, all_equal_scalars_n=m_eq,
          level_pairs=edge_widths, correct=True)
    phase("launches", msm_2_20=main_launches, edge_msm=edge_launches)
    never = [f.__name__ for f in counted
             if not main_launches[f.__name__] and not
             edge_launches[f.__name__]]
    if never:
        raise AssertionError(f"kernels launched on no path: {never}")

    # ---- kernels vs plain, at the shapes a path gave them -------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pts = points.X.shape[1]
    paths = {"msm_2^20": (main_launches, main_widths),
             "edge_msm": (edge_launches, edge_widths)}

    def source(name: str) -> str:
        """The path whose launches and shapes a kernel's row reports: the
        2^20 MSM where it ran there, else the edge MSMs."""
        return "msm_2^20" if main_launches[name] else "edge_msm"

    def level_inputs(M: int):
        """M pairs of real points: generic pairs, doublings, P + (-P) and
        infinite operands on either or both sides."""
        i1 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        i2 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        lane = torch.arange(M, device=dev)
        i2 = torch.where(lane % 7 < 2, i1, i2)             # same x
        x1, y1 = points.X[:, i1], points.Y[:, i1]
        x2, y2 = points.X[:, i2], points.Y[:, i2]
        y2 = torch.where((lane % 7 == 1)[None], F.neg(y2), y2)   # P + (-P)
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    def row(name, src, rep, launches, err, ms, plain_ms, bound, shape,
            path):
        return dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                    library_ms=None, path=path, shape=shape)

    rows = []

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
        kern = fk.mont_mul(ra, rb, Fx.mod)
        err = max_err((kern,), (fk.mont_mul_plain(ra, rb, Fx.mod),))
        if err:
            raise AssertionError(f"mont_mul disagrees on {fld.name}")
        if fld is bls.Fq:
            path = source("mont_mul")
            rows.append(row(
                "mont_mul", "crypto_tpu_torch/csrc/mont_mul.cu",
                "crypto_tpu/ops/pallas/field_kernels.py:386",
                paths[path][0]["mont_mul"], err,
                cuda_ms(lambda: fk.mont_mul(ra, rb, Fx.mod)),
                cuda_ms(lambda: fk.mont_mul_plain(ra, rb, Fx.mod), reps=2),
                bound_ms(3 * FQ_BYTES * M, (2 * L * L + L) * M), [L, M],
                path))
    phase("check_mont_mul", fq_pairs=16 << 15, fr_pairs=1 << 16,
          bit_exact=True)

    def check_pre_post(M: int, path: str | None):
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        kd = ck.affine_level_pre(F, x1, y1, m1, x2, y2, m2)
        e_pre = max_err(kd, ck.affine_level_pre_plain(F, x1, y1, m1, x2, y2,
                                                      m2))
        if e_pre:
            raise AssertionError(f"affine_level_pre disagrees at M={M}")
        dinv = msm_v2.batch_inv_t(F, kd[0])
        args = (x1, y1, x2, y2, dinv, kd[1], m1, m2)
        kp = ck.affine_level_post(F, *args)
        e_post = max_err(kp, ck.affine_level_post_plain(F, *args))
        if e_post:
            raise AssertionError(f"affine_level_post disagrees at M={M}")
        if path is None:
            return
        ndbl = int(kd[1].sum())
        src = "crypto_tpu_torch/csrc/affine_level.cu"
        rep = "crypto_tpu/ops/pallas/curve_kernels.py:"
        count = paths[path][0]
        rows.append(row(
            "affine_level_pre", src, rep + "533", count["affine_level_pre"],
            e_pre,
            cuda_ms(lambda: ck.affine_level_pre(F, x1, y1, m1, x2, y2, m2)),
            cuda_ms(lambda: ck.affine_level_pre_plain(
                F, x1, y1, m1, x2, y2, m2), reps=2),
            bound_ms(M * (5 * FQ_BYTES + 16), 0), [12, M], path))
        rows.append(row(
            "affine_level_post", src, rep + "548", count["affine_level_post"],
            e_post, cuda_ms(lambda: ck.affine_level_post(F, *args)),
            cuda_ms(lambda: ck.affine_level_post_plain(F, *args), reps=2),
            bound_ms(M * (7 * FQ_BYTES + 12), (3 * M + ndbl) * 300),
            [12, M], path))

    path = source("affine_level_pre")
    w_pre = max(w for w in paths[path][1] if w < thr)
    pre_widths = [w_pre, w_pre - 3 if w_pre > 3 else w_pre + 3]
    if path != "msm_2^20":
        pre_widths.append(min(main_widths))     # also at a 2^20 level width
    check_pre_post(pre_widths[0], path)
    for w in pre_widths[1:]:
        check_pre_post(w, None)
    phase("check_affine_level", pairs=pre_widths, path=path, bit_exact=True)

    def check_chunked(M: int, path: str | None):
        pad = (-M) % msm_v2.CHUNK_PAD
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        x1, y1, x2, y2 = (msm_v2._pad_cols(t, pad, 0)
                          for t in (x1, y1, x2, y2))
        m1, m2 = msm_v2._pad_cols(m1, pad, 1), msm_v2._pad_cols(m2, pad, 1)
        Mp = M + pad
        kq = ck.chunked_level_prefix(F, x1, y1, m1, x2, y2, m2)
        e_pre = max_err(kq, ck.chunked_level_prefix_plain(F, x1, y1, m1, x2,
                                                          y2, m2))
        if e_pre:
            raise AssertionError(f"chunked_level_prefix disagrees at M={M}")
        tinv = msm_v2.batch_inv_t(F, kq[1])
        args = (x1, y1, m1, x2, y2, m2, kq[0], tinv, kq[2])
        kd = ck.chunked_level_down(F, *args)
        e_post = max_err(kd, ck.chunked_level_down_plain(F, *args))
        if e_post:
            raise AssertionError(f"chunked_level_down disagrees at M={M}")
        if path is None:
            return
        K = ck.CHUNK_K
        ndbl = int(kq[2].sum())
        src = "crypto_tpu_torch/csrc/chunked_level.cu"
        rep = "crypto_tpu/ops/pallas/curve_kernels.py:"
        count = paths[path][0]
        rows.append(row(
            "chunked_level_prefix", src, rep + "844",
            count["chunked_level_prefix"], e_pre,
            cuda_ms(lambda: ck.chunked_level_prefix(F, x1, y1, m1, x2, y2,
                                                    m2)),
            cuda_ms(lambda: ck.chunked_level_prefix_plain(
                F, x1, y1, m1, x2, y2, m2), reps=1),
            bound_ms(Mp * (5 * FQ_BYTES + 16) + Mp // K * FQ_BYTES,
                     (Mp - Mp // K) * 300), [12, Mp], path))
        rows.append(row(
            "chunked_level_down", src, rep + "860",
            count["chunked_level_down"], e_post,
            cuda_ms(lambda: ck.chunked_level_down(F, *args)),
            cuda_ms(lambda: ck.chunked_level_down_plain(F, *args), reps=1),
            bound_ms(Mp * (7 * FQ_BYTES + 12) + Mp // K * FQ_BYTES,
                     (2 * (Mp - Mp // K) + 3 * Mp + ndbl) * 300),
            [12, Mp], path))

    path = source("chunked_level_prefix")
    w_chunk = min(w for w in paths[path][1] if w >= thr)
    check_chunked(w_chunk, path)
    check_chunked(w_chunk + 5, None)
    phase("check_chunked_level", pairs=[w_chunk, w_chunk + 5], path=path,
          bit_exact=True)

    # ---- device busy share of one more 2^20 MSM, by torch.profiler -----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        msm_v2.msm_device_scheduled(bls.G1, points, sb, c=16)
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
    phase("profile", wall_s=round(wall, 4),
          device_busy_s=round(busy, 4) if busy else "not measured",
          idle_share=round(1 - busy / wall, 4) if busy else "not measured",
          device_launches=len(spans),
          top_ms=[(name, cnt, round(us / 1e3, 3)) for name, (cnt, us) in top])

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
