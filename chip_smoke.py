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
  sum with no rerun;
* the QAP witness map's device half, `qap_h`, on a 2^20 domain (random
  rows a, b and c = a b): each NTT timed, intt(ntt(a)) == a, 8 NTT
  outputs against Horner and the QAP identity at a random tau;
* the LegoGroth16 north-star workload (`benches/bench_northstar.py`):
  the setup of a 2^16 - 4 constraint chain circuit with one committed
  witness from explicit trapdoors (fixed-base tables and products on the
  card, host normalisation, timed apart), one warm-up and two timed
  proves (witness map and each query MSM timed), each proof checked in
  the exponent against its discrete logs and the verification equation,
  and every device MSM against its known logs; one more prove profiled;
* the pairing at `benches/bench_pairing.py`'s size: a 64-pair
  multi-pairing (plus one pair with G1 at infinity) through `TPairing`,
  once cold and twice timed on fresh pairs from known logs, each
  product against its log; the first set's per-pair Miller values
  against the host Miller loop and its product against the host
  multi-pairing; e(aP, bQ) == e(abP, Q) and e(aP, Q) e(-aP, Q) == 1; a
  lazy `RandomizedPairingChecker` with 64 deferred pairs through the
  device Miller product, valid and with one spoiled pair; the BBS+ batch
  verify of 1,024 signatures over 4 messages (known logs, the pairing on
  the device), its two MSMs against their logs, valid and with one e
  spoiled; one more multi-pairing profiled;
* BASELINE config 2, BBS+ proofs of knowledge over 32 messages (4
  revealed): `batch_verify_proofs` of 256 proofs (252 from the protocol's
  algebra over known logs, 4 through the port's `SignatureG1.new` and
  `PoKOfSignatureG1Protocol`, their sign, prove and host verify timed),
  the pairing on the device, cold (both MSMs against their known logs)
  and warm (host checker, device MSMs and pairing timed apart), and two
  spoiled sets rejected (a response off by one; a proof under another
  key, which passes the mult checker and fails the pairing); one lazy
  checker on the card with 16 PoKs, 4 signatures and 2 BBS23 PoKs (44
  deferred pairs), valid and with one signature spoiled;
* the VB accumulator at `benches/bench_accumulator.py`'s size: params
  hashed from a label, 2^14 elements added, the first 8,192 members'
  witnesses on the device fixed-base path, then three updates of all
  8,192 witnesses through `update_membership_batch_with_sk` on the card
  (256 additions, cold and warm; 256 removals; 128 of each), each split
  by phase and held to V_new / (y + alpha) from the fixed-base table, its
  d factors to host integers, 16 members to the host branch and two by
  pairing; one more update profiled;
* BN254 at the reference's sizes, every kernel at its 8-limb
  instantiation: 2^20 G1 bench points with known logs (the total
  `TCurve` ops), three timed 2^20 MSMs at c = 16 on the fast levels, one
  `safe=True`, the rerun path (one duplicated base: exactly the spoiled
  windows rerun) and the G1 and G2 edge MSMs; the LegoGroth16 setup,
  warm-up, two timed and one profiled prove of the 2^16 - 4 constraint
  chain circuit over BN254 Fr (each checked in the exponent), and the
  port's verifier on a proof (valid, spoiled input and C rejected, D
  opened, both rerandomisations verified); the 64-pair `TPairingBN`
  multi-pairing, cold and twice timed, against e(G1, G2)^(sum a_i b_i)
  from the host pairing; the BN254 paths together must launch every
  8-limb instantiation and no point kernel.  The BLS12-381 prove phase
  also runs the port's verifier (`legogroth16_verify`).

Every MSM builds its two point-major slot tables with the table kernel,
once, and lays out its bucket slots from them through the row gather
kernel.  Then it
holds every kernel against its plain PyTorch version bit for bit at the
shapes a path gave it (both chunked levels also on inputs whose every
warp holds an infinite operand, the full add also on warps that each hold
one kind of pair: P1, P2 or both infinite, P + P, P + (-P); the double
also with Y1 = 0 lanes; the normalize also at ragged widths about its
chunk and block, on infinities only and with infinities at both ends of
every thread's chunk; the Fq2 square also on a0 = a1 and a1 = 0; mont_mul
also at the 2^20 NTT's Fr shapes and the witness update's; the Fq2 mul
and square, mont_mul and mont_pow also at the pairing's narrow widths
(those three also at the PoK batch verify's 2 lanes and the PoK
checker's 44; the fast levels at every width of the PoK batch verify's
MSMs),
mont_pow also at the witness update's to_affine; every 8-limb
instantiation at the BN254 paths' shapes, the same way), times the fast
down pass at each of
the 2^20 MSM's level widths and the Fq2 square from the G2 tail's widest
call down to 16 elements, profiles one more 2^20 G1 MSM on each
formula and one more G2 MSM for the device's busy share and each
kernel's device time against its summed bound (the bound summed by
shims over the same profiled run, its data-dependent part after the
profile closes), and ranks the affine
level's kernels (total and fast) on the edge MSMs and the prove by their
device time a launch against a latency floor.  It fails if a kernel of
a path was not launched on it.  One line per phase, each ending with
its time since the start (`at_s`); before the last line
the card's name and power limit and a JSON object of the kernels'
launches and times; the last line is the result object.  Exits non-zero on any failure, and when
there is no CUDA device.
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
FQ_LIMBS = 12                       # BLS12-381 Fq; BN254 Fq takes 8
# 32x32 -> 64-bit products, the fewest known for each function on L
# limbs: a Montgomery mul (CIOS) and a Montgomery square (a wide square,
# the cross products once and the squares, and a reduction), an Fq2
# product (three unreduced L x L products and two reductions) and an Fq2
# square (Karatsuba on three wide squares and two reductions).  Every
# square of a function is charged as a square, whatever a kernel runs.


def mul_products(L: int) -> int:
    return 2 * L * L + L


def sqr_products(L: int) -> int:
    return L * (L + 1) // 2 + L * L + L


def fq2_mul_products(L: int) -> int:
    return 3 * L * L + 2 * (L * L + L)


def fq2_sqr_products(L: int) -> int:
    return 3 * (L * (L + 1) // 2) + 2 * (L * L + L)


# CUDA kernel function -> the entry point that launches it
KERNEL_ENTRY = {
    "mont_mul_kernel": "mont_mul", "mont_pow_kernel": "mont_pow",
    "pre_kernel": "affine_level_pre", "post_kernel": "affine_level_post",
    "prefix_kernel": "chunked_level_prefix",
    "down_kernel": "chunked_level_down",
    "pre_fast_kernel": "affine_level_pre_fast",
    "post_fast_kernel": "affine_level_post_fast",
    "prefix_fast_kernel": "chunked_level_prefix_fast",
    "down_fast_kernel": "chunked_level_down_fast",
    "full_add_kernel": "jacobian_add", "mixed_add_kernel": "jacobian_add_mixed",
    "double_kernel": "jacobian_double", "normalize_kernel": "jacobian_normalize",
    "fq2_mul_kernel": "fq2_mul", "fq2_sqr_kernel": "fq2_sqr",
    "pre_fq2_kernel": "affine_level_pre_fq2",
    "post_fq2_kernel": "affine_level_post_fq2",
    "gather_rows_t_kernel": "gather_rows_t",
    "slot_tables_kernel": "slot_tables",
}


STARTED = time.monotonic()


def phase(name: str, **kv) -> None:
    """One line `[name] key=value ...`, ending with `at_s`, the seconds
    since the script started."""
    kv["at_s"] = round(time.monotonic() - STARTED, 1)
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


def chain_ops(e: int) -> tuple:
    """(squares, products) of a short addition chain for x^e: a sliding
    window over e's bits (x^2 and the odd powers below 2^w, then a square
    per bit and a product per window), the fewest steps over widths 1 to
    8.  Width 1 is the binary chain that mont_pow runs (608 steps for p -
    2); the best width takes 460 for p - 2 (width 5, the normalize's
    chain) and 312 for r - 2, so the bound counts the chain the function
    needs, not the one it runs."""
    bits, best = bin(e)[2:], None
    for w in range(1, 9):
        sq, mul = (1, 2 ** (w - 1) - 1) if w > 1 else (0, 0)
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                sq, i = sq + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            if not first:
                sq, mul = sq + j - i, mul + 1
            i, first = j, False
        if best is None or (sq + mul, mul) < (sum(best), best[1]):
            best = (sq, mul)
    return best


def work(name: str, args: tuple) -> tuple:
    """(bytes, 32x32 -> 64-bit products) that one launch of entry point
    `name` on wrapper arguments `args` needs at least: each input read
    once, each output written once; data-dependent work (doublings,
    gathered columns) counted from these inputs."""
    if name in ("mont_mul", "mont_pow"):
        L, M = args[0].shape          # 12 limbs (BLS12-381 Fq) or 8
        if name == "mont_mul":
            return 3 * 4 * L * M, mul_products(L) * M
        sq, mul = chain_ops(args[1])
        return 2 * 4 * L * M, (sq * sqr_products(L)
                               + mul * mul_products(L)) * M
    if name == "gather_rows_t":
        payload, idx = args             # (N, C) rows, (M,) int64
        live = idx[(idx >= 0) & (idx < payload.shape[0])]
        rows = int(torch.unique(live).numel())
        return 4 * payload.shape[1] * (rows + idx.shape[0]) \
            + 8 * idx.shape[0], 0
    if name == "slot_tables":   # (F, x, y (U, N)) -> (N, U), (2N, U) rows
        return 5 * 4 * args[1].numel(), 0
    from crypto_tpu_torch.ops.kernels.curve_kernels import CHUNK_K
    L = args[0].L                        # args[0] is the field context
    FQ_BYTES, FQ2_BYTES = 4 * L, 8 * L   # an Fq and an Fq2 element
    MUL, SQR = mul_products(L), sqr_products(L)
    FQ2_MUL, FQ2_SQR = fq2_mul_products(L), fq2_sqr_products(L)
    M = args[1].shape[1]
    strips, totals = M - M // CHUNK_K, M // CHUNK_K * FQ_BYTES
    return {
        "fq2_mul": lambda: (3 * FQ2_BYTES * M, FQ2_MUL * M),
        "fq2_sqr": lambda: (2 * FQ2_BYTES * M, FQ2_SQR * M),
        "affine_level_pre": lambda: (M * (5 * FQ_BYTES + 16), 0),
        "affine_level_post": lambda: (M * (7 * FQ_BYTES + 12),
                                      2 * M * MUL
                                      + (M + int(args[6].sum())) * SQR),
        "affine_level_pre_fast": lambda: (M * (3 * FQ_BYTES + 12), 0),
        "affine_level_post_fast": lambda: (M * (7 * FQ_BYTES + 8),
                                           M * (2 * MUL + SQR)),
        "affine_level_pre_fq2": lambda: (M * (5 * FQ2_BYTES + 16), 0),
        "affine_level_post_fq2": lambda: (
            M * (7 * FQ2_BYTES + 12),
            (2 * FQ2_MUL + FQ2_SQR) * M + FQ2_SQR * int(args[6].sum())),
        "chunked_level_prefix": lambda: (M * (5 * FQ_BYTES + 16) + totals,
                                         strips * MUL),
        "chunked_level_down": lambda: (
            M * (7 * FQ_BYTES + 12) + totals,
            (2 * strips + 2 * M) * MUL + (M + int(args[9].sum())) * SQR),
        "chunked_level_prefix_fast": lambda: (
            M * (3 * FQ_BYTES + 12) + totals, strips * MUL),
        "chunked_level_down_fast": lambda: (M * (7 * FQ_BYTES + 8) + totals,
                                            (2 * strips + 2 * M) * MUL
                                            + M * SQR),
        "jacobian_add": lambda: (M * (9 * FQ_BYTES + 4),
                                 M * (11 * MUL + 5 * SQR)),
        "jacobian_add_mixed": lambda: (M * (7 * FQ_BYTES + 4),
                                       M * (4 * MUL + 2 * SQR)),
        "jacobian_double": lambda: (M * 6 * FQ_BYTES,
                                    M * (2 * MUL + 5 * SQR)),
        # Montgomery's trick: a point's prefix product, the two products
        # of the walk back, z^-2 (a square), z^-3, x z^-2 and y z^-3; one
        # Fermat chain for the whole batch
        "jacobian_normalize": lambda: (
            M * 6 * FQ_BYTES, M * (6 * MUL + SQR)
            + chain_ops(args[0].p - 2)[0] * SQR
            + chain_ops(args[0].p - 2)[1] * MUL),
    }[name]()


def normalize_cases(z, k: int, T: int) -> dict:
    """{case: Z} over the columns of z, a (12, n) batch of Z coordinates,
    for the normalize kernel with chunks of k points and blocks of T
    threads (a thread's chunk strides by T over the block's k*T points):
    ragged widths about k and k*T, a batch of infinities, and, at n - 5,
    Z = 0 at the first and the last point of every thread's chunk and
    over the whole of one block."""
    n = z.shape[1]
    span = k * T
    widths = sorted({1, 2, k - 1, k + 1, T - 1, T + 1, span - 1, span + 3,
                     n - 5} - {0})
    zs = {f"M={M}": z[:, :M].contiguous() for M in widths}
    zs["all infinite"] = torch.zeros_like(z)
    M = n - 5
    lane = torch.arange(M, device=z.device)
    first = lane // span * span + lane % T          # the chunk's first point
    step = lane % span // T
    last = torch.clamp((M - 1 - first) // T + 1, max=k) - 1
    ends = (step == 0) | (step == last) | (lane // span == 3)
    zs["chunk ends infinite"] = torch.where(ends[None], 0, z[:, :M])
    return zs


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
# mont_mul and mont_pow (the norm and the base-field Fermat root of every
# Fq2 inversion)
G2_KERNELS = ("gather_rows_t", "affine_level_pre_fq2",
              "affine_level_post_fq2", "fq2_mul", "fq2_sqr", "mont_mul",
              "mont_pow", "slot_tables")
FQ2_KERNELS = G2_KERNELS[1:5]


def level_kernels(fast_widths, safe_widths, threshold: int) -> set:
    """The kernels a G1 run dispatches to: the gather, mont_mul and
    mont_pow (the Fermat roots) always, the chunked level for calls of at
    least `threshold` pairs, pre/post for the narrower ones; the fast
    variants for the fast calls, the total formula for the rerun's."""
    names = {"slot_tables", "gather_rows_t", "mont_mul", "mont_pow"}
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


# the wrapper argument whose values (not only its shape) a launch's
# `work` reads: the gather's index, the posts' and down passes' doubling
# flags
DATA_ARG = {"gather_rows_t": 1, "affine_level_post": 6,
            "affine_level_post_fq2": 6, "chunked_level_down": 9}


def record_work(counted, fn):
    """fn() with every counted wrapper replaced, in each module of the
    port that holds it, by a shim that sums `work` over the calls that
    launched; returns fn()'s result and {name: [launches, summed bound
    ms]}.  The wrappers' own counts go to the shims meanwhile.  A shim
    runs nothing on the card: a launch whose work depends on data keeps
    that one argument (the rest as shapes on the meta device) and its
    work is summed once fn() has returned, so a profile in fn() sees
    the wrappers' own launches only."""
    totals = {f.__name__: [0, 0.0] for f in counted}
    shims, pending = {}, []
    for f in counted:
        def shim(*args, _f=f):
            before = shims[_f].launches
            out = _f(*args)
            if shims[_f].launches > before:
                name = _f.__name__
                totals[name][0] += 1
                if name in DATA_ARG:
                    k = DATA_ARG[name]
                    pending.append((name, tuple(
                        torch.empty(a.shape, device="meta")
                        if i != k and isinstance(a, torch.Tensor) else a
                        for i, a in enumerate(args))))
                else:
                    totals[name][1] += bound_ms(*work(name, args))[0]
            return out
        shim.launches = 0
        shim.__name__ = f.__name__
        shims[f] = shim
    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("crypto_tpu_torch"):
            continue
        for k, v in list(vars(mod).items()):
            if callable(v) and v in shims:
                patched.append((mod, k, v))
                setattr(mod, k, shims[v])
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for mod, k, v in patched:
            setattr(mod, k, v)
    for name, args in pending:
        totals[name][1] += bound_ms(*work(name, args))[0]
    return out, totals


def device_events(prof) -> list:
    """(name, start ns, end ns) of every device event of a finished
    profile, read from its raw kineto results: the profiler's own event
    tree (`events()`, `key_averages()`) takes minutes to build for the
    half a million launches of a witness update."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def device_ms_by_entry(events: list) -> dict:
    """{entry point: (kernels, device ms)} from `device_events`, summed
    over each entry point's kernel functions."""
    out = {}
    for key, start, end in events:
        hit = re.search(r"(\w+_kernel)\b", key)
        name = KERNEL_ENTRY.get(hit.group(1)) if hit else None
        if name is None:
            continue
        cnt, ms = out.get(name, (0, 0.0))
        out[name] = (cnt + 1, ms + (end - start) / 1e6)
    return out


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


def device_profile(name: str, fn, cpu: bool = True) -> dict:
    """fn() under the profiler: prints its wall time, the device's busy
    time and idle share and the six kernels with the most device time;
    returns `device_ms_by_entry` of the profile.  `cpu=False` traces the
    device alone (a run of many host ops, whose trace takes long to
    read)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events, by_name = device_events(prof), {}
    for key, start, end in events:
        k = by_name.setdefault(key[:48], [0, 0])
        k[0] += 1
        k[1] += (end - start) / 1e3
    busy_ns, reach = 0, None          # union of the kernels' intervals
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    busy = busy_ns / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    phase(name, wall_s=round(wall, 4),
          device_busy_s=round(busy, 4) if busy else "not measured",
          idle_share=round(1 - busy / wall, 4) if busy
          else "not measured",
          device_launches=len(events),
          top_ms=[(k, cnt, round(us / 1e3, 3))
                  for k, (cnt, us) in top])
    return device_ms_by_entry(events)


QAP_LOG = 20                        # the G2 cell's circuit: 2^20 variables
LEGO_LOG = 16                       # BASELINE.json: the prove at 2^16
PROVE_RUNS = 2                      # timed proves after one warm-up
# what a LegoGroth16 prove launches: the NTTs' mont_mul; the G1 query
# MSMs' fast chunked levels, gather, slot tables and Fermat roots; the
# b_g2 MSM's Fq2 level, mul and square.  The setup's fixed-base tables
# run the total TCurve ops: mont_mul on G1, the Fq2 mul and square on G2.
PROVE_KERNELS = ("mont_mul", "mont_pow", "chunked_level_prefix_fast",
                 "chunked_level_down_fast", "affine_level_pre_fq2",
                 "affine_level_post_fq2", "fq2_mul", "fq2_sqr",
                 "gather_rows_t", "slot_tables")
SETUP_KERNELS = ("mont_mul", "fq2_mul", "fq2_sqr")
POINT_KERNELS = ("jacobian_add", "jacobian_add_mixed", "jacobian_double",
                 "jacobian_normalize")


def chain_circuit(nc: int, x_val=None, F=None):
    """`benches/bench_northstar.py` `chain_circuit` on the port's R1CS:
    x_{i+1} = x_i^2 + x_i + i over nc constraints of the scalar field F
    (BLS12-381's by default), x the first witness, the last value the one
    public input."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.r1cs.cs import LinearCombination as LC
    F = F or bls.Fr

    def circuit(cs):
        vals = None
        if x_val is not None:
            vals = [x_val]
            for i in range(nc):
                v = vals[-1]
                vals.append(v * v + v + F(i))
        out = cs.new_input(None if vals is None else vals[-1])
        cur = cs.new_witness(x_val)
        for i in range(nc):
            if i == nc - 1:
                nxt, nxt_lc = None, out.lc()
            else:
                nxt = cs.new_witness(None if vals is None else vals[i + 1])
                nxt_lc = nxt.lc()
            cs.enforce(cur.lc(), cur.lc() + LC.constant(F, 1),
                       nxt_lc + LC.constant(F, -i % F.p))
            if nxt is not None:
                cur = nxt
    return circuit


def horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def qap_h_phase(counted, dev) -> dict:
    """`qap_h` on a 2^20 domain: random rows a, b and c = a b from the
    seed, each NTT timed on its own, checked on the host (intt(ntt(a)) ==
    a exactly, 8 ntt outputs against Horner at w^j, and A(tau) B(tau) -
    C(tau) = h(tau) (tau^n - 1) at a random tau, A(tau) from the Lagrange
    coefficients).  Returns the path's launches."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    from crypto_tpu_torch.ops.ntt import domain_for
    n, R = 1 << QAP_LOG, bls.R
    hr = random.Random(SEED + 80)
    t0 = time.perf_counter()
    a = [hr.randrange(R) for _ in range(n)]
    b = [hr.randrange(R) for _ in range(n)]
    c = [x * y % R for x, y in zip(a, b)]
    dom = domain_for(bls.Fr, n, dev)
    T = dom.T
    pa, pb, pc = T.pack(a), T.pack(b), T.pack(c)
    dom.coset_ntt(pa)                           # builds the coset tables
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        out = snark.qap_h(dom, pa, pb, pc)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (h, t_qap), launches = drive(counted, run)
    require("qap_h 2^20", launches, ("mont_mul",))
    per_ntt = {}
    for name in ("ntt", "intt", "coset_ntt", "coset_intt", "ntt", "intt"):
        fn = getattr(dom, name)
        before = fk.mont_mul.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(pa)
        torch.cuda.synchronize()
        per_ntt.setdefault(name + "_s", []).append(time.perf_counter() - t)
        per_ntt[name + "_mont_mul_launches"] = fk.mont_mul.launches - before
    fwd = dom.ntt(pa)
    if not torch.equal(dom.intt(fwd), pa):
        raise AssertionError("intt(ntt(a)) != a at 2^20")
    js = sorted(random.Random(SEED + 81).sample(range(n), 8))
    got = np.atleast_1d(T.unpack(fwd[:, js]))
    if any(int(g) != horner(a, pow(dom.w, j, R), R) for g, j in zip(got, js)):
        raise AssertionError("2^20 ntt disagrees with Horner at w^j")
    t0 = time.perf_counter()
    tau = hr.randrange(R)
    lag = snark._lagrange_coeffs_at(dom, tau)
    A, B, C = (sum(x * y for x, y in zip(v, lag)) % R for v in (a, b, c))
    hv = [int(v) for v in np.atleast_1d(T.unpack(h))]
    if (A * B - C) % R != horner(hv, tau, R) * (pow(tau, n, R) - 1) % R \
            or hv[-1] != 0:
        raise AssertionError("2^20 qap_h: A B - C != h Z_H at tau")
    phase("qap_h_2^20", n=n, qap_h_s=t_qap, setup_s=t_setup,
          mont_mul_launches=launches["mont_mul"], **per_ntt,
          ntt_samples=js, check_s=time.perf_counter() - t0,
          correct=True)
    return launches


def qap_at(cs, lag: list, p: int) -> tuple:
    """The QAP's per-variable a_i(tau), b_i(tau), c_i(tau), from the
    Lagrange coefficients at tau: the CRS's discrete logs."""
    nvars = cs.num_instance + cs.num_witness
    out = ([0] * nvars, [0] * nvars, [0] * nvars)
    for rows, vec in zip((cs.a_rows, cs.b_rows, cs.c_rows), out):
        for i, row in enumerate(rows):
            for coeff, idx in row:
                vec[idx] = (vec[idx] + lag[i] * coeff) % p
    for j in range(cs.num_instance):
        out[0][j] = (out[0][j] + lag[cs.num_constraints + j]) % p
    return out


def legogroth16_phases(counted, dev, mod=None, tag: str = "") -> dict:
    """The north-star workload (`benches/bench_northstar.py`) over the
    port's curve module `mod` (BLS12-381 by default; BN254 with tag
    "bn254_"): `chain_circuit` at 2^16 - 4 constraints, one committed
    witness.  The setup from explicit trapdoors, then one warm-up prove
    and `PROVE_RUNS` timed ones, each checked in the exponent: every proof
    element equals its discrete log (from the trapdoors, the replayed
    rng's tau, r, s and v, and the assignment) times the generator, the
    logs satisfy the verification equation A B = alpha beta + gamma
    (inputs + D) + delta C, and every device MSM equals the sum of its
    scalars times its points' known logs.  Then the port's verifier on
    the last proof (`verify_phase`).  Returns ({path: launches}, the
    profiled prove's `device_ms_by_entry`)."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.ops import fixed_base
    from crypto_tpu_torch.ops.ntt import domain_for
    from crypto_tpu_torch.r1cs.cs import ConstraintSystem
    mod = mod or bls
    F, R = mod.Fr, mod.R
    G1, G2 = mod.G1.generator(), mod.G2.generator()
    nc = (1 << LEGO_LOG) - 4
    N = 1 << LEGO_LOG
    hr = random.Random(SEED + 90)
    alpha, beta, gamma, delta, eta = (hr.randrange(1, R) for _ in range(5))
    setup_seed = SEED + 91

    # ---- setup: the tables, then generate_parameters_with_trapdoors with
    # its fixed-base products, the device part of each, and its host
    # normalisation timed apart
    spent = dict.fromkeys(("tables_s", "mul_many_s", "fixed_base_many_s",
                           "normalize_s"), 0.0)
    real_fb, real_norm = snark._fixed_base_many, snark._normalized
    real_mm = fixed_base.FixedBaseTable.mul_many

    def timer(key, fn, sync=False):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return timed

    def setup():
        t = time.perf_counter()
        for g in (G1, G2):
            fixed_base.table_for(g.curve, g, device=dev)
        torch.cuda.synchronize()
        spent["tables_s"] = time.perf_counter() - t
        return snark.generate_parameters_with_trapdoors(
            chain_circuit(nc, F=F), 1, random.Random(setup_seed),
            *(F(x) for x in (alpha, beta, gamma, delta, eta)), ctx=mod,
            device=dev)

    snark._fixed_base_many = timer("fixed_base_many_s", real_fb)
    snark._normalized = timer("normalize_s", real_norm)
    fixed_base.FixedBaseTable.mul_many = timer("mul_many_s", real_mm, True)
    try:
        t0 = time.perf_counter()
        pk, setup_launches = drive(counted, setup)
        t_setup = time.perf_counter() - t0
    finally:
        snark._fixed_base_many, snark._normalized = real_fb, real_norm
        fixed_base.FixedBaseTable.mul_many = real_mm
    require(f"{tag}LegoGroth16 setup", setup_launches, SETUP_KERNELS)

    # the CRS's discrete logs, from the trapdoors and the replayed tau
    t0 = time.perf_counter()
    rr = random.Random(setup_seed)
    while True:
        tau = int(F.rand(rr))
        if (pow(tau, N, R) - 1) % R:
            break
    cs0 = ConstraintSystem(F, mode="setup")
    chain_circuit(nc, F=F)(cs0)
    lag = snark._lagrange_coeffs_at(domain_for(F, N, dev), tau, F)
    qa, qb, qc = qap_at(cs0, lag, R)
    n_inst = cs0.num_instance
    n_commit = n_inst + 1
    zt = (pow(tau, N, R) - 1) % R
    gi, di = pow(gamma, -1, R), pow(delta, -1, R)
    lin = [(beta * x + alpha * y + z) % R for x, y, z in zip(qa, qb, qc)]
    dlogs = {"a_query": qa, "b_g1_query": qb, "b_g2_query": qb,
             "h_query": [zt * di * pow(tau, i, R) % R for i in range(N - 1)],
             "l_query": [x * di % R for x in lin[n_commit:]]}
    gamma_abc = [x * gi % R for x in lin[:n_commit]]
    sample = random.Random(SEED + 92)
    checked = 0
    for name, logs in dlogs.items():
        pts = getattr(pk, name)
        if len(pts) != len(logs):
            raise AssertionError(f"setup: {name} has {len(pts)} points, "
                                 f"{len(logs)} expected")
        G = G2 if name == "b_g2_query" else G1
        for i in sample.sample(range(len(pts)), 8) + [0, len(pts) - 1]:
            checked += 1
            if pts[i] != G.mul_raw(logs[i]):
                raise AssertionError(f"setup: {name}[{i}] is not its log "
                                     f"times the generator")
    vk = pk.vk
    if (vk.gamma_abc_g1 != [G1.mul_raw(x) for x in gamma_abc]
            or vk.alpha_g1 != G1.mul_raw(alpha)
            or vk.delta_g2 != G2.mul_raw(delta)
            or pk.delta_g1 != G1.mul_raw(delta)
            or vk.eta_gamma_inv_g1 != G1.mul_raw(eta * gi % R)):
        raise AssertionError("setup: a key element is not its log times "
                             "the generator")
    phase(f"{tag}legogroth16_setup", constraints=nc, domain=N, seconds=t_setup,
          tables_s=spent["tables_s"], mul_many_device_s=spent["mul_many_s"],
          fixed_base_many_s=spent["fixed_base_many_s"],
          normalize_host_s=spent["normalize_s"],
          other_s=t_setup - spent["tables_s"] - spent["fixed_base_many_s"]
          - spent["normalize_s"],
          queries={k: len(getattr(pk, k)) for k in dlogs},
          launches={k: setup_launches[k] for k in SETUP_KERNELS},
          points_checked=checked, check_s=time.perf_counter() - t0,
          correct=True)

    # ---- the proves: the witness map and each query MSM timed (as
    # bench_northstar.py splits them), every MSM and the witness map's h
    # recorded for the checks
    x = F(hr.randrange(R))
    cs1 = ConstraintSystem(F, mode="prove")
    chain_circuit(nc, x, F)(cs1)
    z = [int(v) for v in cs1.full_assignment()]
    az, bz = (sum(u * v for u, v in zip(z, q)) % R for q in (qa, qb))
    lin_z = [u * v % R for u, v in zip(z, lin)]
    inputs_z, committed_z = sum(lin_z[:n_inst]), sum(lin_z[n_inst:n_commit])
    uncommitted_z = sum(lin_z[n_commit:]) % R
    record = {}
    real_wm, real_mq = snark.witness_map, snark._msm_query

    def wm(*args, **kw):
        t = time.perf_counter()
        out = real_wm(*args, **kw)
        record["witness_map_s"] = time.perf_counter() - t
        record["h"] = out
        return out

    def mq(pk_, name, scalars, offset=0, **kw):
        t = time.perf_counter()
        out = real_mq(pk_, name, scalars, offset, **kw)
        record[f"msm_{name}_s"] = time.perf_counter() - t
        record.setdefault("msms", []).append(
            (name, [int(s) for s in scalars], offset, out))
        return out

    def create(seed: int):
        record.clear()
        t = time.perf_counter()
        out = snark.create_proof(chain_circuit(nc, x, F), pk,
                                 random.Random(seed), ctx=mod, device=dev)
        return out, time.perf_counter() - t

    last = []

    def prove(seed: int):
        (proof, v, committed), total = create(seed)
        check_proof(seed, proof, int(v), committed)
        last[:] = [proof, v, committed]
        split = {k: v_ for k, v_ in record.items() if k.endswith("_s")}
        split["other_s"] = total - sum(split.values())
        return total, split

    def check_proof(seed, proof, v, committed):
        rr = random.Random(seed)
        r, s = int(F.rand(rr)), int(F.rand(rr))
        if v != int(F.rand(rr)) or [int(w) for w in committed] != [int(x)]:
            raise AssertionError("prove: v or the committed witness does "
                                 "not replay")
        h_tau = horner(record["h"][:N - 1], tau, R)
        A = (alpha + r * delta + az) % R
        B = (beta + s * delta + bz) % R
        C = (A * s + B * r - r * s * delta
             + di * (uncommitted_z + zt * h_tau - v * eta)) % R
        D = gi * (committed_z + v * eta) % R
        inputs = gi * inputs_z % R
        if (A * B - alpha * beta - gamma * (inputs + D) - delta * C) % R:
            raise AssertionError("prove: the logs fail the verification "
                                 "equation")
        if (proof.a, proof.b, proof.c, proof.d) != (
                G1.mul_raw(A), G2.mul_raw(B), G1.mul_raw(C), G1.mul_raw(D)):
            raise AssertionError("prove: a proof element is not its log "
                                 "times the generator")
        names = sorted(m[0] for m in record["msms"])
        if names != sorted(dlogs):
            raise AssertionError(f"prove: MSMs {names}")
        for name, sc, off, out in record["msms"]:
            G = G2 if name == "b_g2_query" else G1
            logs = dlogs[name][off:off + len(sc)]
            if out != G.mul_raw(sum(u * w for u, w in zip(sc, logs)) % R):
                raise AssertionError(f"prove: msm over {name} disagrees "
                                     f"with its known logs")

    snark.witness_map, snark._msm_query = wm, mq
    try:
        t0 = time.perf_counter()
        warm, _ = prove(SEED + 93)
        runs, splits, launches = [], [], None
        for run in range(PROVE_RUNS):
            if launches is None:
                (total, split), launches = drive(
                    counted, lambda: prove(SEED + 94 + run))
            else:
                total, split = prove(SEED + 94 + run)
            runs.append(total)
            splits.append(split)
            phase(f"{tag}legogroth16_prove_run", run=run, seconds=total,
                  **split, correct=True)
        t_all = time.perf_counter() - t0
        msm_sizes = {m[0]: len(m[1]) for m in record["msms"]}
        prove_dev = device_profile(f"profile_{tag}prove",
                                   lambda: create(SEED + 94 + PROVE_RUNS),
                                   cpu=False)
    finally:
        snark.witness_map, snark._msm_query = real_wm, real_mq
    require(f"{tag}LegoGroth16 prove", launches, PROVE_KERNELS)
    if any(launches[k] for k in POINT_KERNELS):
        raise AssertionError(f"prove launched a point kernel: {launches}")
    med = statistics.median(runs)
    phase(f"{tag}legogroth16_prove", constraints=nc, runs=PROVE_RUNS,
          seconds=runs, median_s=med, spread=max(runs) / min(runs),
          warmup_s=warm, phases_median={
              k: statistics.median(sp[k] for sp in splits)
              for k in splits[0]}, msm_points=msm_sizes,
          launches={k: v for k, v in launches.items() if v},
          all_s=t_all, correct=True)
    phase(f"per_{tag}prove", launches_device_ms=json.dumps(
        {k: [cnt, round(ms, 4)] for k, (cnt, ms) in prove_dev.items()}))
    pub = [F(int(v_)) for v_ in cs1.instance_assignment[1:]]
    verify_launches = verify_phase(counted, mod, pk, pub, *last, tag)
    return {f"{tag}legogroth16_setup": setup_launches,
            f"{tag}legogroth16_prove": launches,
            f"{tag}legogroth16_verify": verify_launches}, prove_dev


def verify_phase(counted, mod, pk, pub, proof, v, committed,
                 tag: str) -> dict:
    """The port's verifier (`snark.verify_proof` on the host pairing of
    `mod`, as the reference's) on a proof of the prove phase: it accepts
    the proof, rejects a spoiled public input and a spoiled C, opens D
    with v (`verify_commitment`) and refuses another witness; a
    `rerandomize_proof` output verifies; a `rerandomize_proof_1` output
    verifies and opens with the new v and not the old.  Returns the
    launches (none: host code)."""
    from crypto_tpu_torch.legogroth16 import snark
    F, vk = mod.Fr, pk.vk
    G = mod.G1.generator()
    secs = {}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        secs.setdefault(key, []).append(time.perf_counter() - t)
        return out

    def run():
        pvk = timed("prepare_s", snark.PreparedVerifyingKey.from_vk, vk,
                    ctx=mod)
        bad_c = snark.Proof(a=proof.a, b=proof.b, d=proof.d,
                            c=(proof.c + G).normalize())
        new_v = F(0x5EED)
        rr = timed("rerandomize_s", snark.rerandomize_proof, proof, vk,
                   random.Random(SEED + 98), ctx=mod)
        rr1 = timed("rerandomize_1_s", snark.rerandomize_proof_1, proof, v,
                    new_v, vk, pk.eta_delta_inv_g1, random.Random(SEED + 99),
                    ctx=mod)
        got = {
            "valid": timed("verify_s", snark.verify_proof, pvk, proof, pub,
                           ctx=mod),
            "spoiled_input": timed("verify_s", snark.verify_proof, pvk,
                                   proof, [pub[0] + F(1)], ctx=mod),
            "spoiled_c": timed("verify_s", snark.verify_proof, pvk, bad_c,
                               pub, ctx=mod),
            "commitment": timed("commitment_s", snark.verify_commitment, vk,
                                proof, pub, committed, v, ctx=mod),
            "commitment_other_witness": snark.verify_commitment(
                vk, proof, pub, [committed[0] + F(1)], v, ctx=mod),
            "rerandomized": timed("verify_s", snark.verify_proof, pvk, rr,
                                  pub, ctx=mod),
            "rerandomized_1": timed("verify_s", snark.verify_proof, pvk,
                                    rr1, pub, ctx=mod),
            "rerandomized_1_opens_new_v": snark.verify_commitment(
                vk, rr1, pub, committed, new_v, ctx=mod),
            "rerandomized_1_opens_old_v": snark.verify_commitment(
                vk, rr1, pub, committed, v, ctx=mod)}
        return got

    got, launches = drive(counted, run)
    want = {"valid": True, "spoiled_input": False, "spoiled_c": False,
            "commitment": True, "commitment_other_witness": False,
            "rerandomized": True, "rerandomized_1": True,
            "rerandomized_1_opens_new_v": True,
            "rerandomized_1_opens_old_v": False}
    if got != want:
        raise AssertionError(f"{tag}legogroth16_verify: {got}")
    phase(f"{tag}legogroth16_verify", checks=got, seconds=secs,
          verify_median_s=statistics.median(secs["verify_s"]),
          launches=sum(launches.values()), correct=True)
    return launches

PAIRS = 64                          # benches/bench_pairing.py NPAIR
PAIRING_RUNS = 2                    # timed multi-pairings, fresh pairs each
NSIG = 1024                         # bench_pairing.py NSIG, over 4 messages
SIG_MSGS = 4
PAIRING_ENV = "CRYPTO_TPU_PAIRING_BACKEND"
# what a multi-pairing launches: the Fq2 products and squares of the
# towers, mont_mul (the lines' scaling by the G1 point, the doubling's
# halvings, the inverse's norms) and mont_pow (the final exponentiation's
# Fq inverse); the checker's Miller product has no inverse
PAIRING_KERNELS = ("mont_mul", "mont_pow", "fq2_mul", "fq2_sqr")
CHECKER_KERNELS = ("mont_mul", "fq2_mul", "fq2_sqr")


def known_log_points(gen, logs, dev) -> list:
    """gen * log for each log, as normalised host points (the port's
    fixed-base products: a host window table below 512 logs, the device
    table from 512 on)."""
    from crypto_tpu_torch.utils.msm import \
        multiply_field_elems_with_same_group_elem
    return [p.normalize() for p in
            multiply_field_elems_with_same_group_elem(gen, logs, device=dev)]


def pairing_phases(counted, dev) -> tuple:
    """The pairing slice at `benches/bench_pairing.py`'s size: a 64-pair
    multi-pairing (plus one pair with G1 at infinity) once cold and
    `PAIRING_RUNS` times timed on fresh pairs, each against its known
    logs; the first pair set's per-pair Miller values against the host
    Miller loop and its product against the host multi-pairing;
    bilinearity and a product that is one; a lazy checker with 64
    deferred pairs, valid and spoiled; the BBS+ batch verify of `NSIG`
    signatures, valid and spoiled.  Returns ({path: launches}, the level
    widths of the batch verify's MSMs, the pair set to profile)."""
    import os
    from types import SimpleNamespace

    from crypto_tpu_torch.bbs_plus import batch
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    R = bls.R
    G1, G2 = bls.G1.generator(), bls.G2.generator()
    tp = tpairing_for("bls12_381", dev)
    hr = random.Random(SEED + 100)
    paths = {}

    # ---- pairing_64: pair sets from known logs, the product's log known
    t0 = time.perf_counter()
    nsets = 1 + PAIRING_RUNS
    la = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    lb = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    A, B = known_log_points(G1, la, dev), known_log_points(G2, lb, dev)
    sets = []
    for k in range(nsets):
        sl = slice(k * PAIRS, (k + 1) * PAIRS)
        sets.append((list(zip(A[sl], B[sl])) + [(bls.G1.infinity(),
                                                 B[k * PAIRS])],
                     sum(x * y for x, y in zip(la[sl], lb[sl])) % R))
    gt = bls.gt_generator()
    t_setup = time.perf_counter() - t0

    torch.cuda.synchronize()
    t = time.perf_counter()
    cold = tp.multi_pairing(sets[0][0])
    t_cold = time.perf_counter() - t
    t0 = time.perf_counter()
    lanes = tp.t12.unpack_host(tp.miller_loop_batch(
        *tp.pack_pairs(sets[0][0])))
    if any(m != bls.miller_loop([pq]) for m, pq in zip(lanes, sets[0][0])):
        raise AssertionError("pairing_64: a lane's Miller value differs "
                             "from the host Miller loop")
    if cold != bls.multi_pairing(sets[0][0]) or cold != gt ** sets[0][1]:
        raise AssertionError("pairing_64: the product differs from the "
                             "host multi-pairing")
    t_check = time.perf_counter() - t0

    secs, launches = [], None
    for run in range(PAIRING_RUNS):
        pairs, log = sets[1 + run]

        def timed():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tp.multi_pairing(pairs)
            return out, time.perf_counter() - t

        if launches is None:
            (out, dt), launches = drive(counted, timed)
        else:
            out, dt = timed()
        if out != gt ** log:
            raise AssertionError("pairing_64: a timed multi-pairing "
                                 "differs from its known log")
        secs.append(dt)
    require("pairing_64", launches, PAIRING_KERNELS)
    paths["pairing_64"] = launches

    a, b = hr.randrange(1, R), hr.randrange(1, R)
    aP, bQ = G1.mul_raw(a).normalize(), G2.mul_raw(b).normalize()
    abP = G1.mul_raw(a * b % R).normalize()
    e1, e2 = tp.t12.unpack_host(tp.final_exponentiation(
        tp.miller_loop_batch(*tp.pack_pairs([(aP, bQ), (abP, G2)]))))
    if e1 != e2 or not tp.multi_pairing([(aP, G2), (-aP, G2)]).is_one():
        raise AssertionError("pairing_64: e(aP, bQ) != e(abP, Q) or "
                             "e(aP, Q) e(-aP, Q) != 1")
    med = statistics.median(secs)
    phase("pairing_64", pairs=PAIRS, infinite_pairs=1, runs=PAIRING_RUNS,
          seconds=secs, median_s=med, spread=max(secs) / min(secs),
          cold_s=t_cold, device_multi_pairing_64_wall_s=med,
          pairings_per_s=PAIRS / med, setup_s=t_setup,
          host_check_s=t_check, launches={k: launches[k]
                                          for k in PAIRING_KERNELS},
          bilinear=True, product_is_one=True, correct=True)

    # ---- pairing_checker: 64 deferred pairs from known logs through the
    # device Miller product; one spoiled pair turns the verdict
    rows = []
    for _ in range(PAIRS // 2):
        x, y, z = (hr.randrange(1, R) for _ in range(3))
        rows.append((x, y, x * y * pow(z, -1, R) % R, z))
    g1s = known_log_points(G1, [r[0] for r in rows] + [r[2] for r in rows],
                           dev)
    g2s = known_log_points(G2, [r[1] for r in rows] + [r[3] for r in rows],
                           dev)
    k = len(rows)
    quads = [(g1s[i], g2s[i], g1s[k + i], g2s[k + i]) for i in range(k)]
    weight = hr.randrange(1, R)
    env = os.environ.pop(PAIRING_ENV, None)

    def checker(spoil: bool):
        c = RandomizedPairingChecker(bls.Fr(weight), lazy=True, device=dev)
        qs = list(quads)
        if spoil:
            p1, q1, p2, q2 = qs[-1]
            qs[-1] = (p1, q1, p2, q2.double().normalize())
        c.add_sources(*qs[0])
        c.add_multiple_sources(*zip(*qs[1:]))
        return c

    try:
        good, bad = checker(False), checker(True)
        t = time.perf_counter()
        ok, chk_launches = drive(counted, good.verify)
        t_chk = time.perf_counter() - t
        rejected = not bad.verify()
    finally:
        if env is not None:
            os.environ[PAIRING_ENV] = env
    if len(good.pending) != PAIRS or not ok or not rejected:
        raise AssertionError(f"pairing_checker: {len(good.pending)} "
                             f"pairs, valid {ok}, spoiled rejected "
                             f"{rejected}")
    require("pairing_checker", chk_launches, CHECKER_KERNELS)
    paths["pairing_checker"] = chk_launches
    phase("pairing_checker", deferred_pairs=len(good.pending),
          verify_s=t_chk, valid=ok, spoiled_rejected=rejected,
          launches={k: chk_launches[k] for k in PAIRING_KERNELS},
          correct=True)

    # ---- bbs_batch_verify_1024: signatures from known logs (params,
    # key and each A_i = (g1 + h_0 s + sum h_j m_j)/(e + x) by its log)
    t0 = time.perf_counter()
    lg, l0, l2, x = (hr.randrange(1, R) for _ in range(4))
    lh = [hr.randrange(1, R) for _ in range(SIG_MSGS)]
    pts = known_log_points(G1, [lg, l0] + lh, dev)
    params = SimpleNamespace(g1=pts[0], h_0=pts[1], h=pts[2:],
                             g2=G2.mul_raw(l2).normalize(),
                             supported_message_count=SIG_MSGS)
    pk = SimpleNamespace(w=G2.mul_raw(l2 * x % R).normalize())
    msgs = [[hr.randrange(R) for _ in range(SIG_MSGS)] for _ in range(NSIG)]
    es = [hr.randrange(R) for _ in range(NSIG)]
    ss = [hr.randrange(R) for _ in range(NSIG)]
    a_logs = [(lg + l0 * s_ + sum(h * m for h, m in zip(lh, ms)))
              * pow(e + x, -1, R) % R for e, s_, ms in zip(es, ss, msgs)]
    sigs = [SimpleNamespace(A=A_, e=bls.Fr(e), s=bls.Fr(s_))
            for A_, e, s_ in zip(known_log_points(G1, a_logs, dev), es, ss)]
    msgs = [[bls.Fr(m) for m in ms] for ms in msgs]
    t_sign = time.perf_counter() - t0
    spoiled = list(sigs)
    s5 = spoiled[5]
    spoiled[5] = SimpleNamespace(A=s5.A, e=s5.e + bls.Fr(1), s=s5.s)

    widths, safe_widths = [], []
    real_msm = batch.msm_device_scheduled
    log_of = {(p.X, p.Y): lg_ for p, lg_ in zip((s_.A for s_ in sigs),
                                               a_logs)}

    def msm(curve, points, scalars, device):
        tm = {}
        out = real_msm(curve, points, scalars, device=device, timings=tm)
        widths.extend(tm["level_pairs"])
        safe_widths.extend(rerun_widths(tm))
        want = sum(s_ * log_of[(p.X, p.Y)] for s_, p in zip(scalars, points))
        if out != G1.mul_raw(want % R):
            raise AssertionError("bbs batch verify: an MSM differs from "
                                 "its known logs")
        return out

    def verify(sig_set, seed):
        return batch.batch_verify_signatures(sig_set, msgs, pk, params,
                                             random.Random(seed), device=dev)

    # the cold run counted, its two MSMs held to their known logs; then
    # the timed warm run and the spoiled set on the MSM entry as it is
    env = os.environ.get(PAIRING_ENV)
    os.environ[PAIRING_ENV] = "device"
    try:
        batch.msm_device_scheduled = msm
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_cold, bbs_launches = drive(counted,
                                          lambda: verify(sigs, SEED + 103))
            t_cold_v = time.perf_counter() - t
        finally:
            batch.msm_device_scheduled = real_msm
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok_warm = verify(sigs, SEED + 104)
        t_warm = time.perf_counter() - t
        ok_spoiled = verify(spoiled, SEED + 105)
    finally:
        if env is None:
            os.environ.pop(PAIRING_ENV)
        else:
            os.environ[PAIRING_ENV] = env
    if not (ok_cold and ok_warm) or ok_spoiled:
        raise AssertionError(f"bbs batch verify: valid {ok_cold}/{ok_warm},"
                             f" spoiled {ok_spoiled}")
    bbs_widths = widths
    require("bbs_batch_verify_1024", bbs_launches,
            set(PAIRING_KERNELS) | level_kernels(
                bbs_widths, safe_widths, msm_v2.CHUNK_MIN_PAIRS))
    paths["bbs_batch_verify_1024"] = bbs_launches
    phase("bbs_batch_verify_1024", signatures=NSIG, messages=SIG_MSGS,
          bbs_plus_batch_verify_1024_wall_s=t_warm, cold_s=t_cold_v,
          sigs_per_s=NSIG / t_warm, signing_s=t_sign,
          msm_level_pairs=bbs_widths, rerun_level_pairs=safe_widths,
          launches={k: v for k, v in bbs_launches.items() if v},
          valid=True, spoiled_rejected=True, correct=True)
    return paths, bbs_widths, sets[1][0]


POK_N = 256                         # proofs in the batch verify
POK_MSGS = 32                       # BASELINE.json config 2: 32 messages,
POK_REVEALED = 4                    # 4 of them revealed
POK_PROTOCOL = 4                    # proofs made by the port's own protocol
CHECKER_POKS, CHECKER_SIGS, CHECKER_23 = 16, 4, 2


def bbs_pok_phases(counted, dev) -> tuple:
    """BASELINE config 2 on the card: `batch_verify_proofs` over `POK_N`
    PoKOfSignatureG1 proofs of `POK_MSGS` messages (`POK_REVEALED`
    revealed), the pairing on the device, once cold (counted, both MSMs
    held to their known logs) and once warm (timed, host checker, device
    MSMs and pairing apart), and two spoiled sets that must be rejected:
    one response off by one (the mult checker fails, no pairing runs) and
    one proof made under another secret key (its Schnorr legs hold, the
    pairing fails).  The params, key and `POK_N - POK_PROTOCOL` proofs
    come from the protocol's algebra over known logs (one
    `known_log_points` call); `POK_PROTOCOL` proofs come from the port's
    `SignatureG1.new` and `PoKOfSignatureG1Protocol`, their sign, prove
    and host verify timed.  Then one lazy `RandomizedPairingChecker` on
    the card takes `CHECKER_POKS` PoKs, `CHECKER_SIGS` signatures and
    `CHECKER_23` BBS23 PoKs: valid, and with one signature spoiled.
    Returns ({path: launches}, the batch verify's MSM level widths,
    {path: lanes of its device Miller loop})."""
    import os

    from crypto_tpu_torch.bbs_plus import batch
    from crypto_tpu_torch.bbs_plus import bbs23
    from crypto_tpu_torch.bbs_plus.proof import (
        MessageOrBlinding, PoKOfSignatureG1Proof, PoKOfSignatureG1Protocol,
        compute_challenge_contribution)
    from crypto_tpu_torch.bbs_plus.setup import (PublicKeyG2, SecretKey,
                                                 SignatureParamsG1)
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.hashing import compute_random_oracle_challenge
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.schnorr.discrete_log import PokPedersenCommitment
    from crypto_tpu_torch.schnorr.generalized import SchnorrResponse
    from crypto_tpu_torch.serialize import ByteWriter
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    R, Fr = bls.R, bls.Fr
    G1, G2 = bls.G1.generator(), bls.G2.generator()
    hr = random.Random(SEED + 200)
    paths = {}

    def inv(v):
        return pow(v, -1, R)

    # ---- params and key from known logs; 1 + POK_N - POK_PROTOCOL proofs
    # by the protocol's algebra (the last under another secret key)
    t0 = time.perf_counter()
    lg, l0, l2, x, x_other = (hr.randrange(1, R) for _ in range(5))
    lh = [hr.randrange(1, R) for _ in range(POK_MSGS)]
    hidden = range(POK_REVEALED, POK_MSGS)
    rows = []
    for k in range(1 + POK_N - POK_PROTOCOL):
        m = [hr.randrange(R) for _ in range(POK_MSGS)]
        e, s_, r2 = (hr.randrange(R) for _ in range(3))
        r1, b1, b2, bd, bs = (hr.randrange(1, R) for _ in range(5))
        bl = [hr.randrange(R) for _ in hidden]
        lb = (lg + l0 * s_ + sum(h * v for h, v in zip(lh, m))) % R
        key = x_other if k == POK_N - POK_PROTOCOL else x
        la = lb * inv(e + key) % R
        ap, ld = la * r1 % R, (r1 * lb - l0 * r2) % R
        logs = [ap, r1 * (lb - la * e) % R, ld, (ap * b1 + l0 * b2) % R,
                (sum(lh[i] * v for i, v in zip(hidden, bl)) + ld * bd
                 + l0 * bs) % R]
        rows.append((m, e, s_, r1, r2, b1, b2, bd, bs, bl, logs))
    pts = known_log_points(G1, [lg, l0] + lh
                           + [v for row in rows for v in row[-1]], dev)
    params = SignatureParamsG1(g1=pts[0], g2=G2.mul_raw(l2).normalize(),
                               h_0=pts[1], h=pts[2:2 + POK_MSGS])
    pk = PublicKeyG2(w=G2.mul_raw(l2 * x % R).normalize())
    sk = SecretKey(Fr(x))
    log_of = {}
    algebra = []                     # (proof, revealed, challenge)
    for k, (m, e, s_, r1, r2, b1, b2, bd, bs, bl, logs) in enumerate(rows):
        five = pts[2 + POK_MSGS + 5 * k:2 + POK_MSGS + 5 * (k + 1)]
        log_of.update(((p.X, p.Y), lv) for p, lv in zip(five[:2], logs[:2]))
        revealed = {i: Fr(m[i]) for i in range(POK_REVEALED)}
        w = ByteWriter()
        compute_challenge_contribution(*five, revealed, params, w)
        c = int(compute_random_oracle_challenge(Fr, w.bytes()))
        r3 = inv(r1)
        sp = (s_ - r2 * r3) % R
        resp2 = [(v + m[i] * c) % R for i, v in zip(hidden, bl)] \
            + [(bd - r3 * c) % R, (bs + sp * c) % R]
        proof = PoKOfSignatureG1Proof(
            A_prime=five[0], A_bar=five[1], d=five[2],
            sc_resp_1=PokPedersenCommitment(five[3], Fr((b1 - e * c) % R),
                                            Fr((b2 + r2 * c) % R)),
            T2=five[4], sc_resp_2=SchnorrResponse([Fr(v) for v in resp2]))
        algebra.append((proof, revealed, Fr(c)))
    other_key = algebra.pop()
    t_build = time.perf_counter() - t0

    # ---- POK_PROTOCOL proofs through the port's own protocol
    prng = random.Random(SEED + 201)
    made, signed, secs = [], [], {"sign_s": [], "prove_s": [],
                                  "host_verify_s": []}
    for _ in range(POK_PROTOCOL):
        msgs = [Fr.rand(prng) for _ in range(POK_MSGS)]
        t = time.perf_counter()
        sig = SignatureG1.new(prng, msgs, sk, params)
        secs["sign_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        mabs = [MessageOrBlinding.reveal_message(v) if i < POK_REVEALED
                else MessageOrBlinding.blind_randomly(v)
                for i, v in enumerate(msgs)]
        prot = PoKOfSignatureG1Protocol.init(prng, sig, params, mabs)
        revealed = {i: msgs[i] for i in range(POK_REVEALED)}
        w = ByteWriter()
        prot.challenge_contribution(revealed, params, w)
        ch = compute_random_oracle_challenge(Fr, w.bytes())
        proof = prot.gen_proof(ch)
        secs["prove_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        proof.verify(revealed, ch, pk, params)
        secs["host_verify_s"].append(time.perf_counter() - t)
        made.append((proof, revealed, ch))
        signed.append((sig, msgs))
    for proof, revealed, ch in algebra[:2]:
        proof.verify(revealed, ch, pk, params)
    valid = made + algebra
    spoiled_resp, spoiled_key = list(valid), list(valid)
    k = POK_N // 3
    pr, rev, ch = valid[k]
    resp = list(pr.sc_resp_2.responses)
    resp[0] = resp[0] + Fr(1)
    spoiled_resp[k] = (PoKOfSignatureG1Proof(
        pr.A_prime, pr.A_bar, pr.d, pr.sc_resp_1, pr.T2,
        SchnorrResponse(resp)), rev, ch)
    spoiled_key[2 * POK_N // 3] = other_key

    # ---- the batch verify: both MSMs held to their known logs in the
    # cold run (the protocol-made proofs' terms on the host); the warm run
    # split into device MSMs, pairing and host work
    widths, safe_widths = [], []
    real_msm, real_vmsm, real_pair = (batch.msm_device_scheduled,
                                      batch._msm, batch._multi_pairing)
    spent = {"device_msm_s": 0.0, "pairing_s": 0.0, "pairings": 0,
             "lanes": 0}

    def checked_msm(curve, points, scalars, device):
        tm = {}
        out = real_msm(curve, points, scalars, device=device, timings=tm)
        widths.extend(tm["level_pairs"])
        safe_widths.extend(rerun_widths(tm))
        want, extra = 0, bls.G1.infinity()
        for s_, p in zip(scalars, points):
            if (p.X, p.Y) in log_of:
                want += s_ * log_of[(p.X, p.Y)]
            else:
                extra = extra + p.mul_raw(s_)
        if out != G1.mul_raw(want % R) + extra:
            raise AssertionError("bbs pok batch verify: an MSM differs from "
                                 "its known logs")
        return out

    def timed_msm(points, scalars, device):
        t = time.perf_counter()
        out = real_vmsm(points, scalars, device)
        spent["device_msm_s"] += time.perf_counter() - t
        return out

    def timed_pair(pairs, device):
        t = time.perf_counter()
        out = real_pair(pairs, device)
        spent["pairing_s"] += time.perf_counter() - t
        spent["pairings"] += 1
        spent["lanes"] = max(spent["lanes"], len(pairs))
        return out

    def verify(items, seed):
        proofs, revealed, chs = (list(v) for v in zip(*items))
        return batch.batch_verify_proofs(proofs, revealed, chs, pk, params,
                                         random.Random(seed), device=dev)

    env = os.environ.get(PAIRING_ENV)
    os.environ[PAIRING_ENV] = "device"
    try:
        batch.msm_device_scheduled = checked_msm
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_cold, launches = drive(counted,
                                      lambda: verify(valid, SEED + 202))
            t_cold = time.perf_counter() - t
        finally:
            batch.msm_device_scheduled = real_msm
        batch._msm, batch._multi_pairing = timed_msm, timed_pair
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_warm = verify(valid, SEED + 203)
            t_warm = time.perf_counter() - t
            split = dict(spent)
            spent["pairings"] = 0
            ok_resp = verify(spoiled_resp, SEED + 204)
            pairings_resp = spent["pairings"]
            ok_key = verify(spoiled_key, SEED + 205)
            pairings_key = spent["pairings"] - pairings_resp
        finally:
            batch._msm, batch._multi_pairing = real_vmsm, real_pair
    finally:
        if env is None:
            os.environ.pop(PAIRING_ENV)
        else:
            os.environ[PAIRING_ENV] = env
    if not (ok_cold and ok_warm) or ok_resp or ok_key \
            or (pairings_resp, pairings_key) != (0, 1):
        raise AssertionError(
            f"bbs pok batch verify: valid {ok_cold}/{ok_warm}, spoiled "
            f"response {ok_resp} ({pairings_resp} pairings), other key "
            f"{ok_key} ({pairings_key} pairings)")
    require("bbs_pok_batch_verify_256", launches, set(PAIRING_KERNELS)
            | level_kernels(widths, safe_widths, msm_v2.CHUNK_MIN_PAIRS))
    paths["bbs_pok_batch_verify_256"] = launches
    host_s = t_warm - split["device_msm_s"] - split["pairing_s"]
    phase("bbs_pok_batch_verify_256", proofs=POK_N, messages=POK_MSGS,
          revealed=POK_REVEALED, bbs_plus_pok_batch_verify_256_wall_s=t_warm,
          cold_s=t_cold, host_checker_s=host_s,
          device_msm_s=split["device_msm_s"], pairing_s=split["pairing_s"],
          proofs_per_s=POK_N / t_warm, build_s=t_build,
          **{k: statistics.mean(v) for k, v in secs.items()},
          msm_level_pairs=widths, rerun_level_pairs=safe_widths,
          launches={k: v for k, v in launches.items() if v}, valid=True,
          spoiled_response_rejected=True, other_key_rejected=True,
          correct=True)

    # ---- bbs_pok_checker_16: PoKs, signatures and BBS23 PoKs through one
    # lazy checker, its Miller product on the device
    params23 = bbs23.SignatureParams23G1(g1=params.g1, g2=params.g2,
                                         h=params.h)
    pk23 = bbs23.PublicKey23G2(w=pk.w)
    poks23 = []
    for _ in range(CHECKER_23):
        msgs = [Fr.rand(prng) for _ in range(POK_MSGS)]
        sig = bbs23.Signature23G1.new(prng, msgs, sk, params23)
        prot = bbs23.PoKOfSignature23G1Protocol.init(
            prng, sig, params23, msgs, set(range(POK_REVEALED)))
        revealed = {i: msgs[i] for i in range(POK_REVEALED)}
        w = ByteWriter()
        prot.challenge_contribution(revealed, params23, w)
        ch = compute_random_oracle_challenge(Fr, w.bytes())
        poks23.append((prot.gen_proof(ch), revealed, ch))
    weight = Fr(hr.randrange(1, R))
    env = os.environ.pop(PAIRING_ENV, None)

    def checker(spoil: bool):
        c = RandomizedPairingChecker(weight, lazy=True, device=dev)
        for proof, revealed, ch in valid[:CHECKER_POKS]:
            proof.verify_with_randomized_pairing_checker(revealed, ch, pk,
                                                         params, c)
        for k, (sig, msgs) in enumerate(signed[:CHECKER_SIGS]):
            if spoil and k == 1:
                sig = SignatureG1(A=sig.A, e=sig.e + Fr(1), s=sig.s)
            sig.verify_with_pairing_checker(msgs, pk, params, c)
        for proof, revealed, ch in poks23:
            if not proof.verify(revealed, ch, pk23, params23,
                                pairing_checker=c):
                raise AssertionError("bbs_pok_checker_16: a BBS23 PoK's "
                                     "Schnorr legs failed")
        return c

    try:
        t = time.perf_counter()
        good = checker(False)
        t_add = time.perf_counter() - t
        t = time.perf_counter()
        ok, chk_launches = drive(counted, good.verify)
        t_chk = time.perf_counter() - t
        rejected = not checker(True).verify()
    finally:
        if env is not None:
            os.environ[PAIRING_ENV] = env
    npairs = 2 * (CHECKER_POKS + CHECKER_SIGS + CHECKER_23)
    if len(good.pending) != npairs or not ok or not rejected:
        raise AssertionError(f"bbs_pok_checker_16: {len(good.pending)} "
                             f"pairs, valid {ok}, spoiled rejected "
                             f"{rejected}")
    require("bbs_pok_checker_16", chk_launches, CHECKER_KERNELS)
    paths["bbs_pok_checker_16"] = chk_launches
    phase("bbs_pok_checker_16", poks=CHECKER_POKS, signatures=CHECKER_SIGS,
          bbs23_poks=CHECKER_23, deferred_pairs=len(good.pending),
          host_adds_s=t_add, verify_s=t_chk, valid=ok,
          spoiled_rejected=rejected,
          launches={k: chk_launches[k] for k in PAIRING_KERNELS},
          correct=True)
    return paths, widths, {"bbs_pok_batch_verify_256": split["lanes"],
                           "bbs_pok_checker_16": len(good.pending)}


NELEM = 1 << 14                     # benches/bench_accumulator.py NELEM
NMEMBERS = NELEM // 2               # the members whose witnesses update
NBATCH = 256                        # the bench's additions
NCHECK_HOST = 16                    # members held to the port's host branch
# what a witness update on the card launches: mont_mul (the scans, the
# double-and-add, the final add, to_affine; batch_inv_t's tree) and
# mont_pow (to_affine's Fq root; batch_inv_t's Fr root with removals)
ACCUM_KERNELS = ("mont_mul", "mont_pow")


def accumulator_phases(counted, dev) -> tuple:
    """The VB accumulator at `benches/bench_accumulator.py`'s size: the
    setup (params hashed from a label, a key from a fixed seed, 2^14
    elements added, the first 8,192 members' witnesses on the device
    fixed-base path, two pairing checks), then three updates of all 8,192
    witnesses through `update_membership_batch_with_sk` on the card: (a)
    256 additions, the bench's workload, cold and warm; (b) 256 removals
    of non-members; (c) 128 additions and 128 removals.  Each update is
    held to an independent result: every witness to V_new / (y + alpha)
    by a host batch inverse and the device fixed-base table, every d
    factor to host integers, 16 members to the port's host branch, two
    members by pairing.  Returns ({path: launches}, a function that runs
    update (a) once more, for the profile)."""
    import os

    from crypto_tpu_torch.accumulator import device_update, witness
    from crypto_tpu_torch.accumulator.batch_utils import _batch_inverse
    from crypto_tpu_torch.accumulator.core import PositiveAccumulator
    from crypto_tpu_torch.accumulator.persistence import InMemoryState
    from crypto_tpu_torch.accumulator.setup import AccumKeypair, \
        AccumSetupParams
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.utils.msm import \
        multiply_field_elems_with_same_group_elem
    F, R = bls.Fr, bls.R
    rng = random.Random(SEED + 200)
    paths = {}
    # the routing held here is the reference's rule, with no override
    for k in ("CRYPTO_TPU_FORCE_DEVICE_ACCUM", "CRYPTO_TPU_NO_DEVICE_ACCUM"):
        os.environ.pop(k, None)

    # ---- accumulator_setup
    secs = {}
    t = time.perf_counter()
    params = AccumSetupParams.new(b"bench-accum")
    secs["params_s"] = time.perf_counter() - t
    t = time.perf_counter()
    kp = AccumKeypair.generate(rng, params)
    sk, pk = kp.secret_key, kp.public_key
    secs["keypair_s"] = time.perf_counter() - t
    state = InMemoryState()
    elems = [F.rand(rng) for _ in range(NELEM)]
    t = time.perf_counter()
    acc = PositiveAccumulator.initialize(params).add_batch(elems, sk, state)
    secs["add_batch_s"] = time.perf_counter() - t
    members = elems[:NMEMBERS]
    torch.cuda.synchronize()
    t = time.perf_counter()
    wits, wit_launches = drive(counted, lambda: acc.
                               get_membership_witnesses_for_batch(
                                   members, sk, state, device=dev))
    secs["witnesses_s"] = time.perf_counter() - t
    require("accumulator witnesses", wit_launches, ("mont_mul",))
    t = time.perf_counter()
    if not all(acc.verify_membership(members[i], wits[i], pk, params)
               for i in (0, NMEMBERS - 1)):
        raise AssertionError("accumulator_setup: a witness fails its "
                             "pairing check")
    secs["verify_s"] = time.perf_counter() - t
    paths["accumulator_witnesses"] = wit_launches
    phase("accumulator_setup", elements=NELEM, members=NMEMBERS, **secs,
          vb_accum_witness_gen_8192_wall_s=secs["witnesses_s"],
          witnesses_per_s=NMEMBERS / secs["witnesses_s"],
          launches={k: v for k, v in wit_launches.items() if v},
          correct=True)

    # ---- accumulator_update: three batches, each from the same V
    V0, alpha = acc.value(), int(sk.alpha)
    ys = [int(y) for y in members]
    fresh = [F.rand(rng) for _ in range(NBATCH + NBATCH // 2)]
    cases = {
        "a": (fresh[:NBATCH], [], acc.add_batch(fresh[:NBATCH], sk, state)),
        "b": ([], elems[NMEMBERS:NMEMBERS + NBATCH],
              acc.remove_batch(elems[NMEMBERS:NMEMBERS + NBATCH], sk,
                               state)),
    }
    rem_c = elems[NMEMBERS + NBATCH:NMEMBERS + NBATCH + NBATCH // 2]
    cases["c"] = (fresh[NBATCH:], rem_c,
                  acc.batch_updates(fresh[NBATCH:], rem_c, sk, state))
    real = device_update.batch_update_with_sk_device

    def update(adds, rems, seen: dict):
        def shim(*a, **kw):
            tm = {}
            out = real(*a, **kw, timings=tm)
            seen.update(timings=tm, d=out[0])
            return out

        device_update.batch_update_with_sk_device = shim
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, launches = drive(counted, lambda: witness.
                                  update_membership_batch_with_sk(
                                      adds, rems, members, wits, V0, sk,
                                      device=dev))
            return out, launches, time.perf_counter() - t
        finally:
            device_update.batch_update_with_sk_device = real

    def check(tag, adds, rems, new_acc, new_wits, d) -> dict:
        t0 = time.perf_counter()
        # every d factor: d_A(y) / d_D(y) in plain host integers
        num = [1] * NMEMBERS
        den = [1] * NMEMBERS
        for i, y in enumerate(ys):
            for a in adds:
                num[i] = num[i] * (int(a) - y) % R
            for r in rems:
                den[i] = den[i] * (int(r) - y) % R
        want_d = [n_ * pow(d_, -1, R) % R for n_, d_ in zip(num, den)]
        if [int(x) for x in d] != want_d:
            raise AssertionError(f"accumulator_update ({tag}): a d factor "
                                 f"differs from the host product")
        # every witness: V_new / (y + alpha), by a host batch inverse and
        # the device fixed-base table (not scalar_mul)
        invs = _batch_inverse([F(y + alpha) for y in ys])
        want = multiply_field_elems_with_same_group_elem(
            new_acc.value(), invs, device=dev)
        got = [None if c.is_infinity() else (int(c.X), int(c.Y))
               for c in (w.C.normalize() for w in new_wits)]
        exp = [None if p.is_infinity() else tuple(int(c) for c in
                                                  p.to_affine())
               for p in want]
        if got != exp:
            raise AssertionError(f"accumulator_update ({tag}): a witness "
                                 f"differs from V_new / (y + alpha)")
        t1 = time.perf_counter()
        # 16 members through the port's host branch (below 512 members)
        hd, hc = witness._batch_update_with_sk(
            adds, rems, members[:NCHECK_HOST],
            [w.C for w in wits[:NCHECK_HOST]], V0, sk, device=dev)
        if [int(x) for x in hd] != want_d[:NCHECK_HOST] or \
                hc != [w.C for w in new_wits[:NCHECK_HOST]]:
            raise AssertionError(f"accumulator_update ({tag}): the host "
                                 f"branch differs")
        t2 = time.perf_counter()
        if not all(new_acc.verify_membership(members[i], new_wits[i], pk,
                                             params)
                   for i in (0, NMEMBERS - 1)):
            raise AssertionError(f"accumulator_update ({tag}): a witness "
                                 f"fails its pairing check")
        return dict(check_table_s=t1 - t0, check_host_branch_s=t2 - t1,
                    check_pairing_s=time.perf_counter() - t2)

    def report(tag, seconds, seen, launches, checks, **kv):
        require(f"accumulator update ({tag})", launches, ACCUM_KERNELS)
        phase(f"accumulator_update_{tag}", members=NMEMBERS,
              additions=len(cases[tag][0]), removals=len(cases[tag][1]),
              seconds=seconds, updates_per_s=NMEMBERS / seconds,
              split_s=seen["timings"], **kv,
              launches={k: v for k, v in launches.items() if v}, **checks,
              correct=True)

    adds, rems, new_acc = cases["a"]
    cold = {}
    wits_a, launches_a, t_cold = update(adds, rems, cold)
    if "d" not in cold:
        raise AssertionError("accumulator update (a): 8,192 members did not "
                             "take the device path")
    checks = check("a", adds, rems, new_acc, wits_a, cold["d"])
    report("a", t_cold, cold, launches_a, checks, run="cold")
    warm = {}
    wits_w, launches_w, t_warm = update(adds, rems, warm)
    if [w.C for w in wits_w] != [w.C for w in wits_a] or \
            warm["d"] != cold["d"]:
        raise AssertionError("accumulator update (a): the warm run differs "
                             "from the cold one")
    report("a", t_warm, warm, launches_w, {}, run="warm",
           vb_accum_witness_update_8192_after_256_adds_wall_s=t_warm)
    paths["accumulator_update"] = launches_w
    for tag in ("b", "c"):
        adds, rems, new_acc = cases[tag]
        seen = {}
        new_wits, launches, secs_ = update(adds, rems, seen)
        checks = check(tag, adds, rems, new_acc, new_wits, seen["d"])
        report(tag, secs_, seen, launches, checks)
        paths[f"accumulator_update_{tag}"] = launches

    adds_a = cases["a"][0]

    def profile_update():
        return witness.update_membership_batch_with_sk(
            adds_a, [], members, wits, V0, sk, device=dev)

    return paths, profile_update


BN254_MSM_RUNS = 3                  # timed 2^20 BN254 G1 MSMs
BN254_PROBE_LOG = 16                # the prove's G2 query MSM: ~2^16 points
# the L = 8 instantiations the BN254 paths must launch between them: every
# level kernel of both formulas, the Fq2 level, product and square, the
# gather and its tables (8 words a row on G1, 16 on G2), mont_mul and
# mont_pow; the point kernels take BLS12-381 Fq only
BN254_KERNELS = ("mont_mul", "mont_pow", "affine_level_pre",
                 "affine_level_post", "chunked_level_prefix",
                 "chunked_level_down", "affine_level_pre_fast",
                 "affine_level_post_fast", "chunked_level_prefix_fast",
                 "chunked_level_down_fast", "fq2_mul", "fq2_sqr",
                 "affine_level_pre_fq2", "affine_level_post_fq2",
                 "gather_rows_t", "slot_tables")


def bn254_msm_phases(counted, dev) -> tuple:
    """BN254 G1 at the reference's full size: 2^20 bench points with known
    discrete logs (built by the total `TCurve` ops: the point kernels
    take BLS12-381 Fq only), `BN254_MSM_RUNS` timed MSMs at c = 16 on the
    fast levels, each equal to its known-dlog sum with no rerun, one
    `safe=True` MSM, the rerun path (one duplicated base colliding in one
    window: exactly the spoiled windows rerun), and the edge MSMs of G1
    (8 duplicate bases, rerun through the total pre/post; 300 points
    with one scalar) and G2 (duplicates, P and -P, infinity, zero and
    equal scalars).  Returns ({path: (launches, level widths)}, what the
    kernel checks need)."""
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
    from crypto_tpu_torch.ops import msm_v2
    n, R, thr = 1 << N_LOG, bn.R, msm_v2.CHUNK_MIN_PAIRS
    tc = tcurve_for(bn.G1, dev)
    G = bn.G1.generator()
    paths = {}

    # ---- bench points: 2^20 distinct points on the total TCurve ops
    t0 = time.time()
    (points, dlog), bp = drive(counted, lambda: make_bench_points(tc, n))
    torch.cuda.synchronize()
    t_points = time.time() - t0
    require("bn254 bench points", bp, ("mont_mul", "mont_pow"))
    if any(bp[k] for k in POINT_KERNELS):
        raise AssertionError(f"bn254 bench points launched a point kernel: "
                             f"{bp}")
    logs = [dlog(i) for i in range(n)]
    sample = list(range(0, n, n // 64))
    got = tc.unpack(TPoints(*(t[:, sample] for t in points)))
    if any(g != G.mul_raw(logs[i]) for g, i in zip(got, sample)):
        raise AssertionError("bn254 bench points disagree with their "
                             "discrete logs")
    paths["bn254_bench_points_2^20"] = (bp, [])
    phase("bn254_bench_points", n=n, seconds=round(t_points, 3),
          mont_mul_launches=bp["mont_mul"], mont_pow_launches=bp["mont_pow"],
          sample_checked=len(sample), correct=True)

    # ---- the 2^20 MSM, c = 16, fast levels
    _, warm = make_bench_scalars(R, n, SEED + 200)
    msm_v2.msm_device_scheduled(bn.G1, points, warm, c=16)
    secs, runs = [], []
    for run in range(BN254_MSM_RUNS):
        sc, sb = make_bench_scalars(R, n, SEED + 201 + run)
        timings = {}
        torch.cuda.synchronize()

        def timed():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bn.G1, points, sb, c=16,
                                              timings=timings)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed)
        if result != G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % R):
            raise AssertionError("bn254 2^20 MSM disagrees with the "
                                 "known-dlog result")
        if timings["rerun_windows"] or any(launches[k] for k in
                                           SAFE_KERNELS + FQ2_KERNELS):
            raise AssertionError(f"bn254 2^20 MSM on distinct bases reran "
                                 f"{timings['rerun_windows']} or launched "
                                 f"a total-formula or an Fq2 kernel: "
                                 f"{launches}")
        require("bn254 2^20 MSM", launches,
                level_kernels(timings["level_pairs"], [], thr))
        secs.append(dt)
        runs.append((launches, timings))
        phase("bn254_msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(timings), rerun_windows=[], correct=True)
    launches, timings = runs[0]
    main_widths = timings["level_pairs"]
    paths["bn254_msm_2^20"] = (launches, main_widths)
    med = statistics.median(secs)
    phase("bn254_msm", n=n, c=16, runs=BN254_MSM_RUNS, seconds=secs,
          median_s=med, spread=max(secs) / min(secs), points_per_s=n / med,
          level_pairs=main_widths, slots=timings["slots"],
          launches={k: v for k, v in launches.items() if v}, correct=True)

    # ---- safe=True once on fresh scalars
    sc, sb = make_bench_scalars(R, n, SEED + 240)
    t_s = {}
    t0 = time.perf_counter()
    res, safe_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bn.G1, points, sb, c=16, safe=True, timings=t_s))
    dt_s = time.perf_counter() - t0
    if res != G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % R) \
            or t_s["rerun_windows"]:
        raise AssertionError("bn254 2^20 MSM with safe=True disagrees with "
                             "the known-dlog result or reran")
    require("bn254 safe 2^20 MSM", safe_launches,
            level_kernels([], t_s["level_pairs"], thr))
    paths["bn254_msm_safe_2^20"] = (safe_launches, t_s["level_pairs"])
    phase("bn254_msm_safe", n=n, seconds=dt_s, phases=floats(t_s),
          correct=True)

    # ---- the rerun path: a duplicated base collides in window w0's bucket
    sc, sb = make_bench_scalars(R, n, SEED + 250)
    dh = msm_v2.device_digits(sb, 16, bn.Fr.bits).cpu().numpy()
    W, B, w0 = dh.shape[0], 1 << 15, 5
    i_b = next(k for k in range(11, n) if dh[w0, k] != 0)
    j_b = next(k for k in range(n // 2, n)
               if all(dh[w, k] != dh[w, i_b] for w in range(W) if w != w0))
    v0 = int(dh[w0, i_b])
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
        bn.G1, pts_r, torch.from_numpy(dh).to(dev), c=16, timings=t_rr))
    dt_r = time.perf_counter() - t0
    del pts_r
    if res_r != G.mul_raw(expect_s % R):
        raise AssertionError("bn254 2^20 rerun MSM disagrees with the "
                             "known-dlog result")
    spoiled = spoiled_windows(t_rr)
    if w0 not in spoiled or t_rr["rerun_windows"] != spoiled:
        raise AssertionError(f"bn254 rerun path: collision in window {w0}, "
                             f"spoiled windows {spoiled}, rerun "
                             f"{t_rr['rerun_windows']}")
    rr_widths = rerun_widths(t_rr)
    require("bn254 2^20 rerun", rr_launches,
            level_kernels(t_rr["level_pairs"], rr_widths, thr))
    paths["bn254_rerun_2^20"] = (rr_launches, rr_widths)
    phase("bn254_rerun_msm", n=n, collision_window=w0, bases=[i_b, j_b],
          rerun_windows=spoiled, rerun_level_pairs=rr_widths, seconds=dt_r,
          phases=floats(t_rr), correct=True)

    # ---- G1 edge MSMs: 8 duplicate bases, and 300 points with one scalar
    p0 = G.mul_raw(random.Random(SEED + 251).randrange(1, R))
    m_eq, s_eq = 300, 0x1234567890ABCDEF
    sub = TPoints(*(t[:, :m_eq].contiguous() for t in points))
    t_dup, t_eq = {}, {}
    (dup, eq_res), edge_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bn.G1, [p0] * 8, [7] * 8, timings=t_dup),
        msm_v2.msm_device_scheduled(bn.G1, sub, [s_eq] * m_eq,
                                    timings=t_eq)))
    if dup != p0.mul_raw(56) \
            or eq_res != G.mul_raw(s_eq * sum(logs[:m_eq]) % R):
        raise AssertionError("bn254 edge MSMs disagree with the host")
    if 0 not in t_dup["rerun_windows"] \
            or t_dup["rerun_windows"] != spoiled_windows(t_dup) \
            or t_eq["rerun_windows"]:
        raise AssertionError(f"bn254 edge MSMs: rerun "
                             f"{t_dup['rerun_windows']} and "
                             f"{t_eq['rerun_windows']}")
    edge_widths = t_dup["level_pairs"] + t_eq["level_pairs"]
    edge_safe = rerun_widths(t_dup)
    require("bn254 edge MSM", edge_launches,
            level_kernels(edge_widths, edge_safe, thr)
            | set(LEVEL_KERNELS[("pre_post", True)]))
    paths["bn254_edge_msm"] = (edge_launches, edge_widths)
    phase("bn254_edge_msm", duplicate_bases=True, all_equal_scalars_n=m_eq,
          level_pairs=edge_widths, rerun_windows=t_dup["rerun_windows"],
          rerun_level_pairs=edge_safe, correct=True)

    # ---- G2 edge MSMs on the Fq2 levels: no flag, no rerun
    G2 = bn.G2.generator()
    hr = random.Random(SEED + 260)
    q0, q1, *qs = (G2.mul_raw(hr.randrange(1, R)) for _ in range(8))
    e_pts = [q0] * 6 + [q1, -q1, bn.G2.infinity(), q0.double()] + qs
    e_sc = [7] * 6 + [9, 9, 5, 0, 0, 3, 7, 11, 2, 13]
    e_expect = bn.G2.infinity()
    for p_, s_ in zip(e_pts, e_sc):
        e_expect = e_expect + p_.mul_raw(s_)
    eq_logs = [hr.randrange(1, R) for _ in range(64)]
    eq_pts = known_log_points(G2, eq_logs, dev)
    t_e1, t_e2 = {}, {}
    (e_res, eq2_res), edge2_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bn.G2, e_pts, e_sc, timings=t_e1),
        msm_v2.msm_device_scheduled(bn.G2, eq_pts, [s_eq] * len(eq_pts),
                                    timings=t_e2)))
    if e_res != e_expect or eq2_res != G2.mul_raw(s_eq * sum(eq_logs) % R):
        raise AssertionError("bn254 G2 edge MSMs disagree with the host")
    not_g2 = G1_LEVEL_KERNELS + POINT_KERNELS
    require("bn254 G2 edge MSM", edge2_launches, G2_KERNELS)
    if any(edge2_launches[k] for k in not_g2) or t_e1["rerun_windows"] \
            or t_e2["rerun_windows"]:
        raise AssertionError(f"bn254 G2 edge MSM: a G1 kernel or a rerun: "
                             f"{edge2_launches}")
    g2_edge_widths = t_e1["level_pairs"] + t_e2["level_pairs"]
    paths["bn254_g2_edge_msm"] = (edge2_launches, g2_edge_widths)
    phase("bn254_g2_edge_msm", points=[len(e_pts), len(eq_pts)],
          level_pairs=g2_edge_widths, rerun_windows=[], correct=True)
    return paths, dict(points=points, sb=sb, main_widths=main_widths,
                       slots=timings["slots"], rr_widths=rr_widths,
                       edge_widths=edge_widths, edge_safe=edge_safe,
                       g2_edge_widths=g2_edge_widths)


def bn254_pairing_phase(counted, dev) -> tuple:
    """`TPairingBN` at `bench_pairing.py`'s size: 64 BN254 pairs from known
    logs plus one with G1 at infinity, once cold and `PAIRING_RUNS` times
    timed on fresh pairs, each product equal to e(G1, G2)^(sum a_i b_i)
    from the port's host `bn254` pairing; the first set's per-pair Miller
    values against the host Miller loop and its product against the host
    multi-pairing; e(aP, bQ) == e(abP, Q).  Returns (launches, the pair
    set to profile)."""
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    R = bn.R
    G1, G2 = bn.G1.generator(), bn.G2.generator()
    tp = tpairing_for("bn254", dev)
    hr = random.Random(SEED + 300)
    t0 = time.perf_counter()
    nsets = 2 + PAIRING_RUNS
    la = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    lb = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    A, B = known_log_points(G1, la, dev), known_log_points(G2, lb, dev)
    sets = []
    for k in range(nsets):
        sl = slice(k * PAIRS, (k + 1) * PAIRS)
        sets.append((list(zip(A[sl], B[sl])) + [(bn.G1.infinity(),
                                                 B[k * PAIRS])],
                     sum(x * y for x, y in zip(la[sl], lb[sl])) % R))
    gt = bn.pairing(G1, G2)
    t_setup = time.perf_counter() - t0

    torch.cuda.synchronize()
    t = time.perf_counter()
    cold = tp.multi_pairing(sets[0][0])
    t_cold = time.perf_counter() - t
    t0 = time.perf_counter()
    lanes = tp.t12.unpack_host(tp.miller_loop_batch(
        *tp.pack_pairs(sets[0][0])))
    if any(m != bn.miller_loop([pq]) for m, pq in zip(lanes, sets[0][0])):
        raise AssertionError("bn254_pairing_64: a lane's Miller value "
                             "differs from the host Miller loop")
    if cold != bn.multi_pairing(sets[0][0]) or cold != gt ** sets[0][1]:
        raise AssertionError("bn254_pairing_64: the product differs from "
                             "the host multi-pairing")
    t_check = time.perf_counter() - t0
    secs, launches = [], None
    for run in range(PAIRING_RUNS):
        pairs, log = sets[1 + run]

        def timed():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tp.multi_pairing(pairs)
            return out, time.perf_counter() - t

        if launches is None:
            (out, dt), launches = drive(counted, timed)
        else:
            out, dt = timed()
        if out != gt ** log:
            raise AssertionError("bn254_pairing_64: a timed multi-pairing "
                                 "differs from its known log")
        secs.append(dt)
    require("bn254_pairing_64", launches, PAIRING_KERNELS)
    if any(launches[k] for k in G1_LEVEL_KERNELS + POINT_KERNELS):
        raise AssertionError(f"bn254_pairing_64 launched a level or point "
                             f"kernel: {launches}")
    a, b = hr.randrange(1, R), hr.randrange(1, R)
    aP, bQ = G1.mul_raw(a).normalize(), G2.mul_raw(b).normalize()
    abP = G1.mul_raw(a * b % R).normalize()
    if not tp.multi_pairing([(aP, bQ), (-abP, G2)]).is_one():
        raise AssertionError("bn254_pairing_64: e(aP, bQ) != e(abP, Q)")
    med = statistics.median(secs)
    phase("bn254_pairing_64", pairs=PAIRS, infinite_pairs=1,
          runs=PAIRING_RUNS, seconds=secs, median_s=med,
          spread=max(secs) / min(secs), cold_s=t_cold,
          pairings_per_s=PAIRS / med, setup_s=t_setup, host_check_s=t_check,
          launches={k: v for k, v in launches.items() if v}, bilinear=True,
          correct=True)
    return launches, sets[-1][0]


def bn254_kernel_checks(row, agree, paths, data, dev) -> list:
    """Every L = 8 instantiation held bit for bit against its plain version
    at the BN254 paths' own shapes, with ragged widths, dead lanes and
    infinite operands, as the L = 12 checks are; returns the kernels-line
    rows (`row`) of each at its path's shape."""
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tcurve import tcurve_for
    from crypto_tpu_torch.fields.tfield import tfield_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    csrc = "crypto_tpu_torch/csrc/"
    ref = "crypto_tpu/ops/pallas/curve_kernels.py:"
    mref = "crypto_tpu/ops/pallas/field_kernels.py:386"
    thr = msm_v2.CHUNK_MIN_PAIRS
    tc, tc2 = tcurve_for(bn.G1, dev), tcurve_for(bn.G2, dev)
    F, F2 = tc.F, tc2.F
    points = data["points"]
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    hr = random.Random(SEED + 401)
    P = bn.P

    # the prove's G2 query MSM shape: 2^16 G2 points at c = 8, from known
    # logs, for the Fq2 level's and the G2 gather's shapes (a probe,
    # outside the counted paths)
    n2 = 1 << BN254_PROBE_LOG
    pts2, dlog2 = make_bench_points(tc2, n2)
    sc2, sb2 = make_bench_scalars(bn.R, n2, SEED + 402)
    t2 = {}
    res2 = msm_v2.msm_device_scheduled(bn.G2, pts2, sb2, c=8, timings=t2)
    want2 = sum(s * dlog2(i) for i, s in enumerate(sc2)) % bn.R
    if res2 != bn.G2.generator().mul_raw(want2):
        raise AssertionError("bn254 G2 probe MSM disagrees with its logs")

    def lvl(M, pts, Fx):
        n = pts.X.shape[1]
        i1 = torch.randint(0, n, (M,), generator=gen, device=dev)
        i2 = torch.randint(0, n, (M,), generator=gen, device=dev)
        lane = torch.arange(M, device=dev)
        i2 = torch.where(lane % 7 < 2, i1, i2)
        x1, y1, x2, y2 = pts.X[:, i1], pts.Y[:, i1], pts.X[:, i2], \
            pts.Y[:, i2]
        y2 = torch.where((lane % 7 == 1)[None], Fx.neg(y2), y2)
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    def add_row(name, src, rep, path, err, fn, plain_ms, args, shape, **kw):
        rows.append(row(name, src, rep, path, err, cuda_ms(fn), plain_ms,
                        args, shape, **kw))

    # ---- mont_mul at the G1 tail's width and ragged, Fr at the 2^16 NTT's
    # stage, the pairing's base products; mont_pow's roots
    for fld, M, path in ((bn.Fq, 16 << 15, "bn254_msm_2^20"),
                         (bn.Fq, (16 << 15) - 3, None),
                         (bn.Fr, 1 << 15, None),
                         (bn.Fq, 2 * (PAIRS + 1), "bn254_pairing_64")):
        Fx = tfield_for(fld, dev)
        ra = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        rb = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        ra[:, :4] = Fx.pack([0, 1, fld.p - 1, fld.p - 1], mont=False)
        rb[:, :4] = ra[:, :4].flip(1)
        ra[:, 4] = rb[:, 5] = -1
        plain, plain_ms = timed_call(lambda: fk.mont_mul_plain(ra, rb,
                                                               Fx.mod))
        err = agree("mont_mul", (fk.mont_mul(ra, rb, Fx.mod),), (plain,),
                    f"on {fld.name} at M={M}")
        if path:
            add_row("mont_mul", csrc + "mont_mul.cu", mref, path, err,
                    lambda: fk.mont_mul(ra, rb, Fx.mod), plain_ms,
                    (ra, rb, Fx.mod), [8, M])
    for M, zero, path in ((1, False, "bn254_msm_2^20"), (1, True, None),
                          (16, False, None), (1 << 16, False, None)):
        x = F.pack([0 if zero else hr.randrange(1, P) for _ in range(M)])
        x[:, 3::5] = 0
        pw, pw_ms = timed_call(lambda: fk.mont_pow_plain(x, P - 2, F.mod))
        err = agree("mont_pow", (fk.mont_pow(x, P - 2, F.mod),), (pw,),
                    f"on bn254.Fq at M={M}")
        if path:
            add_row("mont_pow", csrc + "mont_mul.cu", mref, path, err,
                    lambda: fk.mont_pow(x, P - 2, F.mod), pw_ms,
                    (x, P - 2, F.mod), [8, M])
    phase("check_mont_mul_bn254", fq=[16 << 15, (16 << 15) - 3,
                                      2 * (PAIRS + 1)], fr=[1 << 15],
          mont_pow=[1, 16, 1 << 16], zeros=True, bit_exact=True)

    # ---- the affine levels, both formulas, at the edge MSMs' widths, a
    # ragged count and a 2^20 level width
    for fast, widths in ((False, data["edge_safe"]),
                         (True, data["edge_widths"])):
        w_pre = max(w for w in widths if w < thr)
        if fast:
            pre, post = ck.affine_level_pre_fast, ck.affine_level_post_fast
            pre_p = ck.affine_level_pre_fast_plain
            post_p = ck.affine_level_post_fast_plain
        else:
            pre, post = ck.affine_level_pre, ck.affine_level_post
            pre_p, post_p = ck.affine_level_pre_plain, \
                ck.affine_level_post_plain
        for M in (w_pre, w_pre + 3, min(data["main_widths"])):
            ins = lvl(M, points, F)
            kd = pre(F, *ins)
            pd, pre_ms = timed_call(lambda: pre_p(F, *ins))
            e_pre = agree(pre.__name__, kd, pd, f"at bn254 M={M}")
            d = kd[0].clone()
            d[0] |= F.is_zero(d).to(torch.int32)
            dinv = msm_v2.batch_inv_t(F, d)
            x1, y1, m1, x2, y2, m2 = ins
            args = (x1, y1, x2, y2, dinv, m1, m2) if fast else \
                (x1, y1, x2, y2, dinv, kd[1], m1, m2)
            pp, post_ms = timed_call(lambda: post_p(F, *args))
            e_post = agree(post.__name__, post(F, *args), pp,
                           f"at bn254 M={M}")
            if M == w_pre:
                lines = ("739", "752") if fast else ("533", "548")
                add_row(pre.__name__, csrc + "affine_level.cu",
                        ref + lines[0], "bn254_edge_msm", e_pre,
                        lambda: pre(F, *ins), pre_ms, (F,) + ins, [8, M])
                add_row(post.__name__, csrc + "affine_level.cu",
                        ref + lines[1], "bn254_edge_msm", e_post,
                        lambda: post(F, *args), post_ms, (F,) + args, [8, M])
    phase("check_affine_level_bn254", path="bn254_edge_msm", bit_exact=True)

    # ---- the chunked levels at 524,288 pairs, a width of both the rerun
    # (total formula) and the 2^20 MSM (fast) and the width of the
    # BLS12-381 rows; ragged, and every warp holding an infinite operand
    def chunked(M, inf_warps=False):
        pad = (-M) % msm_v2.CHUNK_PAD
        x1, y1, m1, x2, y2, m2 = lvl(M, points, F)
        x1, y1, x2, y2 = (msm_v2._pad_cols(t, pad, 0)
                          for t in (x1, y1, x2, y2))
        m1, m2 = msm_v2._pad_cols(m1, pad, 1), msm_v2._pad_cols(m2, pad, 1)
        if inf_warps:
            Mp = x1.shape[1]
            lane = torch.arange(Mp, device=dev)
            warp = lane % (Mp // ck.CHUNK_K) // 32
            m1 = ((warp % 4 == 0) | (warp % 4 == 2)
                  | ((warp % 4 == 3) & (lane % 3 == 0))).to(torch.int32)
            m2 = ((warp % 4 == 1) | (warp % 4 == 2)
                  | ((warp % 4 == 3) & (lane % 3 == 1))).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    for fast, path, widths in ((False, "bn254_rerun_2^20",
                                data["rr_widths"]),
                               (True, "bn254_msm_2^20",
                                data["main_widths"])):
        chunk_widths = sorted(w for w in widths if w >= thr)
        w_chunk = 1 << 19 if 1 << 19 in chunk_widths else \
            chunk_widths[len(chunk_widths) // 2]
        if fast:
            prefix, down = ck.chunked_level_prefix_fast, \
                ck.chunked_level_down_fast
            prefix_p = ck.chunked_level_prefix_fast_plain
            down_p = ck.chunked_level_down_fast_plain
        else:
            prefix, down = ck.chunked_level_prefix, ck.chunked_level_down
            prefix_p = ck.chunked_level_prefix_plain
            down_p = ck.chunked_level_down_plain
        for M, iw in ((w_chunk, False), (w_chunk + 5, False),
                      (w_chunk, True)):
            ins = chunked(M, iw)
            kq = prefix(F, *ins)
            pq, prefix_ms = timed_call(lambda: prefix_p(F, *ins))
            e_pre = agree(prefix.__name__, kq, pq, f"at bn254 M={M}")
            total = kq[1].clone()
            total[0] |= F.is_zero(total).to(torch.int32)
            args = ins + (kq[0], msm_v2.batch_inv_t(F, total)) \
                + (() if fast else (kq[2],))
            pdn, down_ms = timed_call(lambda: down_p(F, *args))
            e_down = agree(down.__name__, down(F, *args), pdn,
                           f"at bn254 M={M}")
            if M == w_chunk and not iw:
                lines = ("669", "683") if fast else ("844", "860")
                Mp = ins[0].shape[1]
                add_row(prefix.__name__, csrc + "chunked_level.cu",
                        ref + lines[0], path, e_pre,
                        lambda: prefix(F, *ins), prefix_ms, (F,) + ins,
                        [8, Mp])
                add_row(down.__name__, csrc + "chunked_level.cu",
                        ref + lines[1], path, e_down,
                        lambda: down(F, *args), down_ms, (F,) + args,
                        [8, Mp])
    phase("check_chunked_level_bn254", infinite_operand_in_every_warp=True,
          bit_exact=True)

    # ---- the Fq2 level at the prove's G2 query MSM's narrowest level
    # (the probe), ragged, the G2 edge MSMs' widest and 96 pairs whose
    # first warp mixes doublings, P + (-P) and infinite operands
    g2_widths = t2["level_pairs"]
    w_lvl = min(g2_widths)
    for M in (w_lvl, w_lvl + 5, max(data["g2_edge_widths"]), 96):
        ins = lvl(M, pts2, F2)
        kd = ck.affine_level_pre_fq2(F2, *ins)
        pd, pre_ms = timed_call(lambda: ck.affine_level_pre_plain(F2, *ins))
        e_pre = agree("affine_level_pre_fq2", kd, pd, f"at bn254 M={M}")
        x1, y1, m1, x2, y2, m2 = ins
        args = (x1, y1, x2, y2, msm_v2.batch_inv_t(F2, kd[0]), kd[1], m1,
                m2)
        pp, post_ms = timed_call(lambda: ck.affine_level_post_plain(F2,
                                                                    *args))
        e_post = agree("affine_level_post_fq2",
                       ck.affine_level_post_fq2(F2, *args), pp,
                       f"at bn254 M={M}")
        if M == 96 and not all(int(t.sum()) for t in (
                kd[1][:32], kd[2][:32] & (m1[:32] == 0) & (m2[:32] == 0),
                m1[:32], m2[:32])):
            raise AssertionError("bn254 Fq2 level inputs: a warp without a "
                                 "doubling, P + (-P) or an infinite operand")
        if M == w_lvl:
            add_row("affine_level_pre_fq2", csrc + "affine_level_fq2.cu",
                    ref + "1014", "bn254_legogroth16_prove", e_pre,
                    lambda: ck.affine_level_pre_fq2(F2, *ins), pre_ms,
                    (F2,) + ins, [16, M])
            add_row("affine_level_post_fq2", csrc + "affine_level_fq2.cu",
                    ref + "1029", "bn254_legogroth16_prove", e_post,
                    lambda: ck.affine_level_post_fq2(F2, *args), post_ms,
                    (F2,) + args, [16, M])
    phase("check_affine_level_fq2_bn254", pairs=[w_lvl, w_lvl + 5,
                                                 max(data["g2_edge_widths"]),
                                                 96], g2_probe_level_pairs=
          g2_widths, bit_exact=True)

    # ---- the Fq2 product and square: at the probe's first product-tree
    # width and the pairing's line products (15 a lane) and squares (4 a
    # lane), random coordinates with the edges 0, 1, u, (p-1)(1 + u) and
    # the canonical limbs that bound the lazy reduction
    edges2 = F2.pack([bn.Fq2(0, 0), bn.Fq2(1, 0), bn.Fq2(0, 1),
                      bn.Fq2(P - 1, P - 1)])
    limb_edges = F2.pack([bn.Fq2(P - 1, P - 1), bn.Fq2(0, P - 1),
                          bn.Fq2(P - 1, 0), bn.Fq2(1, 0), bn.Fq2(P - 1, 1)],
                         mont=False)
    lanes = PAIRS + 1
    for M, path in ((w_lvl // 2, "bn254_legogroth16_prove"),
                    (w_lvl // 2 - 3, None),
                    (15 * lanes, "bn254_pairing_64")):
        a = pts2.X[:, torch.randint(0, n2, (M,), generator=gen, device=dev)]
        b = pts2.Y[:, torch.randint(0, n2, (M,), generator=gen, device=dev)]
        a[:, :4], b[:, :4] = edges2, edges2.flip(1)
        a[:, 5:10], b[:, 5:10] = limb_edges, limb_edges
        a[:, 10:15], b[:, 10:15] = limb_edges, limb_edges.flip(1)
        pm, pm_ms = timed_call(lambda: fk.fq2_mul_plain(F, a, b))
        err = agree("fq2_mul", (fk.fq2_mul(F, a, b),), (pm,),
                    f"at bn254 M={M}")
        if path:
            add_row("fq2_mul", csrc + "fq2_mul.cu", ref + "1066", path, err,
                    lambda: fk.fq2_mul(F, a, b), pm_ms, (F, a, b), [16, M])
        a = a.clone()
        a[8:, 15] = a[:8, 15]                        # a0 = a1
        a[8:, 16] = 0                                # a1 = 0
        sq_M = 4 * lanes if path == "bn254_pairing_64" else M
        a = a[:, :sq_M].contiguous()
        ps, ps_ms = timed_call(lambda: fk.fq2_sqr_plain(F, a))
        err = agree("fq2_sqr", (fk.fq2_sqr(F, a),), (ps,),
                    f"at bn254 M={sq_M}")
        if path:
            add_row("fq2_sqr", csrc + "fq2_mul.cu", ref + "908", path, err,
                    lambda: fk.fq2_sqr(F, a), ps_ms, (F, a), [16, sq_M])
    phase("check_fq2_bn254", fq2_mul=[w_lvl // 2, w_lvl // 2 - 3,
                                      15 * lanes],
          fq2_sqr=[w_lvl // 2, w_lvl // 2 - 3, 4 * lanes], limb_edges=True,
          bit_exact=True)

    # ---- the slot tables and the gather at 8 words a row (the 2^20 G1
    # MSM's layout) and 16 (the probe's): each point once a window at
    # random slots, the rest empty, then a ragged count with indices past
    # the table and below -1 and an all-dead tile; the library call is
    # index_select on the clamped index with a zero fill
    g_line = {}
    for tag, Fx, pts, slots, W, path in (
            ("g1", F, points, data["slots"], (bn.Fr.bits + 16) // 16,
             "bn254_msm_2^20"),
            ("g2", F2, pts2, t2["slots"], (bn.Fr.bits + 8) // 8,
             "bn254_legogroth16_prove")):
        n = pts.X.shape[1]
        y = pts.Y.clone()
        y[:, ::4097] = 0
        pt, tables_ms = timed_call(lambda: fk.slot_tables_plain(Fx, pts.X,
                                                                 y))
        e_t = agree("slot_tables", fk.slot_tables(Fx, pts.X, y), pt,
                    f"on bn254 {tag}")
        add_row("slot_tables", csrc + "gather.cu",
                "crypto_tpu/ops/msm_v2.py:719", path, e_t,
                lambda: fk.slot_tables(Fx, pts.X, y), tables_ms,
                (Fx, pts.X, y), [Fx.U, n])
        tab = pt[0]
        for M in (max(slots), n + 3):
            live = min(M, W * n)
            idx = torch.full((M,), -1, dtype=torch.int64, device=dev)
            pos = torch.randperm(M, generator=gen, device=dev)[:live]
            idx[pos] = torch.cat([torch.randperm(n, generator=gen,
                                                 device=dev)
                                  for _ in range(W)])[:live]
            if M == n + 3:
                idx[:3] = torch.tensor([n, n + 9, -5], device=dev)
                idx[256:512] = -1
            pg, gather_ms = timed_call(lambda: fk.gather_rows_t_plain(tab,
                                                                      idx))
            e_g = agree("gather_rows_t", (fk.gather_rows_t(tab, idx),),
                        (pg,), f"on bn254 {tag} at M={M}")
            if M == n + 3:
                break

            def library():
                return tab.t().index_select(1, idx.clamp(min=0)) \
                    .masked_fill_(idx < 0, 0)

            agree("index_select", (library(),), (pg,), f"at bn254 M={M}")
            t_library = cuda_ms(library)
            add_row("gather_rows_t", csrc + "gather.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:356", path, e_g,
                    lambda: fk.gather_rows_t(tab, idx), gather_ms,
                    (tab, idx), [Fx.U, M], library_ms=t_library)
            g_line[tag] = dict(U=Fx.U, slots=M, live=live,
                               library_ms=t_library)
    phase("check_gather_bn254", **g_line, dead_tile=[256, 512],
          bit_exact=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import bn254 as bn
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
    res = build.kernel_resources(
        Path(build.build_info["path"]).with_suffix(".log").read_text())
    sass = build.sass_counts(build.build_info["path"])
    phase("kernel_resources", registers_spill_stores_spill_loads_sass=json.dumps(
        {k: [v.get("registers"), v.get("spill_stores"), v.get("spill_loads"),
             sass.get(k)] for k, v in res.items()}))
    spills = sorted(k for k, v in res.items()
                    if v.get("spill_stores") or v.get("spill_loads"))
    unreported = sorted(set(KERNEL_ENTRY) - {k.split("<")[0] for k in res})
    if spills or unreported:
        raise AssertionError(f"ptxas: spills in {spills}, no report for "
                             f"{unreported}")

    counted = (fk.mont_mul, fk.mont_pow, ck.affine_level_pre,
               ck.affine_level_post,
               ck.chunked_level_prefix, ck.chunked_level_down,
               ck.affine_level_pre_fast, ck.affine_level_post_fast,
               ck.chunked_level_prefix_fast, ck.chunked_level_down_fast,
               pk.jacobian_add, pk.jacobian_add_mixed, pk.jacobian_double,
               pk.jacobian_normalize, fk.fq2_mul, fk.fq2_sqr,
               ck.affine_level_pre_fq2, ck.affine_level_post_fq2,
               fk.gather_rows_t, fk.slot_tables)
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
              gather_launches=launches["gather_rows_t"],
              mont_mul_launches=launches["mont_mul"],
              mont_pow_launches=launches["mont_pow"], correct=True)
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
                                              "mont_mul", "mont_pow"))
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
          mont_pow_launches=bp2_launches["mont_pow"],
          host_g2_mul_raw_s=t_mul2, sample_checked=len(sample2),
          correct=True)

    # ---- the G2 MSM: 2^20 points, c = 16, the reference's Fq2 levels ----
    def g2_msm_checks(where: str, launches: dict, timings: dict) -> None:
        """A G2 MSM runs the Fq2 kernels, the gather, mont_mul and
        mont_pow, no G1 level or point kernel, and no flag or rerun."""
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

    # ---- the QAP witness map at 2^20, and the LegoGroth16 setup and
    # proves at 2^16 constraints
    paths["qap_h_2^20"] = (qap_h_phase(counted, dev), [])
    lego, prove_dev = legogroth16_phases(counted, dev)
    paths.update((k, (v, [])) for k, v in lego.items())
    pair_paths, bbs_widths, profile_pairs = pairing_phases(counted, dev)
    paths.update((k, (v, bbs_widths if k.startswith("bbs") else []))
                 for k, v in pair_paths.items())
    t0 = time.time()
    pok_paths, pok_widths, pok_lanes = bbs_pok_phases(counted, dev)
    paths.update((k, (v, pok_widths if k.startswith("bbs_pok_batch") else []))
                 for k, v in pok_paths.items())
    phase("bbs_pok_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    acc_paths, profile_update = accumulator_phases(counted, dev)
    paths.update((k, (v, [])) for k, v in acc_paths.items())
    phase("accumulator_phases", seconds=round(time.time() - t0, 3))

    # ---- BN254: the 2^20 G1 MSMs and the edge MSMs, the LegoGroth16
    # setup, proves and verifier at 2^16 constraints, the 64-pair pairing
    t0 = time.time()
    bn_paths, bn_data = bn254_msm_phases(counted, dev)
    paths.update(bn_paths)
    bn_lego, _ = legogroth16_phases(counted, dev, bn, "bn254_")
    paths.update((k, (v, [])) for k, v in bn_lego.items())
    bn_pairing, bn_profile_pairs = bn254_pairing_phase(counted, dev)
    paths["bn254_pairing_64"] = (bn_pairing, [])
    bn_union = {f.__name__: sum(v[0][f.__name__] for k, v in paths.items()
                                if k.startswith("bn254_")) for f in counted}
    require("BN254", bn_union, BN254_KERNELS)
    if any(bn_union[k] for k in POINT_KERNELS):
        raise AssertionError(f"a BN254 path launched a point kernel: "
                             f"{bn_union}")
    phase("bn254_phases", seconds=round(time.time() - t0, 3),
          launches={k: v for k, v in bn_union.items() if v})
    phase("launches", **{k: v[0] for k, v in paths.items()})
    never = [f.__name__ for f in counted
             if not any(v[0][f.__name__] for v in paths.values())]
    if never:
        raise AssertionError(f"kernels launched on no path: {never}")

    # ---- kernels vs plain, at the shapes a path gave them -------------
    def row(name, src, rep, path, err, ms, plain_ms, args, shape,
            library_ms=None):
        """The kernels-line entry of `name`, its bound from `work` on the
        wrapper arguments `args` it was timed on."""
        bound = bound_ms(*work(name, args))
        return dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=paths[path][0][name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                    library_ms=library_ms, path=path, shape=shape)

    rows = []
    csrc = "crypto_tpu_torch/csrc/"
    ref = "crypto_tpu/ops/pallas/curve_kernels.py:"

    def agree(name, kernel_out, plain_out, where):
        err = max_err(kernel_out, plain_out)
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"{where}")
        return err

    # mont_mul at the tail's width (16 windows x 2^15 buckets), Fq and Fr,
    # at the 2^20 NTT's Fr shapes: a stage's (8, 2^19) odd halves by
    # their twiddles, the (8, 2^20) pointwise and coset products; and at
    # the witness update's: the scans' (8, 8192), the double-and-add's
    # (12, 16384) over [C_i | V], and a ragged width
    for fld, M, path in ((bls.Fq, 16 << 15, "msm_2^20"),
                         (bls.Fr, 1 << 16, None),
                         (bls.Fr, 1 << (QAP_LOG - 1), "qap_h_2^20"),
                         (bls.Fr, 1 << QAP_LOG, "qap_h_2^20"),
                         (bls.Fr, NMEMBERS, "accumulator_update"),
                         (bls.Fq, 2 * NMEMBERS, "accumulator_update"),
                         (bls.Fq, 2 * NMEMBERS - 3, None)):
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
        if path is not None:
            rows.append(row(
                "mont_mul", csrc + "mont_mul.cu",
                "crypto_tpu/ops/pallas/field_kernels.py:386", path,
                err, cuda_ms(lambda: fk.mont_mul(ra, rb, Fx.mod)), plain_ms,
                (ra, rb, Fx.mod), [L, M]))
    phase("check_mont_mul", fq_pairs=[16 << 15, 2 * NMEMBERS,
                                      2 * NMEMBERS - 3],
          fr_pairs=[1 << 16, 1 << (QAP_LOG - 1), 1 << QAP_LOG, NMEMBERS],
          bit_exact=True)

    # mont_pow's Fermat root at 1 element (each batch_inv_t root), 16 (the
    # tail's to_affine), 2^16 and, on Fq, the witness update's to_affine
    # (8,192), with zeros (0 -> 0), Fq and Fr, against its plain version
    # on the card
    for fld in (bls.Fq, bls.Fr):
        Fx = tfield_for(fld, dev)
        e = fld.p - 2
        hr = random.Random(SEED + 3)
        update = ((NMEMBERS, False),) if fld is bls.Fq else ()
        for M, zero in ((1, False), (1, True), (16, False),
                        (1 << 16, False)) + update:
            x = Fx.pack([0 if zero else hr.randrange(1, fld.p)
                         for _ in range(M)])
            x[:, 3::5] = 0
            plain, plain_ms = timed_call(lambda: fk.mont_pow_plain(x, e,
                                                                   Fx.mod))
            err = agree("mont_pow", (fk.mont_pow(x, e, Fx.mod),), (plain,),
                        f"on {fld.name} at M={M}")
            if fld is bls.Fq and (M, zero) in ((1, False),
                                               (NMEMBERS, False)):
                rows.append(row(
                    "mont_pow", csrc + "mont_mul.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:386",
                    "msm_2^20" if M == 1 else "accumulator_update",
                    err, cuda_ms(lambda: fk.mont_pow(x, e, Fx.mod)),
                    plain_ms, (x, e, Fx.mod), [Fx.L, M]))
    phase("check_mont_pow", elements=[1, 16, 1 << 16, NMEMBERS], zeros=True,
          fields=["Fq", "Fr"], bit_exact=True)

    # one Fermat root, in turns: the chain of 608 mont_mul launches from a
    # host loop (what TField.inv did) against one mont_pow launch
    Fq_ = tfield_for(bls.Fq, dev)
    e = bls.P - 2

    def chain(a):
        acc = a
        for bit in bin(e)[3:]:
            acc = fk.mont_mul(acc, acc, Fq_.mod)
            if bit == "1":
                acc = fk.mont_mul(acc, a, Fq_.mod)
        return acc

    hr = random.Random(SEED + 4)
    root = {}
    for M in (1, 16):
        a = Fq_.pack([hr.randrange(1, bls.P) for _ in range(M)])
        want = fk.mont_pow_plain(a, e, Fq_.mod)
        for kind in ("chain", "mont_pow", "mont_pow", "chain"):
            fn = (lambda: chain(a)) if kind == "chain" else \
                (lambda: fk.mont_pow(a, e, Fq_.mod))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            if not torch.equal(out, want):
                raise AssertionError(f"Fermat root by {kind} disagrees at "
                                     f"M={M}")
            root.setdefault(f"{kind}_{M}_wall_ms", []).append(wall)
            root.setdefault(f"{kind}_{M}_event_ms", []).append(
                start.elapsed_time(stop))
    # the chain runs one product a launch; at 1 to 16 elements the floor
    # that binds is the latency of the shortest chain's dependent
    # products, here at mont_pow's own time a product
    before = fk.mont_mul.launches
    chain(a)
    run = fk.mont_mul.launches - before
    per_product_us = statistics.median(root["mont_pow_1_event_ms"]) / run * 1e3
    phase("fermat_root", launches_chain=run,
          chain_muls_bound=sum(chain_ops(e)), per_product_us=per_product_us,
          latency_floor_ms=sum(chain_ops(e)) * per_product_us / 1e3, **root,
          correct=True)

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
        lines = ("739", "752") if fast else ("533", "548")
        rows.append(row(pre.__name__, csrc + "affine_level.cu",
                        ref + lines[0], path, e_pre,
                        cuda_ms(lambda: pre(F, *ins)), pre_ms, (F,) + ins,
                        [12, M]))
        rows.append(row(post.__name__, csrc + "affine_level.cu",
                        ref + lines[1], path, e_post,
                        cuda_ms(lambda: post(F, *args)), post_ms,
                        (F,) + args, [12, M]))

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

    def infinite_warps(ins):
        """chunked_inputs with masks by warp: in every strip (pairs t +
        j*T), warps of threads all with P1 infinite, all with P2, all
        with both, and warps that mix the three with finite pairs."""
        Mp = ins[0].shape[1]
        lane = torch.arange(Mp, device=dev)
        warp = lane % (Mp // ck.CHUNK_K) // 32
        m1 = (warp % 4 == 0) | (warp % 4 == 2) \
            | ((warp % 4 == 3) & (lane % 3 == 0))
        m2 = (warp % 4 == 1) | (warp % 4 == 2) \
            | ((warp % 4 == 3) & (lane % 3 == 1))
        return ins[:2] + (m1.to(torch.int32),) + ins[3:5] \
            + (m2.to(torch.int32),)

    def check_chunked(M: int, path: str | None, fast: bool,
                      inf_warps: bool = False):
        ins = chunked_inputs(M)
        if inf_warps:
            ins = infinite_warps(ins)
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
        lines = ("669", "683") if fast else ("844", "860")
        rows.append(row(prefix.__name__, csrc + "chunked_level.cu",
                        ref + lines[0], path, e_pre,
                        cuda_ms(lambda: prefix(F, *ins)), prefix_ms,
                        (F,) + ins, [12, Mp]))
        rows.append(row(down.__name__, csrc + "chunked_level.cu",
                        ref + lines[1], path, e_down,
                        cuda_ms(lambda: down(F, *args)), down_ms,
                        (F,) + args, [12, Mp]))

    for fast, path, widths in ((False, "rerun_2^20", rr_widths),
                               (True, "msm_2^20", main_widths)):
        w_chunk = min(w for w in widths if w >= thr)
        check_chunked(w_chunk, path, fast)
        check_chunked(w_chunk + 5, None, fast)
        check_chunked(w_chunk, None, fast, inf_warps=True)
        phase("check_chunked_level_fast" if fast else "check_chunked_level",
              pairs=[w_chunk, w_chunk + 5], path=path,
              infinite_operand_in_every_warp=True, bit_exact=True)
    # the PoK batch verify's two 256-point MSMs: every fast level width
    # they ran (chunked from the threshold up, affine below it; the
    # phase found none to rerun), a row at each
    pok_path = "bbs_pok_batch_verify_256"
    for w in sorted(set(pok_widths)):
        (check_chunked if w >= thr else check_pre_post)(w, pok_path, True)
    phase("check_level_fast", path=pok_path,
          pairs=sorted(set(pok_widths)), bit_exact=True)

    # the fast down pass at each level width of the 2^20 MSM: where its
    # per-MSM time and its gap to the bound live
    per_width = []
    for w in main_widths:
        ins = chunked_inputs(w)
        fq = ck.chunked_level_prefix_fast(F, *ins)
        tot = fq[1].clone()
        tot[0] |= F.is_zero(tot).to(torch.int32)
        args = ins + (fq[0], msm_v2.batch_inv_t(F, tot))
        t_down = cuda_ms(lambda: ck.chunked_level_down_fast(F, *args))
        bound = bound_ms(*work("chunked_level_down_fast", (F,) + args))[0]
        per_width.append([ins[0].shape[1], t_down, bound, t_down / bound])
        del ins, fq, tot, args
    phase("down_fast_widths", pairs_ms_bound_ms_ratio=json.dumps(per_width),
          ms_sum=sum(r[1] for r in per_width),
          bound_sum=sum(r[2] for r in per_width))

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
                    (F,) + args, [12, n]))
    # and on warps of one kind each, in turn: P1 infinite, P2 infinite,
    # both, P + P, P + (-P), then the mixed lanes of point_inputs
    (X1, Y1, Z1), (X2, Y2, Z2), _ = pt_in
    kind = torch.arange(n, device=dev) // 32 % 6
    zero, one = F.zeros((n,)), F.ones((n,))
    Zf = torch.where(F.is_zero(Z1)[None], one, Z1)          # finite Z1
    same = ((kind == 3) | (kind == 4))[None]
    Z1w = torch.where(((kind == 0) | (kind == 2))[None], zero, Zf)
    Z1w = torch.where((kind == 5)[None], Z1, Z1w)
    Z2w = torch.where(((kind == 1) | (kind == 2))[None], zero,
                      torch.where(same, Zf, one))
    Z2w = torch.where((kind == 5)[None], Z2, Z2w)
    X2w = torch.where(same, X1, X2)
    Y2w = torch.where((kind == 3)[None], Y1,
                      torch.where((kind == 4)[None], F.neg(Y1), Y2))
    w_args = (X1, Y1, Z1w, X2w, Y2w, Z2w)
    pw = pk.jacobian_add_plain(F, *w_args)
    agree("jacobian_add", pk.jacobian_add(F, *w_args), pw,
          "on warps of one kind")
    if not (bool(pw[3][kind == 3].all()) and not bool(pw[3][kind < 3].any())
            and bool(F.is_zero(pw[2])[kind == 4].all())):
        raise AssertionError("full-add warp inputs: P + P without the flag "
                             "or P + (-P) not at infinity")
    add_warps_ms = cuda_ms(lambda: pk.jacobian_add(F, *w_args))
    pm, mix_ms = timed_call(lambda: pk.jacobian_add_mixed_plain(F, *aff))
    e_mix = agree("jacobian_add_mixed", pk.jacobian_add_mixed(F, *aff), pm,
                  f"at M={n}")
    rows.append(row("jacobian_add_mixed", csrc + "jacobian.cu", ref + "347",
                    "add_fns_2^20", e_mix,
                    cuda_ms(lambda: pk.jacobian_add_mixed(F, *aff)), mix_ms,
                    (F,) + aff, [12, n]))
    pdb, dbl_ms = timed_call(lambda: pk.jacobian_double_plain(F, *J))
    e_dbl = agree("jacobian_double", pk.jacobian_double(F, *J), pdb,
                  f"at M={n}")
    rows.append(row("jacobian_double", csrc + "jacobian.cu", ref + "360",
                    "add_fns_2^20", e_dbl,
                    cuda_ms(lambda: pk.jacobian_double(F, *J)), dbl_ms,
                    (F,) + J, [12, n]))
    # and with Y1 = 0 lanes (no point of G1 has one: raw coordinates)
    lane = torch.arange(n, device=dev)
    J_y0 = (J[0], torch.where((lane % 29 == 7)[None], 0, J[1]), J[2])
    agree("jacobian_double", pk.jacobian_double(F, *J_y0),
          pk.jacobian_double_plain(F, *J_y0), "with Y1 = 0 lanes")
    phase("check_jacobian", full_add_rows=[1 << 14, n], mixed_add_rows=n,
          double_rows=n, double_y1_zero_lanes=int((lane % 29 == 7).sum()),
          full_add_warps_of_one_kind=True,
          full_add_warps_ms=add_warps_ms, bit_exact=True)
    pn, norm_ms = timed_call(lambda: pk.jacobian_normalize_plain(F, *J))
    e_norm = agree("jacobian_normalize", pk.jacobian_normalize(F, *J), pn,
                   f"at M={n}")
    rows.append(row("jacobian_normalize", csrc + "normalize.cu",
                    ref + "390", "bench_points_2^20", e_norm,
                    cuda_ms(lambda: pk.jacobian_normalize(F, *J), reps=5),
                    norm_ms, (F,) + J, [12, n]))
    # ragged widths about the kernel's chunk k and block T, a batch of
    # infinities, and infinities at the first and the last point of every
    # thread's chunk with one block's chunks all infinite.  A ragged width
    # is a prefix of J, so its plain outputs are the prefix of the full
    # width's (a lane's affine coordinates are unique, whatever the batch:
    # `_inverse_plain`); the two infinite cases run the plain version.
    zs = normalize_cases(J[2], pk.NORMALIZE_CHUNK, pk.NORMALIZE_THREADS)
    for where, z in zs.items():
        M = z.shape[1]
        ins = tuple(t[:, :M].contiguous() for t in J[:2]) + (z,)
        plain = tuple(t[:, :M] for t in pn) if where == f"M={M}" \
            else pk.jacobian_normalize_plain(F, *ins)
        agree("jacobian_normalize", pk.jacobian_normalize(F, *ins), plain,
              where)
    phase("check_normalize", points=n, infinite=int(F.is_zero(J[2]).sum()),
          chunk=pk.NORMALIZE_CHUNK, threads=pk.NORMALIZE_THREADS,
          shape="B (one chain a block)",
          checked=list(zs), bound_squares_products_per_point=[1, 6],
          bound_chain_squares_products=list(chain_ops(bls.P - 2)),
          bit_exact=True)

    # ---- the Fq2 mul at the first product-tree width of the G2 MSM's
    # narrowest level, and a ragged count; random curve coordinates, the
    # edges 0, 1, u, (p-1)(1 + u) and a square, and the canonical limbs
    # that bound the lazy reduction: a0 + a1 >= p ((p-1)(1 + u) squared),
    # v0 = 0 with v1 = (p-1)^2 ((p-1)u squared), 0, 1 and p - 1 + u
    w_fq2 = min(g2_widths) // 2
    gen2 = torch.Generator(device=dev).manual_seed(SEED + 2)
    P = bls.P
    fq2_edges = F2.pack([bls.Fq2(0, 0), bls.Fq2(1, 0), bls.Fq2(0, 1),
                         bls.Fq2(P - 1, P - 1)])
    fq2_limb_edges = F2.pack([bls.Fq2(P - 1, P - 1), bls.Fq2(0, P - 1),
                              bls.Fq2(0, 0), bls.Fq2(1, 0),
                              bls.Fq2(P - 1, 1)], mont=False)
    for M in (w_fq2, w_fq2 - 3):
        a = points2.X[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        b = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4], b[:, :4] = fq2_edges, fq2_edges.flip(1)
        b[:, 4] = a[:, 4]
        a[:, 5:10], b[:, 5:10] = fq2_limb_edges, fq2_limb_edges
        a[:, 10:15], b[:, 10:15] = fq2_limb_edges, fq2_limb_edges.flip(1)
        pm, fq2_ms = timed_call(lambda: fk.fq2_mul_plain(F2.base, a, b))
        e_fq2 = agree("fq2_mul", (fk.fq2_mul(F2.base, a, b),), (pm,),
                      f"at M={M}")
        if M == w_fq2:
            rows.append(row(
                "fq2_mul", csrc + "fq2_mul.cu", ref + "1066", "g2_msm_2^20",
                e_fq2, cuda_ms(lambda: fk.fq2_mul(F2.base, a, b)), fq2_ms,
                (F2.base, a, b), [24, M]))
    phase("check_fq2_mul", pairs=[w_fq2, w_fq2 - 3], path="g2_msm_2^20",
          limb_edges=True, bit_exact=True)

    # ---- the Fq2 square at the G2 tail's widest (the first reduction of
    # 16 windows x 2^15 buckets: 2^18 sums), and a ragged count, on the
    # same kind of inputs, with a0 = a1, a1 = 0, (p-1) + 0u and 0 + (p-1)u
    # beside the edges and the canonical limbs of the product check
    w_sq = 16 << 14
    sqr_edges = F2.pack([bls.Fq2(P - 1, 0), bls.Fq2(0, P - 1)])
    for M in (w_sq, w_sq - 5):
        a = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4] = fq2_edges
        a[:, 4:6] = sqr_edges
        a[12:, 6] = a[:12, 6]                        # a0 = a1
        a[12:, 7] = 0                                # a1 = 0
        a[:, 8:13] = fq2_limb_edges
        ps, sqr_ms = timed_call(lambda: fk.fq2_sqr_plain(F2.base, a))
        e_sq = agree("fq2_sqr", (fk.fq2_sqr(F2.base, a),), (ps,),
                     f"at M={M}")
        if M == w_sq:
            rows.append(row(
                "fq2_sqr", csrc + "fq2_mul.cu", ref + "908", "g2_msm_2^20",
                e_sq, cuda_ms(lambda: fk.fq2_sqr(F2.base, a)), sqr_ms,
                (F2.base, a), [24, M]))
    phase("check_fq2_sqr", elements=[w_sq, w_sq - 5], path="g2_msm_2^20",
          edges="a0=a1,a1=0,(p-1)+0u,0+(p-1)u", bit_exact=True)

    # the square's device time a launch from the tail's widest call down
    # to 16 elements, where what is left is the floor of a launch: its
    # start and one thread's dependent products
    from torch.profiler import ProfilerActivity, profile
    sq_widths = []
    for M in (w_sq, 1 << 14, 1 << 11, 16):
        a = points2.Y[:, :M].contiguous()
        fk.fq2_sqr(F2.base, a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fk.fq2_sqr(F2.base, a)
            torch.cuda.synchronize()
        k = [e for e in prof.key_averages() if "fq2_sqr_kernel" in e.key]
        seen = sum(e.count for e in k)
        if seen:
            ms, by = sum(e.self_device_time_total for e in k) / seen / 1e3, \
                "profiler"
        else:   # a short trace can come back empty: CUDA events instead
            ms, by = cuda_ms(lambda: fk.fq2_sqr(F2.base, a), reps=20), \
                "cuda_events"
        bound = bound_ms(*work("fq2_sqr", (F2.base, a)))[0]
        sq_widths.append([M, ms, bound, ms / bound, by])
    phase("fq2_sqr_widths",
          elements_device_ms_bound_ms_ratio_timer=json.dumps(sq_widths))

    # ---- the pairing paths' narrow batches at n lanes (65 in the
    # multi-pairing, 2 in the PoK batch verify's 2-pairing, 44 in the PoK
    # checker's Miller product): Fq2 products 15 a lane (the line
    # product, the row), 12 a lane (the Fq12 square) and 18 at one lane
    # (the final exponentiation's Fq12 product); squares 4 a lane (the
    # doubling step, the row), 2 a lane and 9 at one lane (the
    # cyclotomic square); mont_mul 4 base products a lane (the lines'
    # scaling, the row) and 2; mont_pow's Fq inverse at one element.
    # Random elements with the edges 0, 1 and p - 1 first; each path's
    # rows at its widest batch of each kernel.
    hr = random.Random(SEED + 110)
    Fq_ = F2.base

    def fq2_rand(M: int) -> torch.Tensor:
        t = F2.pack([bls.Fq2(hr.randrange(P), hr.randrange(P))
                     for _ in range(M)])
        k = min(M, 4)
        t[:, :k] = fq2_edges[:, :k]
        return t

    def check_pairing_kernels(lanes: int, path: str) -> None:
        for M in (15 * lanes, 12 * lanes, 18):
            a, b = fq2_rand(M), fq2_rand(M).flip(1)
            pm, pm_ms = timed_call(lambda: fk.fq2_mul_plain(Fq_, a, b))
            err = agree("fq2_mul", (fk.fq2_mul(Fq_, a, b),), (pm,),
                        f"on {path} at M={M}")
            if M == 15 * lanes:
                rows.append(row(
                    "fq2_mul", csrc + "fq2_mul.cu", ref + "1066", path, err,
                    cuda_ms(lambda: fk.fq2_mul(Fq_, a, b)), pm_ms,
                    (Fq_, a, b), [24, M]))
        for M in (4 * lanes, 2 * lanes, 9):
            a = fq2_rand(M)
            ps, ps_ms = timed_call(lambda: fk.fq2_sqr_plain(Fq_, a))
            err = agree("fq2_sqr", (fk.fq2_sqr(Fq_, a),), (ps,),
                        f"on {path} at M={M}")
            if M == 4 * lanes:
                rows.append(row(
                    "fq2_sqr", csrc + "fq2_mul.cu", ref + "908", path, err,
                    cuda_ms(lambda: fk.fq2_sqr(Fq_, a)), ps_ms, (Fq_, a),
                    [24, M]))
        for M in (4 * lanes, 2):
            a, b = fq2_rand(M)[:FQ_LIMBS], fq2_rand(M)[FQ_LIMBS:]
            pm, pm_ms = timed_call(lambda: fk.mont_mul_plain(a, b, Fq_.mod))
            err = agree("mont_mul", (fk.mont_mul(a, b, Fq_.mod),), (pm,),
                        f"on {path} at M={M}")
            if M == 4 * lanes:
                rows.append(row(
                    "mont_mul", csrc + "mont_mul.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:386", path, err,
                    cuda_ms(lambda: fk.mont_mul(a, b, Fq_.mod)), pm_ms,
                    (a, b, Fq_.mod), [FQ_LIMBS, M]))
        phase("check_pairing_kernels", path=path, lanes=lanes,
              fq2_mul=[15 * lanes, 12 * lanes, 18],
              fq2_sqr=[4 * lanes, 2 * lanes, 9], mont_mul=[4 * lanes, 2],
              bit_exact=True)

    check_pairing_kernels(PAIRS + 1, "pairing_64")
    for path, lanes in pok_lanes.items():
        check_pairing_kernels(lanes, path)
    a = Fq_.pack([hr.randrange(1, P)])
    pw, pw_ms = timed_call(lambda: fk.mont_pow_plain(a, P - 2, Fq_.mod))
    err = agree("mont_pow", (fk.mont_pow(a, P - 2, Fq_.mod),), (pw,),
                "at the pairing's inverse")
    rows.append(row(
        "mont_pow", csrc + "mont_mul.cu",
        "crypto_tpu/ops/pallas/field_kernels.py:386", "pairing_64", err,
        cuda_ms(lambda: fk.mont_pow(a, P - 2, Fq_.mod)), pw_ms,
        (a, P - 2, Fq_.mod), [FQ_LIMBS, 1]))
    phase("check_pairing_inverse", mont_pow=[1], bit_exact=True)

    # ---- the Fq2 level at the G2 MSM's narrowest level, a ragged count
    # and the G2 edge MSMs' widest level
    def check_fq2_level(M: int, path: str | None):
        ins = level_inputs(M, points2, F2)
        kd = ck.affine_level_pre_fq2(F2, *ins)
        pd, pre_ms = timed_call(lambda: ck.affine_level_pre_plain(F2, *ins))
        e_pre = agree("affine_level_pre_fq2", kd, pd, f"at M={M}")
        x1, y1, m1, x2, y2, m2 = ins
        # every warp mixes doublings, P + (-P) and infinite operands
        warp = [kd[1][:32], kd[2][:32] & (m1[:32] == 0) & (m2[:32] == 0),
                m1[:32], m2[:32]]
        if M > 64 and not all(int(t.sum()) for t in warp):
            raise AssertionError("Fq2 level check inputs: a warp without a "
                                 "doubling, P + (-P) or an infinite operand")
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
                        pre_ms, (F2,) + ins, [24, M]))
        rows.append(row("affine_level_post_fq2",
                        csrc + "affine_level_fq2.cu", ref + "1029", path,
                        e_post,
                        cuda_ms(lambda: ck.affine_level_post_fq2(F2, *args)),
                        post_ms, (F2,) + args, [24, M]))

    w_lvl = min(g2_widths)
    check_fq2_level(w_lvl, "g2_msm_2^20")
    check_fq2_level(w_lvl + 5, None)
    check_fq2_level(max(g2_edge_widths), None)
    check_fq2_level(96, None)
    phase("check_affine_level_fq2",
          pairs=[w_lvl, w_lvl + 5, max(g2_edge_widths), 96],
          path="g2_msm_2^20", bit_exact=True)

    # ---- the slot tables of each MSM's 2^20 points, and the gather at
    # each MSM's layout: the curve's point-major x table (2^20 rows of 12
    # or 24 words, as `slot_tables` builds it) into the MSM's largest slot
    # count, each point once a window at random slots, the rest empty
    # (-1); then a ragged count with indices past the table and below -1
    # (a zero column on both sides) and one all-dead tile of 256 slots.
    # The library call is index_select on the clamped index of the
    # point-major table with a zero fill, timed here and used nowhere.
    W2 = (bls.Fr.bits + 16) // 16
    g_line = {}
    for tag, Fx, pts, slots in (("g1", F, points, timings["slots"]),
                                ("g2", F2, points2, t2["slots"])):
        # the tables, with y = 0 at some points, and on G2 y's c1 alone
        # at others (-0 = 0 in each component)
        y = pts.Y.clone()
        y[:, ::4097] = 0
        if Fx.U == 24:
            y[12:, 5::4097] = 0
        pt, tables_ms = timed_call(lambda: fk.slot_tables_plain(Fx, pts.X,
                                                                 y))
        e_t = agree("slot_tables", fk.slot_tables(Fx, pts.X, y), pt,
                    f"on {tag}")
        t_tables = cuda_ms(lambda: fk.slot_tables(Fx, pts.X, y))
        g_line[tag + "_tables_ms"] = t_tables
        if tag == "g2":
            rows.append(row("slot_tables", csrc + "gather.cu",
                            "crypto_tpu/ops/msm_v2.py:719", "g2_msm_2^20",
                            e_t, t_tables, tables_ms, (Fx, pts.X, y),
                            [24, n]))
        tab = pt[0]
        for M in (max(slots), n + 3):
            live = min(M, W2 * n)
            idx = torch.full((M,), -1, dtype=torch.int64, device=dev)
            pos = torch.randperm(M, generator=gen2, device=dev)[:live]
            idx[pos] = torch.cat([torch.randperm(n, generator=gen2,
                                                 device=dev)
                                  for _ in range(W2)])[:live]
            if M == n + 3:
                idx[:3] = torch.tensor([n, n + 9, -5], device=dev)
                idx[256:512] = -1
            pg, gather_ms = timed_call(lambda: fk.gather_rows_t_plain(tab,
                                                                      idx))
            e_g = agree("gather_rows_t", (fk.gather_rows_t(tab, idx),), (pg,),
                        f"on {tag} at M={M}")
            if M == n + 3:  # index_select would fault on the indices >= N
                break

            def library():
                return tab.t().index_select(1, idx.clamp(min=0)) \
                    .masked_fill_(idx < 0, 0)

            agree("index_select", (library(),), (pg,), f"at M={M}")
            t_kernel = cuda_ms(lambda: fk.gather_rows_t(tab, idx))
            t_library = cuda_ms(library)
            g_line[tag] = dict(U=Fx.U, slots=M, live=live, ms=t_kernel,
                               plain_ms=gather_ms, library_ms=t_library,
                               bound_ms=bound_ms(*work("gather_rows_t",
                                                       (tab, idx)))[0])
            if tag == "g2":
                rows.append(row("gather_rows_t", csrc + "gather.cu",
                                "crypto_tpu/ops/pallas/field_kernels.py:356",
                                "g2_msm_2^20", e_g, t_kernel, gather_ms,
                                (tab, idx), [24, M], library_ms=t_library))
    phase("check_gather", ragged_slots=n + 3, dead_tile=[256, 512],
          **g_line, bit_exact=True)

    # ---- every L = 8 instantiation at the BN254 paths' shapes
    rows.extend(bn254_kernel_checks(row, agree, paths, bn_data, dev))

    # ---- device busy share of one more 2^20 MSM of each curve, and each
    # kernel's device time and summed bound over one MSM ----------------
    for tag, curve, pts, scalars, safe in (
            ("", bls.G1, points, sb, False),
            ("_safe", bls.G1, points, sb, True),
            ("_g2", bls.G2, points2, sb, False),
            ("_bn254", bn.G1, bn_data["points"], bn_data["sb"], False)):
        def msm():
            return msm_v2.msm_device_scheduled(curve, pts, scalars, c=16,
                                               safe=safe)

        device, bounds = record_work(
            counted, lambda: device_profile("profile" + tag, msm))
        phase("per_msm" + tag, launches_device_ms_bound_ms=json.dumps(
            {k: [cnt, round(device.get(k, (0, 0.0))[1], 4), round(b, 4)]
             for k, (cnt, b) in bounds.items() if cnt}))

    # ---- one more 64-pair multi-pairing: the device's busy share, and
    # each kernel's launches, device time and summed bound a pairing
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    tp = tpairing_for("bls12_381", dev)

    def pairing():
        return tp.multi_pairing(profile_pairs)

    device, bounds = record_work(
        counted, lambda: device_profile("profile_pairing_64", pairing,
                                        cpu=False))
    phase("per_pairing_64", launches_device_ms_bound_ms=json.dumps(
        {k: [cnt, round(device.get(k, (0, 0.0))[1], 4), round(b, 6)]
         for k, (cnt, b) in bounds.items() if cnt}))

    # ---- one more BN254 64-pair multi-pairing: the same
    tp_bn = tpairing_for("bn254", dev)

    def bn_pairing():
        return tp_bn.multi_pairing(bn_profile_pairs)

    device, bounds = record_work(
        counted, lambda: device_profile("profile_bn254_pairing_64",
                                        bn_pairing, cpu=False))
    phase("per_bn254_pairing_64", launches_device_ms_bound_ms=json.dumps(
        {k: [cnt, round(device.get(k, (0, 0.0))[1], 4), round(b, 6)]
         for k, (cnt, b) in bounds.items() if cnt}))

    # ---- one more witness update (a): the same for the accumulator
    device, bounds = record_work(
        counted, lambda: device_profile("profile_accumulator_update",
                                        profile_update, cpu=False))
    phase("per_accumulator_update", launches_device_ms_bound_ms=json.dumps(
        {k: [cnt, round(device.get(k, (0, 0.0))[1], 4), round(b, 6)]
         for k, (cnt, b) in bounds.items() if cnt}))

    # ---- rows 2 and 5 (the total and the fast affine level) on the paths
    # that launch them: device time a launch from the profiler against a
    # latency floor, a launch plus one thread's dependent products at
    # mont_pow's time a product (fermat_root): none in a pre, 4 in the
    # total post's doubling lanes, 3 in the fast post.  A launch is the
    # cheaper pre's device time a launch on the same path (loads, a
    # compare and a store, no product), so a pre sits at its floor.
    edge_dev = device_profile("profile_edge_msm", edges)
    rank = {}
    for where, by_entry in (("edge_msm", edge_dev),
                            ("legogroth16_prove", prove_dev)):
        per = {k: ms / cnt * 1e3 for k, (cnt, ms) in by_entry.items()
               if k.startswith("affine_level_p") and not k.endswith("fq2")}
        pres = [us for k, us in per.items() if "_pre" in k]
        if not pres:
            continue
        for k, us in per.items():
            floor = min(pres) + (0 if "_pre" in k else
                                 3 if k.endswith("fast") else 4) \
                * per_product_us
            rank[f"{where}:{k}"] = [by_entry[k][0], us, floor, floor / us]
    phase("rank_affine_level", per_product_us=per_product_us,
          launches_us_floor_us_floor_share=json.dumps(rank))
    phase("total", seconds=round(time.time() - t_start, 3))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
