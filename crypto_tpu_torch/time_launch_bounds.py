"""Time the G1 full Jacobian add, the double, the normalize and the
total-formula down pass under several builds, in turns.

    python3 -m crypto_tpu_torch.time_launch_bounds [--reps 3]
        [--kernels full_add double normalize down]

On one CUDA card: writes copies of `csrc/jacobian.cu` under build/ with
its block size `T` and the full add's `FULL_ADD_BLOCKS` or the double's
`DOUBLE_BLOCKS` (threads a block, and the blocks an SM that
`__launch_bounds__` asks room for: together they cap the registers a
thread) set to each pair below, the full add also with its squares taken
as products (`mont_mul_eo(a, a)`); copies of `csrc/normalize.cu` with
each width of its Fermat chain's window (`CHAIN_WINDOW`, 1: the binary
chain) at each batch-inversion shape (`NORMALIZE_SHAPES`: `CHUNK` points
a thread, and `TREE_LOG` 0, one chain a thread, shape A, or 7, one chain
a block of 128, shape B); and copies of `csrc/chunked_level.cu` with
each value of `DOWN_BLOCKS`.  Builds each with nvcc for sm_90a as a
library of its own (not the port's), and reads each kernel's registers,
spills and SASS instruction count.  Then it holds every build bit for
bit against the others and the port's plain version on the same
canonical inputs, and times the builds in turns: the full add at (12,
2^20) with infinite operands, P + P and P + (-P) among random lanes; the
double at (12, 2^20) with Z1 = 0 and Y1 = 0 lanes; the normalize at (12,
2^20) with infinite lanes, and the shipped shape's builds also at one
point (a launch and one chain's latency), every build also checked at 1
and 1,000 points; the down pass at each level width of the 2^20 G1 MSM
with infinite operands in every warp and a doubling lane in one warp of
32.  Each repetition runs the builds in order, then in reverse, each
reading the CUDA-event mean of 20 launches (5 for the down pass and the
normalize) after a warm-up.
Prints the card's name and power limit and, as the last line, a JSON
object with each build's readings, their median, registers, spills and
SASS count, and for the down pass its sum over the MSM's nine level
calls.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys

import torch

from .curves import bls12_381 as bls
from .fields.tfield import tfield_for
from .ops.kernels import build
from .ops.kernels.curve_kernels import CHUNK_K, chunked_level_down_plain
from .ops.kernels.point_kernels import jacobian_add_plain, \
    jacobian_double_plain, jacobian_normalize_plain
from .time_sqr_designs import LEVEL_PAIRS, _event_ms, _limbs

# the full add with its squares as products, mont_mul_eo(a, a): fewer
# live words than mont_sqr's wide square, 300 wide products against 234
SQR_BY_MUL = (r"ctt::mont_sqr<N>\((\w+), (\w+), m\)",
              r"ctt::mont_mul_eo<N>(\1, \2, \2, m)")


def _bounds(threads: int, blocks: int, name: str = "FULL_ADD") -> list:
    return [(r"constexpr int T = 128;", f"constexpr int T = {threads};"),
            (rf"constexpr int {name}_BLOCKS = \d+;",
             f"constexpr int {name}_BLOCKS = {blocks};")]


# the normalize's shapes at 128 threads a block: (CHUNK, TREE_LOG), a
# chain a thread (A) or a block (B); B_k16 ships
NORMALIZE_SHAPES = {"A_k32": (32, 0), "A_k64": (64, 0), "B_k8": (8, 7),
                    "B_k16": (16, 7), "B_k32": (32, 7)}
# kernel -> (source, kernel function, C entry point, {build: the
# substitutions (regex, replacement) that make the build's copy})
BUILDS = {
    "full_add": ("jacobian.cu", "full_add_kernel<12>", "crypto_jac_add", {
        **{f"{t}x{k}": _bounds(t, k) for t, k in (
            (128, 2), (64, 5), (32, 10), (32, 11), (128, 3), (128, 4))},
        **{f"{t}x{k}_sqr_by_mul": [SQR_BY_MUL, *_bounds(t, k)]
           for t, k in ((32, 11), (128, 3))}}),
    "double": ("jacobian.cu", "double_kernel<12>", "crypto_jac_double", {
        f"{t}x{k}": _bounds(t, k, "DOUBLE") for t, k in (
            (128, 1), (128, 2), (128, 3), (128, 4), (256, 2))}),
    "normalize": ("normalize.cu", "normalize_kernel<12>", "crypto_normalize", {
        f"w{w}_{k}": [(r"constexpr int CHAIN_WINDOW = \d+;",
                       f"constexpr int CHAIN_WINDOW = {w};"),
                      (r"constexpr int CHUNK = \d+;",
                       f"constexpr int CHUNK = {chunk};"),
                      (r"constexpr int TREE_LOG = \d+;",
                       f"constexpr int TREE_LOG = {tree_log};")]
        for w in (1, 4, 5)
        for k, (chunk, tree_log) in NORMALIZE_SHAPES.items()}),
    "down": ("chunked_level.cu", "down_kernel<12>", "crypto_chunked_down", {
        str(k): [(r"constexpr int DOWN_BLOCKS = 4;",
                  f"constexpr int DOWN_BLOCKS = {k};")] for k in (4, 5)}),
}
SEED = 20261018


def _variant(src: str, subs: list) -> str:
    """Text of csrc/`src` with each substitution made; raises where one
    no longer matches the source."""
    text = (build.CSRC / src).read_text()
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise RuntimeError(f"{pattern!r} is not in {src}")
    return text


def _build(kernels) -> dict:
    """{kernel: {build: (library, resources)}} for the kernels of BUILDS
    named, compiled together under build/."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        src, _, _, builds = BUILDS[kernel]
        for k, subs in builds.items():
            name = f"bounds_{kernel}_{k}"
            copy = build.BUILD_DIR / f"{name}.cu"
            copy.write_text(_variant(src, subs))
            procs[kernel, k] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                 str(build.CSRC), str(copy), "-o",
                 str(build.BUILD_DIR / f"lib{name}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {kernel: {} for kernel in kernels}
    for (kernel, k), proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel} {k}:\n{log}")
        path = build.BUILD_DIR / f"libbounds_{kernel}_{k}.so"
        fn_name, entry = BUILDS[kernel][1], BUILDS[kernel][2]
        res = build.kernel_resources(log).get(fn_name, {})
        res["sass"] = build.sass_counts(str(path)).get(fn_name)
        dll = ctypes.CDLL(str(path))
        getattr(dll, entry).argtypes = build.SIGNATURES[entry]
        libs[kernel][k] = (dll, res)
    return libs


def _in_turns(run, values, reps: int, launches: int) -> dict:
    ms = {k: [] for k in values}
    order = list(values)
    for _ in range(reps):
        for k in order + order[::-1]:
            ms[k].append(_event_ms(lambda: run(k), launches))
    return ms


def _full_add(libs, F, gen, reps) -> dict:
    M = 1 << 20
    X1, Y1, Z1, X2, Y2, Z2 = (_limbs(F.L, 1, M, gen) for _ in range(6))
    lane = torch.arange(M, device="cuda")
    Z1[:, lane % 11 == 3] = 0
    Z2[:, lane % 13 == 5] = 0
    for k, sign in ((17, 1), (19, -1)):          # P + P, P + (-P)
        sel = lane % k == 4
        X2[:, sel], Z2[:, sel] = X1[:, sel], Z1[:, sel]
        Y2[:, sel] = Y1[:, sel] if sign > 0 else F.neg(Y1[:, sel])
    ins = (X1, Y1, Z1, X2, Y2, Z2)
    want = jacobian_add_plain(F, *ins)
    outs = {k: [torch.empty_like(X1) for _ in range(3)]
            + [torch.empty(M, dtype=torch.int32, device="cuda")]
            for k in libs}

    def run(k):
        build.check(libs[k][0].crypto_jac_add(
            *[t.data_ptr() for t in (*ins, *outs[k])], M, F.L,
            ctypes.addressof(F.mod.p_c), F.mod.n0inv,
            torch.cuda.current_stream().cuda_stream), f"full add at {k}")

    for k in libs:
        run(k)
        if not all(map(torch.equal, outs[k], want)):
            raise AssertionError(f"full add build {k} differs from the "
                                 f"plain version")
    ms = _in_turns(run, libs, reps, 20)
    return {"shape": [F.L, M], "blocks": {
        k: dict(ms=ms[k], median_ms=statistics.median(ms[k]), **libs[k][1])
        for k in libs}}


def _double(libs, F, gen, reps) -> dict:
    M = 1 << 20
    X1, Y1, Z1 = (_limbs(F.L, 1, M, gen) for _ in range(3))
    lane = torch.arange(M, device="cuda")
    Z1[:, lane % 11 == 3] = 0
    Y1[:, lane % 29 == 7] = 0
    ins = (X1, Y1, Z1)
    want = jacobian_double_plain(F, *ins)
    outs = {k: [torch.empty_like(X1) for _ in range(3)] for k in libs}

    def run(k):
        build.check(libs[k][0].crypto_jac_double(
            *[t.data_ptr() for t in (*ins, *outs[k])], M, F.L,
            ctypes.addressof(F.mod.p_c), F.mod.n0inv,
            torch.cuda.current_stream().cuda_stream), f"double at {k}")

    for k in libs:
        run(k)
        if not all(map(torch.equal, outs[k], want)):
            raise AssertionError(f"double build {k} differs from the plain "
                                 f"version")
    ms = _in_turns(run, libs, reps, 20)
    return {"shape": [F.L, M], "blocks": {
        k: dict(ms=ms[k], median_ms=statistics.median(ms[k]), **libs[k][1])
        for k in libs}}


def _normalize(libs, F, gen, reps) -> dict:
    """Every build (a chain window at a shape) in turns; and at one point
    (one block, one chain: launch and chain latency) the shipped shape's
    builds."""
    outs = {}

    def run(b, ins):
        M = ins[0].shape[1]
        out = outs.setdefault((b, M), [torch.empty_like(ins[0])
                                       for _ in range(3)])
        build.check(libs[b][0].crypto_normalize(
            *[t.data_ptr() for t in (*ins, *out)], M, F.L,
            ctypes.addressof(F.mod.p_c), F.mod.n0inv,
            ctypes.addressof(F.mod.pm2_c), ctypes.addressof(F.mod.one_c),
            torch.cuda.current_stream().cuda_stream), f"normalize {b}")
        return out

    shipped = [b for b in libs if b.endswith("_B_k16")]
    for M in (1, 1000, 1 << 20):
        x, y, z = (_limbs(F.L, 1, M, gen) for _ in range(3))
        lane = torch.arange(M, device="cuda")
        z[:, lane % 11 == 3] = 0
        ins = (x, y, z)
        want = jacobian_normalize_plain(F, *ins)
        for b in libs:
            if not all(map(torch.equal, run(b, ins), want)):
                raise AssertionError(f"normalize {b} differs from the "
                                     f"plain version at M={M}")
        if M == 1:
            one = _in_turns(lambda b: run(b, ins), shipped, reps, 5)
    ms = _in_turns(lambda b: run(b, ins), libs, reps, 5)
    return {"shape": [F.L, M], "builds": {
        b: dict(libs[b][1], ms=ms[b], median_ms=statistics.median(ms[b]),
                **({"one_point_ms": statistics.median(one[b])}
                   if b in one else {}))
        for b in libs}}


def _down(libs, F, gen, reps) -> dict:
    out = {"blocks": {k: dict(libs[k][1]) for k in libs}, "widths": []}
    for M in sorted(set(LEVEL_PAIRS), reverse=True):
        x1, y1, x2, y2, prefix = (_limbs(F.L, 1, M, gen) for _ in range(5))
        tinv = _limbs(F.L, 1, M // CHUNK_K, gen)
        lane = torch.arange(M, device="cuda")
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        same = lane % 1031 == 0                    # doubling lanes, sparse
        x2[:, same] = x1[:, same]
        dbl = (same & (m1 == 0) & (m2 == 0)).to(torch.int32)
        ins = (x1, y1, m1, x2, y2, m2, prefix, tinv, dbl)
        outs = {k: (torch.empty_like(x1), torch.empty_like(y1))
                for k in libs}

        def run(k):
            build.check(libs[k][0].crypto_chunked_down(
                *[t.data_ptr() for t in ins + outs[k]], M, F.L,
                ctypes.addressof(F.mod.p_c), F.mod.n0inv,
                torch.cuda.current_stream().cuda_stream), f"down at {k}")

        for k in libs:
            run(k)
        want = next(iter(outs.values()))
        if M == min(LEVEL_PAIRS):
            want = chunked_level_down_plain(F, *ins)
        for k in libs:
            if not all(map(torch.equal, outs[k], want)):
                raise AssertionError(f"down pass build {k} differs at "
                                     f"M={M}")
        ms = _in_turns(run, libs, reps, 5)
        out["widths"].append(dict(pairs=M, **{f"{k}_ms": v
                                              for k, v in ms.items()}))
        del ins, outs, x1, y1, x2, y2, prefix, tinv
    for k in libs:
        med = {w["pairs"]: statistics.median(w[f"{k}_ms"])
               for w in out["widths"]}
        out["blocks"][k]["per_msm_ms"] = sum(med[M] for M in LEVEL_PAIRS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kernels", nargs="+", default=list(TIMERS),
                    choices=list(TIMERS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_launch_bounds: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card!r} torch {torch.__version__}", flush=True)
    libs = _build(args.kernels)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    F = tfield_for(bls.Fq, "cuda")
    out = {"card": card}
    for k in args.kernels:
        out[k] = TIMERS[k](libs[k], F, gen, args.reps)
        print(k, json.dumps(out[k]), flush=True)
    print(json.dumps(out))
    return 0


TIMERS = {"full_add": _full_add, "double": _double,
          "normalize": _normalize, "down": _down}


if __name__ == "__main__":
    raise SystemExit(main())
