"""Time the G1 full Jacobian add and the total-formula down pass under
several launch bounds, in turns.

    python3 -m crypto_tpu_torch.time_launch_bounds [--reps 3]

On one CUDA card: writes copies of `csrc/jacobian.cu` under build/ with
its block size `T` and the full add's `FULL_ADD_BLOCKS` (threads a block,
and the blocks an SM that `__launch_bounds__` asks room for: together
they cap the registers a thread) set to each pair below, also with its
squares taken as products (`mont_mul_eo(a, a)`), and copies of
`csrc/chunked_level.cu` with each value of `DOWN_BLOCKS`; builds each
with nvcc for sm_90a as a library of its own (not the port's), and reads
each kernel's registers, spills and SASS instruction count.  Then it
holds every build bit for bit against the others and the port's plain
version on the same canonical inputs, and times the builds in turns: the
full add at (12, 2^20) with infinite operands, P + P and P + (-P) among
random lanes; the down pass at each level width of the 2^20 G1 MSM with
infinite operands in every warp and a doubling lane in one warp of 32.
Each repetition runs the builds in order, then in reverse, each reading
the CUDA-event mean of 20 launches (5 for the down pass) after a
warm-up.  Prints the card's name and power limit and, as the last line,
a JSON object with each build's readings, their median, registers,
spills and SASS count, and for the down pass its sum over the MSM's nine
level calls.
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
from .ops.kernels.point_kernels import jacobian_add_plain
from .time_sqr_designs import LEVEL_PAIRS, _event_ms, _limbs

# the full add with its squares as products, mont_mul_eo(a, a): fewer
# live words than mont_sqr's wide square, 300 wide products against 234
SQR_BY_MUL = (r"ctt::mont_sqr<FQ_LIMBS>\((\w+), (\w+), m\)",
              r"ctt::mont_mul_eo<FQ_LIMBS>(\1, \2, \2, m)")


def _bounds(threads: int, blocks: int) -> list:
    return [(r"constexpr int T = 128;", f"constexpr int T = {threads};"),
            (r"constexpr int FULL_ADD_BLOCKS = 2;",
             f"constexpr int FULL_ADD_BLOCKS = {blocks};")]


# kernel -> (source, kernel function, C entry point, {build: the
# substitutions (regex, replacement) that make the build's copy})
BUILDS = {
    "full_add": ("jacobian.cu", "full_add_kernel", "crypto_jac_add", {
        **{f"{t}x{k}": _bounds(t, k) for t, k in (
            (128, 2), (64, 5), (32, 10), (32, 11), (128, 3), (128, 4))},
        **{f"{t}x{k}_sqr_by_mul": [SQR_BY_MUL, *_bounds(t, k)]
           for t, k in ((32, 11), (128, 3))}}),
    "down": ("chunked_level.cu", "down_kernel", "crypto_chunked_down", {
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


def _build() -> dict:
    """{kernel: {build: (library, resources)}}, compiled together under
    build/."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (src, _, _, builds) in BUILDS.items():
        for k, subs in builds.items():
            name = f"bounds_{kernel}_{k}"
            copy = build.BUILD_DIR / f"{name}.cu"
            copy.write_text(_variant(src, subs))
            procs[kernel, k] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                 str(build.CSRC), str(copy), "-o",
                 str(build.BUILD_DIR / f"lib{name}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {kernel: {} for kernel in BUILDS}
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
            *[t.data_ptr() for t in (*ins, *outs[k])], M,
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
                *[t.data_ptr() for t in ins + outs[k]], M,
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_launch_bounds: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card!r} torch {torch.__version__}", flush=True)
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    F = tfield_for(bls.Fq, "cuda")
    full_add = _full_add(libs["full_add"], F, gen, args.reps)
    print("full_add", json.dumps(full_add), flush=True)
    down = _down(libs["down"], F, gen, args.reps)
    print("down", json.dumps(down), flush=True)
    print(json.dumps({"card": card, "full_add": full_add, "down": down}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
