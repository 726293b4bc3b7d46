"""Time designs of the Montgomery square and of the Fq2 square in turns.

    python3 -m crypto_tpu_torch.time_sqr_designs [--reps 3]

On one CUDA card: builds, with nvcc for sm_90a, `csrc/sqr_designs.cu`
and two builds of `csrc/chunked_level.cu`, as the port has it and with
its square on `sqr_designs.cu`'s folded wide square (three libraries of
their own, not the port's), and reads each kernel's registers, spills and
SASS instruction count.  Then, for the Montgomery square at (12, 2^20),
the Fq2 square at (24, 2^18) (the G2 tail's widest call) and the G1 fast
down pass at each level width of the 2^20 G1 MSM, it holds every design
bit for bit against the others and the port's plain version on the same
canonical inputs (for the squares with the edges p - 1, 0 and 1 and, for
Fq2, (p-1)(1+u), (p-1) + 0u, 0 + (p-1)u, a0 = a1 and a1 = 0; the down
pass with infinite operands), and times the designs in turns: each
repetition runs them in order, then in reverse, each reading the
CUDA-event mean of 20 launches (5 for the down pass) after a warm-up.
Prints the card's name and power limit and, as the last line, a JSON
object with each design's readings, their median, registers, spills and
SASS count.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from .curves import bls12_381 as bls
from .fields.tfield import tfield_for
from .fields.ttower import tquad_for
from .ops.kernels import build
from .ops.kernels.curve_kernels import CHUNK_K, chunked_level_down_fast_plain
from .ops.kernels.field_kernels import fq2_sqr_plain, mont_mul_plain

SOURCE = build.CSRC / "sqr_designs.cu"
# design index of sqr_design() -> name, in the order of the source
MONT_SQR = ("mont_sqr", "mont_sqr_folded", "mont_mul_eo", "mont_mul")
FQ2_SQR = ("lazy", "karatsuba", "karatsuba_folded", "cios")
# the down pass's builds: chunked_level.cu as it is, and with its
# ctt::mont_sqr taken by sqr_designs.cu's mont_sqr_folded
DOWN = {"shipped": '#include "chunked_level.cu"\n',
        "folded": '#define SQR_DESIGNS_FOLDED_ONLY\n#include "sqr_designs.cu"\n'
                  '#define mont_sqr mont_sqr_folded\n'
                  '#include "chunked_level.cu"\n'}
# the level calls of the 2^20 G1 MSM at c = 16, in pairs (524,288 twice)
LEVEL_PAIRS = (9142272, 4521984, 2228224, 1114112, 557056, 1507328, 917504,
               524288, 524288)
SEED = 20261017


def _build() -> tuple:
    """{name: (library, {kernel: resources})} of the designs' library and
    the down pass's two builds, compiled together under build/."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {"sqr_designs": SOURCE}
    for name, text in DOWN.items():
        srcs[f"down_{name}"] = build.BUILD_DIR / f"down_{name}.cu"
        srcs[f"down_{name}"].write_text(text)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC),
         str(src), "-o", str(build.BUILD_DIR / f"lib{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        path = build.BUILD_DIR / f"lib{name}.so"
        res = build.kernel_resources(log)
        for kernel, n in build.sass_counts(str(path)).items():
            res.setdefault(kernel, {})["sass"] = n
        libs[name] = (ctypes.CDLL(str(path)), res)
    fn = libs["sqr_designs"][0].sqr_design
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_uint32, ctypes.c_void_p]
    for name in DOWN:
        libs[f"down_{name}"][0].crypto_chunked_down_fast.argtypes = \
            build.SIGNATURES["crypto_chunked_down_fast"]
    return libs


def _limbs(L: int, parts: int, M: int, gen: torch.Generator) -> torch.Tensor:
    """(parts*L, M) int32 limbs of M elements of `parts` values below p
    each: every value's top limb below p's."""
    x = torch.randint(-2**31, 2**31, (parts * L, M), generator=gen,
                      dtype=torch.int32, device="cuda")
    for k in range(parts):
        x[k * L + L - 1] = torch.randint(
            0, bls.P >> (32 * (L - 1)), (M,), generator=gen,
            dtype=torch.int32, device="cuda")
    return x


def _event_ms(fn, launches: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def _compare(dll, res, fq2: int, names, a, plain, mod, reps) -> dict:
    outs = [torch.empty_like(a) for _ in names]
    M = a.shape[1]

    def run(d):
        build.check(dll.sqr_design(
            fq2, d, a.data_ptr(), outs[d].data_ptr(), M,
            ctypes.addressof(mod.p_c), mod.n0inv,
            torch.cuda.current_stream().cuda_stream), names[d])

    for d, name in enumerate(names):
        run(d)
        if not torch.equal(outs[d], plain):
            raise AssertionError(f"{name} differs from the plain version "
                                 f"at M={M}")
    ms = {name: [] for name in names}
    order = list(range(len(names)))
    for _ in range(reps):
        for d in order + order[::-1]:
            ms[names[d]].append(_event_ms(lambda: run(d), 20))
    kernel = "fq2_sqr_design_kernel" if fq2 else "mont_sqr_design_kernel"
    return {"shape": list(a.shape), "designs": {
        name: dict(ms=ms[name], median_ms=statistics.median(ms[name]),
                   **res.get(f"{kernel}<{d}>", {}))
        for d, name in enumerate(names)}}


def _compare_down(libs, F, reps) -> dict:
    """The down pass's two builds in turns at each level width, on random
    canonical coordinates, prefixes and inverses with infinite operands."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {"resources": {name: libs[f"down_{name}"][1].get(
        "down_fast_kernel<12>", {}) for name in DOWN}, "widths": []}
    for M in sorted(set(LEVEL_PAIRS), reverse=True):
        x1, y1, x2, y2, prefix = (_limbs(F.L, 1, M, gen) for _ in range(5))
        tinv = _limbs(F.L, 1, M // CHUNK_K, gen)
        lane = torch.arange(M, device="cuda")
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        ins = (x1, y1, m1, x2, y2, m2, prefix, tinv)
        outs = {name: (torch.empty_like(x1), torch.empty_like(y1))
                for name in DOWN}

        def run(name):
            build.check(libs[f"down_{name}"][0].crypto_chunked_down_fast(
                *[t.data_ptr() for t in ins + outs[name]], M, F.L,
                ctypes.addressof(F.mod.p_c), F.mod.n0inv,
                torch.cuda.current_stream().cuda_stream), name)

        for name in DOWN:
            run(name)
        want = outs["shipped"]
        if M == min(LEVEL_PAIRS):
            want = chunked_level_down_fast_plain(F, *ins)
        for name in DOWN:
            if not all(map(torch.equal, outs[name], want)):
                raise AssertionError(f"down pass ({name}) differs at M={M}")
        ms = {name: [] for name in DOWN}
        order = list(DOWN)
        for _ in range(reps):
            for name in order + order[::-1]:
                ms[name].append(_event_ms(lambda: run(name), 5))
        out["widths"].append(dict(pairs=M, **{f"{k}_ms": v
                                              for k, v in ms.items()}))
        del ins, outs, x1, y1, x2, y2, prefix, tinv
    for name in DOWN:
        med = {w["pairs"]: statistics.median(w[f"{name}_ms"])
               for w in out["widths"]}
        out[f"{name}_per_msm_ms"] = sum(med[M] for M in LEVEL_PAIRS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sqr_designs: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card!r} torch {torch.__version__}", flush=True)
    libs = _build()
    dll, res = libs["sqr_designs"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    P = bls.P

    F = tfield_for(bls.Fq, "cuda")
    a = _limbs(F.L, 1, 1 << 20, gen)
    a[:, :3] = F.pack([P - 1, 0, 1], mont=False)
    mont = _compare(dll, res, 0, MONT_SQR, a,
                    mont_mul_plain(a, a, F.mod), F.mod, args.reps)
    print("mont_sqr", json.dumps(mont), flush=True)

    F2 = tquad_for(bls.Fq2, "cuda")
    a = _limbs(F2.base.L, 2, 1 << 18, gen)
    a[:, :3] = F2.pack([bls.Fq2(P - 1, P - 1), bls.Fq2(P - 1, 0),
                        bls.Fq2(0, P - 1)], mont=False)
    a[F2.base.L:, 3] = a[:F2.base.L, 3]                  # a0 = a1
    a[F2.base.L:, 4] = 0                                 # a1 = 0
    fq2 = _compare(dll, res, 1, FQ2_SQR, a, fq2_sqr_plain(F2.base, a),
                   F2.base.mod, args.reps)
    print("fq2_sqr", json.dumps(fq2), flush=True)
    del a

    down = _compare_down(libs, F, args.reps)
    print("down_fast", json.dumps(down), flush=True)
    print(json.dumps({"card": card, "mont_sqr": mont, "fq2_sqr": fq2,
                      "down_fast": down}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
