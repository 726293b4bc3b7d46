"""Time the 2^20 MSM's levels at several chunked-level thresholds.

    python3 -m crypto_tpu_torch.sweep_chunk_threshold [--reps 3]

On one CUDA card: builds the BLS12-381 G1 points of `chip_smoke.py`
(2^20 distinct points with known discrete logs), then for every threshold
T in THRESHOLDS sets `msm_v2.CHUNK_MIN_PAIRS = T` (level calls of at least
T pairs take the chunked level kernels, the others pre -> batch inversion
-> post) and runs `msm_device_scheduled` at c = 16 on full-range scalars.
Each repetition uses fresh scalars and runs every threshold once, the
thresholds' order rotated from one repetition to the next; every result is
checked against the known discrete logs.  Prints the card's name and power
limit, one line per run, and a last JSON line with each threshold's median
seconds of the levels phase and of the whole MSM, and its level calls'
pair counts split by path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from .bench_points import make_bench_points, make_bench_scalars
from .curves import bls12_381 as bls
from .curves.tcurve import tcurve_for
from .ops import msm_v2

THRESHOLDS = (1 << 12, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 24)
SEED = 20251017


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--log-n", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_chunk_threshold: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card!r} torch {torch.__version__}", flush=True)
    n = 1 << args.log_n
    tc = tcurve_for(bls.G1, "cuda")
    points, dlog = make_bench_points(tc, n)
    logs = [dlog(i) for i in range(n)]
    _, warm = make_bench_scalars(bls.R, n, SEED - 1)
    msm_v2.msm_device_scheduled(bls.G1, points, warm, c=16)

    default = msm_v2.CHUNK_MIN_PAIRS
    runs = {t: [] for t in THRESHOLDS}
    try:
        for rep in range(args.reps):
            sc, sb = make_bench_scalars(bls.R, n, SEED + rep)
            expect = bls.G1.generator().mul_raw(
                sum(s * d for s, d in zip(sc, logs)) % bls.R)
            k = rep % len(THRESHOLDS)
            for t in THRESHOLDS[k:] + THRESHOLDS[:k]:
                msm_v2.CHUNK_MIN_PAIRS = t
                timings = {}
                torch.cuda.synchronize()
                res = msm_v2.msm_device_scheduled(bls.G1, points, sb, c=16,
                                                  timings=timings)
                if res != expect:
                    raise AssertionError(f"MSM wrong at threshold {t}")
                total = sum(v for v in timings.values()
                            if isinstance(v, float))
                runs[t].append((timings["levels"], total,
                                timings["level_pairs"]))
                print(f"rep={rep} threshold={t} levels_s={timings['levels']}"
                      f" msm_s={total}", flush=True)
    finally:
        msm_v2.CHUNK_MIN_PAIRS = default

    summary = []
    for t, rs in runs.items():
        widths = rs[0][2]
        summary.append(dict(
            threshold=t,
            levels_s_median=statistics.median(r[0] for r in rs),
            levels_s=[r[0] for r in rs],
            msm_s_median=statistics.median(r[1] for r in rs),
            chunked_pairs=[w for w in widths if w >= t],
            pre_post_pairs=[w for w in widths if w < t]))
    print(json.dumps({"card": card, "n": n, "c": 16, "reps": args.reps,
                      "sweep": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
