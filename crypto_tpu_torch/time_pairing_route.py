"""Time the host loop against the batched device multi-pairing, to place
`curves/tpairing.py` `PAIRING_BATCH_THRESHOLD`.

    python3 -m crypto_tpu_torch.time_pairing_route [--reps 2]

On one CUDA card: for every shape in SHAPES (k groups of m BLS12-381 pairs
each, from known logs) runs the host loop (`bls12_381.multi_pairing` of
each group) and one `TPairing.multi_pairings` call over all k groups, in
turns, `--reps` times after one warm-up call; every result is held to the
host's.  Prints the card's name and power limit, one line per shape, and
a last JSON line with each shape's median seconds on both routes; the
host loop's least-squares cost a pair and a group (host_s = a pairs + b
groups), so a group's weight in pairs, b / a (`HOST_GROUP_PAIRS`); the
device call's mean; the weight, pairs + (b / a) groups, at which the two
routes cost the same (`PAIRING_BATCH_THRESHOLD`); and for groups of two
pairs, the least pair count from which the device call was the faster.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time

import torch

from .curves import bls12_381 as bls
from .curves.tpairing import tpairing_for

# (groups k, pairs a group m): SAVER's decryption and SnarkPack's GIPA
# rounds give groups of 1-2 pairs, its commitments groups of n to 2n
SHAPES = ((8, 2), (16, 2), (24, 2), (28, 2), (32, 2), (36, 2), (40, 2),
          (48, 2), (64, 2), (1, 16), (1, 64), (1, 128), (2, 16), (6, 16))
SEED = 20251018


def _groups(k: int, m: int, rng) -> list:
    g1, g2 = bls.G1.generator(), bls.G2.generator()
    return [[(g1.mul_raw(rng.randrange(1, bls.R)).normalize(),
              g2.mul_raw(rng.randrange(1, bls.R)).normalize())
             for _ in range(m)] for _ in range(k)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_pairing_route: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card!r} torch {torch.__version__}", flush=True)
    tp = tpairing_for("bls12_381", "cuda")
    rng = random.Random(SEED)
    tp.multi_pairings(_groups(2, 2, rng))                 # warm-up
    torch.cuda.synchronize()
    out = {}
    for k, m in SHAPES:
        host_s, dev_s = [], []
        for rep in range(args.reps):
            groups = _groups(k, m, rng)
            t0 = time.perf_counter()
            want = [bls.multi_pairing(g) for g in groups]
            t1 = time.perf_counter()
            got = tp.multi_pairings(groups)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if got != want:
                raise AssertionError(f"multi_pairings differs from the host "
                                     f"at k={k}, m={m}")
            host_s.append(t1 - t0)
            dev_s.append(t2 - t1)
        out[f"{k}x{m}"] = [k * m, statistics.median(host_s),
                           statistics.median(dev_s)]
        print(f"[shape] groups={k} pairs_a_group={m} pairs={k * m} "
              f"host_s={host_s} device_s={dev_s}", flush=True)
    # host_s = a pairs + b groups, least squares over every shape
    spp = sum(k * m * k * m for k, m in SHAPES)
    spg = sum(k * m * k for k, m in SHAPES)
    sgg = sum(k * k for k, m in SHAPES)
    sph = sum(k * m * out[f"{k}x{m}"][1] for k, m in SHAPES)
    sgh = sum(k * out[f"{k}x{m}"][1] for k, m in SHAPES)
    det = spp * sgg - spg * spg
    a, b = (sph * sgg - sgh * spg) / det, (spp * sgh - spg * sph) / det
    dev_mean = statistics.mean(v[2] for v in out.values())
    wins = [v[0] for key, v in out.items()
            if key.endswith("x2") and v[2] < v[1]]
    print(json.dumps({
        "card": card, "pairs_host_s_device_s": out,
        "host_s_a_pair": a, "host_s_a_group": b, "group_weight_pairs": b / a,
        "device_s_mean": dev_mean, "tie_weight": dev_mean / a,
        "device_faster_from_pairs_groups_of_2": min(wins) if wins
        else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
