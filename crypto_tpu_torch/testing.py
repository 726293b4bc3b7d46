"""Helpers for the port's CPU tests."""

from __future__ import annotations

import os

import torch


def cap_threads() -> int:
    """Give PyTorch's intra-op pool this process's share of the cores: all
    of them over the number of pytest-xdist workers
    (`PYTEST_XDIST_WORKER_COUNT`, 1 outside xdist), at least one.  Under
    six workers on eight cores each worker's pool would otherwise start
    eight threads, and the CPU-heavy tests would contend for the cores
    about sixfold.  Returns the thread count set."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // max(1, workers))
    torch.set_num_threads(n)
    return n


def r1cs_bytes(prime: int, n_pub_out: int, n_pub_in: int, n_prv_in: int,
               n_wires: int, constraints) -> bytes:
    """An iden3 `.r1cs` file (version 1: the header, constraints and
    wire-to-label sections) over the scalar field of `prime`, as circom
    writes one: wire 0 is ONE, then the public outputs, the public inputs,
    the private inputs and the other wires.  `constraints`: [(A, B, C)],
    each a list of (coefficient int, wire) terms.  Test support: what
    `legogroth16/circom.py` `parse_r1cs` reads."""
    import struct
    fs = 32 * -(-prime.bit_length() // 256)

    def section(kind: int, body: bytes) -> bytes:
        return struct.pack("<IQ", kind, len(body)) + body

    header = struct.pack("<I", fs) + prime.to_bytes(fs, "little") + \
        struct.pack("<IIIIQI", n_wires, n_pub_out, n_pub_in, n_prv_in,
                    n_wires, len(constraints))
    body = bytearray()
    for lcs in constraints:
        for lc in lcs:
            body += struct.pack("<I", len(lc))
            for coeff, wire in lc:
                body += struct.pack("<I", wire)
                body += (coeff % prime).to_bytes(fs, "little")
    labels = b"".join(struct.pack("<Q", w) for w in range(n_wires))
    return b"r1cs" + struct.pack("<II", 1, 3) + section(1, header) + \
        section(2, bytes(body)) + section(3, labels)


def r1cs_of(cs, n_pub_out: int, n_prv_in: int) -> bytes:
    """The `.r1cs` bytes of a synthesized `r1cs.cs.ConstraintSystem` whose
    variables follow circom's order: its public inputs are the circuit's
    `n_pub_out` outputs (no public input), its first `n_prv_in`
    witnesses the private inputs."""
    n_pub = cs.num_instance - 1
    if n_pub != n_pub_out:
        raise ValueError(f"{n_pub} public variables, {n_pub_out} outputs")
    return r1cs_bytes(cs.F.p, n_pub_out, 0, n_prv_in,
                      cs.num_instance + cs.num_witness,
                      [([(c, i) for c, i in a], [(c, i) for c, i in b],
                        [(c, i) for c, i in c_])
                       for a, b, c_ in zip(cs.a_rows, cs.b_rows,
                                           cs.c_rows)])


# ---------------------------------------------------------------------------
# the sharded MSM and NTT on the CPU, in processes of their own
# ---------------------------------------------------------------------------

def sharded_inputs(n: int, msm_seed: int, n_ntt: int, ntt_seed: int):
    """The sharded tests' inputs: n BLS12-381 G1 points and 64-bit scalars
    from random.Random(msm_seed) (points first), and n_ntt Fr values from
    random.Random(ntt_seed)."""
    import random
    from .curves import bls12_381 as b
    rng = random.Random(msm_seed)
    pts = [b.G1.rand(rng).normalize() for _ in range(n)]
    scs = [rng.randrange(0, 1 << 64) for _ in range(n)]
    rng = random.Random(ntt_seed)
    return pts, scs, [rng.randrange(b.R) for _ in range(n_ntt)]


def sharded_run(spec: dict) -> dict:
    """One process of the sharded tests, as `spec` says: {"world": D,
    "rank": r, "store": a FileStore path} joins a gloo group and runs
    `msm_sharded_v2` and `sharded_ntt` on rank r's shards; {"turns": k}
    runs k MSM shards and k NTT ranks in turn in this process through
    `msm_shards_in_turn` and `rank_step`.  Sizes and seeds under "n", "c", "nbits", "msm_seed", "n_ntt", "ntt_seed".
    Returns {"msm": [x, y] affine ints, "ntt": [ints], "pad": the grid's
    ranks a bucket (turns only)}."""
    import torch.distributed as dist
    from .curves import bls12_381 as b
    from .parallel import sharded_msm_v2 as sm, sharded_ntt as sn
    cap_threads()
    pts, scs, vals = sharded_inputs(spec["n"], spec["msm_seed"],
                                    spec["n_ntt"], spec["ntt_seed"])
    c, nbits = spec["c"], spec["nbits"]
    out = {}
    if "turns" in spec:
        k = spec["turns"]
        m, m_ntt = len(pts) // k, len(vals) // k
        t = {}
        res = sm.msm_shards_in_turn(
            b.G1, [(pts[i * m:(i + 1) * m], scs[i * m:(i + 1) * m])
                   for i in range(k)], c, nbits, "cpu", timings=t)
        plan = sn.plan_for(b.Fr, len(vals), k, "cpu")
        blocks = plan.T.pack([vals[i * m_ntt:(i + 1) * m_ntt]
                              for i in range(k)])
        ntt = sn.natural_order(torch.stack(
            [sn.rank_step(plan, blocks, r) for r in range(k)]))
        out["ntt"] = [int(v) for v in plan.T.unpack(ntt)]
        out["pad"] = t["pad"]
    else:
        world, rank = spec["world"], spec["rank"]
        dist.init_process_group("gloo", store=dist.FileStore(
            spec["store"], world), rank=rank, world_size=world)
        try:
            m, m_ntt = len(pts) // world, len(vals) // world
            res = sm.msm_sharded_v2(b.G1, pts[rank * m:(rank + 1) * m],
                                    scs[rank * m:(rank + 1) * m], c=c,
                                    nbits=nbits, device="cpu")
            out["ntt"] = sn.sharded_ntt(
                b.Fr, vals[rank * m_ntt:(rank + 1) * m_ntt], device="cpu")
        finally:
            dist.destroy_process_group()
    res = res.normalize()
    out["msm"] = None if res.is_infinity() else [int(res.X), int(res.Y)]
    return out


if __name__ == "__main__":
    import json
    import sys
    print(json.dumps(sharded_run(json.loads(sys.argv[1]))))
