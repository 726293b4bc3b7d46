"""The port's sharded MSM and NTT (`crypto_tpu_torch/parallel/`) against
the reference's `msm_sharded_v2` and `sharded_ntt` on its 8-device
virtual CPU mesh (`tests/conftest.py`), at the reference tests' sizes:
the MSM of `tests/test_sharded_msm_v2.py` (n = 64 G1 points, 64-bit
scalars, c = 8) and the NTT of `tests/test_sharded.py` (128 Fr values).

The port runs on the CPU in processes of its own, started before the
reference runs and read after it (`crypto_tpu_torch.testing.sharded_run`):
a 2-process gloo group over a `FileStore` under `tmp_path` (no network),
each rank with half the points and half the NTT's inputs; and one
process that computes 8 MSM shards and 8 NTT ranks in turn through
`msm_shards_in_turn` and `rank_step`, the way `chip_smoke.py` runs them
on one card.  The reference runs once a module.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.ops.ntt import domain_for as ref_domain_for
from crypto_tpu.parallel.sharded_msm_v2 import msm_sharded_v2
from crypto_tpu.parallel.sharded_ntt import sharded_ntt
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.parallel import sharded_msm_v2 as sm
from crypto_tpu_torch.parallel import sharded_ntt as sn
from crypto_tpu_torch.testing import cap_threads, sharded_inputs

cap_threads()

ROOT = Path(__file__).resolve().parents[1]
CASE = {"n": 64, "c": 8, "nbits": 64, "msm_seed": 31, "n_ntt": 128,
        "ntt_seed": 1717}
NDEV = 8


def _start(spec: dict):
    return subprocess.Popen(
        [sys.executable, "-m", "crypto_tpu_torch.testing",
         json.dumps(dict(CASE, **spec))], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _read(proc, timeout: float = 240) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's processes and the reference's results, side by side."""
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = {"gloo": [_start({"world": 2, "rank": r, "store": store})
                      for r in range(2)],
             "turns": [_start({"turns": NDEV})]}
    try:
        pts, scs, vals = sharded_inputs(CASE["n"], CASE["msm_seed"],
                                        CASE["n_ntt"], CASE["ntt_seed"])
        rpts = [jb.G1.point_from_affine(jb.Fq(int(p.X)), jb.Fq(int(p.Y)))
                for p in pts]
        mesh = Mesh(np.array(jax.devices()[:NDEV]), ("data",))
        ref = msm_sharded_v2(jb.G1, rpts, scs, mesh, c=CASE["c"],
                             nbits=CASE["nbits"]).normalize()
        ref_ntt = sharded_ntt(jb.Fr, vals, mesh)
    finally:
        outs = {k: [_read(p) for p in ps] for k, ps in procs.items()}
    host = tb.G1.infinity()
    for p, s in zip(pts, scs):
        host = host + p * s
    host = host.normalize()
    return dict(outs=outs, ref=[int(ref.X), int(ref.Y)],
                host=[int(host.X), int(host.Y)], ref_ntt=ref_ntt, vals=vals)


def test_reference_runs_on_the_virtual_mesh():
    assert len(jax.devices()) >= NDEV


def test_reference_msm_is_the_host_sum(runs):
    assert runs["ref"] == runs["host"]


@pytest.mark.parametrize("rank", [0, 1])
def test_gloo_msm_equals_reference(runs, rank):
    """A 2-process gloo group: every rank returns the reference's MSM."""
    assert runs["outs"]["gloo"][rank]["msm"] == runs["ref"]


@pytest.mark.parametrize("rank", [0, 1])
def test_gloo_ntt_equals_reference(runs, rank):
    """Every rank returns the whole NTT in natural order, as the
    reference's `sharded_ntt` does."""
    assert runs["outs"]["gloo"][rank]["ntt"] == runs["ref_ntt"]


def test_shards_in_turn_msm_equals_reference(runs):
    """8 shards computed in turn in one process and combined in 3 levels
    give the reference's MSM."""
    out = runs["outs"]["turns"][0]
    assert out["msm"] == runs["ref"]
    assert out["pad"] >= 2          # a shard's carry window holds several


def test_ranks_in_turn_ntt_equals_reference(runs):
    ref = ref_domain_for(jb.Fr, CASE["n_ntt"]).ntt_ints(runs["vals"])
    assert runs["outs"]["turns"][0]["ntt"] == runs["ref_ntt"] == ref


def test_max_occupancy_counts_live_digits():
    """Zero digits and infinite points fall in no bucket."""
    d = torch.tensor([[1, -1, 2, 0, 1], [0, 0, -3, 3, 3]], dtype=torch.int32)
    inf = torch.tensor([False, False, False, False, True])
    assert sm.max_occupancy(d, inf, 4) == 2
    assert sm.max_occupancy(d, torch.ones(5, dtype=torch.bool), 4) == 0


def test_combine_three_shards_carries_the_odd_one():
    """ndev = 3: shard 2 is carried past the first level; P + P, P + (-P)
    and infinity on both sides, against the host sums."""
    tc = sm.tcurve_for(tb.G1, "cpu")
    G = tb.G1.generator()
    P = [G * k for k in (3, 5, 7)]
    cols = [[P[0], P[1], P[0], tb.G1.infinity(), P[2]],
            [P[0], -P[1], P[1], tb.G1.infinity(), tb.G1.infinity()],
            [P[2], P[2], tb.G1.infinity(), P[0], P[1]]]
    packed = [tc.pack_points([p.normalize() for p in c]) for c in cols]
    gx = torch.stack([t.X for t in packed], 1)
    gy = torch.stack([t.Y for t in packed], 1)
    gi = torch.stack([tc.is_infinity(t) for t in packed])
    x, y, inf = sm.combine_bucket_shards(tc.F, gx, gy, gi, 3)
    from crypto_tpu_torch.curves.tcurve import TPoints
    z = torch.where(inf[None], tc.F.zeros(inf.shape), tc.F.ones(inf.shape))
    got = tc.unpack(TPoints(x, y, z))
    want = [cols[0][j] + cols[1][j] + cols[2][j] for j in range(5)]
    assert got == want


def test_rank_step_ranks_cover_the_natural_order():
    """At 4 ranks over 64 values the ranks' strided outputs interleave to
    the single-domain NTT."""
    vals = [pow(3, i, tb.R) for i in range(64)]
    plan = sn.plan_for(tb.Fr, 64, 4, "cpu")
    blocks = plan.T.pack([vals[16 * r:16 * (r + 1)] for r in range(4)])
    outs = torch.stack([sn.rank_step(plan, blocks, r) for r in range(4)])
    got = [int(v) for v in plan.T.unpack(sn.natural_order(outs))]
    assert got == ref_domain_for(jb.Fr, 64).ntt_ints(vals)


def test_pair_add_total_formula_in_the_combine(monkeypatch):
    """The combine adds on the total formula (the reference's
    `affine_pair_add`), never the doubling-free one."""
    seen = []
    real = sm.msm_v2.pair_add_t

    def spy(*args, fast=False, **kw):
        seen.append(fast)
        return real(*args, fast=fast, **kw)

    monkeypatch.setattr(sm.msm_v2, "pair_add_t", spy)
    tc = sm.tcurve_for(tb.G1, "cpu")
    G = tb.G1.generator().normalize()
    pk = tc.pack_points([G, G])
    sm.combine_bucket_shards(tc.F, torch.stack([pk.X, pk.X], 1),
                             torch.stack([pk.Y, pk.Y], 1),
                             torch.zeros((2, 2), dtype=torch.bool), 2)
    assert seen == [False]
