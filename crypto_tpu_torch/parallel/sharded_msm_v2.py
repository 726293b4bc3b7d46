"""Sharded device-scheduled MSM over `torch.distributed`.

Counterpart of `crypto_tpu/parallel/sharded_msm_v2.py` `msm_sharded_v2`,
data-parallel Pippenger.  Each rank holds N/world of the points and their
scalars and, on its own card:

1. lays its shard out on the grid of `pad` ranks a bucket, `pad` the power
   of two at or above the largest bucket of any rank (one all-reduce of
   the maximum, the reference's `_global_max_occupancy`), and computes
   every window's (B,) vector of bucket sums with the port's machinery
   (`ops/msm_v2.py`: the slot tables and the row gather, the
   batched-affine levels of `pair_add_t`, the windows a colliding pair
   spoiled rerun with the total formula): `shard_bucket_sums`;
2. one `all_gather_into_tensor` brings every rank's vectors to every rank;
3. `combine_bucket_shards` adds them bucket by bucket in log2(world)
   levels of `pair_add_t` on the total formula (the reference's
   `affine_pair_add`);
4. the weighted tail (`tail_fn`) and the host Horner give the MSM on
   every rank.

Differences from the reference, all from the card's side:

* One route.  The reference has two combine strategies and the
  `CRYPTO_TPU_SHARDED_COLLECTIVE` switch between them only because
  XLA:CPU's collective rendezvous aborts when eight virtual devices share
  the host's cores.  Here every rank gathers, then combines and runs the
  tail.
* The windows run side by side, as in `msm_device_scheduled`: one
  all-gather carries every window's vector ((2U + 1) W B words a rank,
  independent of N) and one tail runs every window.
* The rank's step and the combine are functions of their own, so one
  process can compute k shards in turn on one card and combine them with
  the same code (`msm_shards_in_turn`; the reference's test lane does the
  same on its virtual mesh).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .. import resolve_device
from ..curves.sw import Point, SWCurve
from ..curves.tcurve import TPoints, tcurve_for
from ..fields.ttower import TQuadField
from ..ops import msm_v2


def max_occupancy(digits: torch.Tensor, inf: torch.Tensor, B: int) -> int:
    """The largest bucket of any window of a shard: (W, N) digits, (N,)
    infinity mask; zero digits and infinite points fall in no bucket."""
    W = digits.shape[0]
    absd = digits.abs()
    live = (absd > 0) & ~inf[None, :]
    keys = absd.to(torch.int64) - 1 + B * torch.arange(
        W, device=digits.device)[:, None]
    counts = torch.bincount(keys[live], minlength=W * B)
    return int(counts.max()) if counts.numel() else 0


def _shard(curve: SWCurve, points, scalars, c: int, nbits: int | None,
           dev):
    """(tc, points on dev, (W, N) digits, infinity mask) of a shard."""
    tc = tcurve_for(curve, dev)
    if nbits is None:
        nbits = curve.scalar_field.bits
    if not isinstance(points, TPoints):
        points = tc.pack_points([p.normalize() for p in points])
    points = TPoints(*(t.to(dev) for t in points))
    digits = msm_v2.digits_of(scalars, c, nbits, dev)
    if digits.shape[1] != points.X.shape[1]:
        raise ValueError(f"{digits.shape[1]} scalars for "
                         f"{points.X.shape[1]} points")
    return tc, points, digits, tc.is_infinity(points)


def _pad_for(occ: int) -> int:
    return 1 << (max(occ, 1) - 1).bit_length()


def shard_bucket_sums(curve: SWCurve, points, scalars, c: int = 16,
                      nbits: int | None = None, pad: int | None = None,
                      device="cuda", safe: bool = False,
                      timings: dict | None = None) -> tuple:
    """One rank's step: every window's bucket sums of its shard, (x, y
    (U, W, B), inf (W, B)) in natural bucket order, over the grid of `pad`
    ranks a bucket (at least the shard's largest bucket; by default the
    power of two at or above it).  `points`, `scalars` as
    `msm_device_scheduled` takes them.  The levels are doubling-free and
    the windows a colliding pair spoiled are rerun with the total formula
    (`safe=True`: the total formula throughout; G2 always).  `timings`:
    "digits_plan", "levels", "rerun", "rerun_windows", "rerun_trace" and
    the level calls' records, as `msm_device_scheduled` says, and "pad"."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    return _rank_sums(_shard(curve, points, scalars, c, nbits, dev), c, pad,
                      safe, timings, t0)


def _rank_sums(shard: tuple, c: int, pad: int | None, safe: bool,
               timings: dict | None, t0: float) -> tuple:
    """`shard_bucket_sums` of a shard `_shard` prepared at time t0."""
    tc, points, digits, inf = shard
    F, dev = tc.F, digits.device
    W, N = digits.shape
    B = 1 << (c - 1)
    occ = max_occupancy(digits, inf, B)
    pad = _pad_for(occ) if pad is None else pad
    if pad < occ:
        raise ValueError(f"pad={pad} is below the shard's largest bucket "
                         f"({occ} points)")
    if N == 0 or occ == 0:
        z = torch.zeros((F.U, W, B), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.ones((W, B), dtype=torch.bool,
                                        device=dev)
    order, starts_p, counts_p, invperm, _, _ = msm_v2._plan_windows_sorted(
        digits, inf, B)
    if timings is not None:
        msm_v2._sync(dev)
        timings["digits_plan"] = time.perf_counter() - t0
        timings["pad"] = pad
    fast = not safe and not isinstance(F, TQuadField)
    return msm_v2.bucket_sums(F, points, digits,
                              (order, starts_p, counts_p, invperm),
                              {msm_v2._grid_bands(pad, B): list(range(W))},
                              B, fast, timings)


def combine_bucket_shards(F, gx: torch.Tensor, gy: torch.Tensor,
                          gi: torch.Tensor, ndev: int) -> tuple:
    """The bucket vectors of `ndev` shards, stacked on axis 1 of gx, gy
    ((U, ndev, ...)) and axis 0 of gi ((ndev, ...), True at infinity) ->
    their sums (U, ...), (U, ...), (...): shard i + h added to shard i in
    ceil(log2 ndev) levels of `pair_add_t` on the total formula, an odd
    shard carried to the next level."""
    U = F.U
    shape = gi.shape[1:]
    x, y = gx.reshape(U, ndev, -1), gy.reshape(U, ndev, -1)
    m = gi.reshape(ndev, -1).to(torch.int32)
    M = m.shape[1]
    n = ndev
    while n > 1:
        h = n // 2

        def side(lo: int):
            return (x[:, lo:lo + h].reshape(U, -1).contiguous(),
                    y[:, lo:lo + h].reshape(U, -1).contiguous(),
                    m[lo:lo + h].reshape(-1).contiguous())

        x1, y1, m1 = side(0)
        x2, y2, m2 = side(h)
        x3, y3, i3, _ = msm_v2.pair_add_t(F, x1, y1, m1, x2, y2, m2,
                                          fast=False)
        x = torch.cat([x3.reshape(U, h, M), x[:, 2 * h:]], dim=1)
        y = torch.cat([y3.reshape(U, h, M), y[:, 2 * h:]], dim=1)
        m = torch.cat([(i3 != 0).to(torch.int32).reshape(h, M), m[2 * h:]])
        n = h + n % 2
    return (x[:, 0].reshape((U,) + shape), y[:, 0].reshape((U,) + shape),
            (m[0] != 0).reshape(shape))


def _combined_msm(curve: SWCurve, tc, c: int, gx, gy, ginf, ndev: int,
                  timings: dict | None) -> Point:
    """The MSM from `ndev` shards' bucket sums stacked as
    `combine_bucket_shards` takes them: the combine, then the tail and
    the host Horner (`msm_v2.finish`); "combine" in `timings`."""
    F, U = tc.F, tc.F.U
    W, B = ginf.shape[1:]
    t0 = time.perf_counter()
    cx, cy, cinf = combine_bucket_shards(F, gx, gy, ginf, ndev)
    if timings is not None:
        msm_v2._sync(gx.device)
        timings["combine"] = time.perf_counter() - t0
    return msm_v2.finish(curve, tc, c, cx.reshape(U, W, B),
                         cy.reshape(U, W, B), cinf, timings)


def msm_shards_in_turn(curve: SWCurve, shards: list, c: int = 16,
                       nbits: int | None = None, device="cuda",
                       timings: dict | None = None) -> Point:
    """The MSM of k shards, [(points, scalars)], computed in turn in this
    process: the grid sized by the largest bucket of any shard, each
    shard's `shard_bucket_sums`, then `combine_bucket_shards` over the k
    vectors and the tail, as `msm_sharded_v2` runs them across k ranks.
    `timings`: "pad", "shards" (each shard's `shard_bucket_sums` keys),
    "shard_sums" (the k steps' seconds), "combine", "tail",
    "host_combine"."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prepared = [_shard(curve, p, s, c, nbits, dev) for p, s in shards]
    B = 1 << (c - 1)
    pad = _pad_for(max(max_occupancy(d, inf, B)
                       for _, _, d, inf in prepared))
    per = [{} for _ in prepared] if timings is not None else \
        [None] * len(prepared)
    sums = [_rank_sums(sh, c, pad, False, tt, time.perf_counter())
            for sh, tt in zip(prepared, per)]
    if timings is not None:
        msm_v2._sync(dev)
        timings.update(pad=pad, shards=per,
                       shard_sums=time.perf_counter() - t0)
    gx = torch.stack([t[0] for t in sums], 1)
    gy = torch.stack([t[1] for t in sums], 1)
    gi = torch.stack([t[2] for t in sums])
    del sums
    return _combined_msm(curve, prepared[0][0], c, gx, gy, gi, len(shards),
                         timings)


def msm_sharded_v2(curve: SWCurve, points, scalars, group=None,
                   c: int = 16, nbits: int | None = None,
                   pad: int | None = None, device="cuda",
                   timings: dict | None = None) -> Point:
    """sum_i scalars[i] * points[i] over every rank of the process group
    `group` (the default group if None); every rank returns the MSM.

    `points`, `scalars`: this rank's shard, in the forms
    `msm_device_scheduled` takes; every rank runs the same `c` and
    `nbits`.  `pad`: the grid's ranks a bucket, at least the largest
    bucket of any rank (by default sized by one all-reduce of the
    maximum).  The collectives run on `device`'s tensors: NCCL's on the
    card, gloo's on the CPU.  `timings`: `shard_bucket_sums`'s keys and
    "all_gather", "combine", "tail", "host_combine" in seconds."""
    dev = resolve_device(device)
    world = dist.get_world_size(group)
    t0 = time.perf_counter()
    shard = _shard(curve, points, scalars, c, nbits, dev)
    tc, _, digits, inf = shard
    U = tc.F.U
    B = 1 << (c - 1)
    if pad is None:
        occ = torch.tensor([max_occupancy(digits, inf, B)], device=dev)
        dist.all_reduce(occ, op=dist.ReduceOp.MAX, group=group)
        pad = _pad_for(int(occ))
    bx, by, binf = _rank_sums(shard, c, pad, False, timings, t0)
    t0 = time.perf_counter()
    mine = torch.cat([bx.reshape(U, -1), by.reshape(U, -1),
                      binf.reshape(1, -1).to(torch.int32)])
    every = torch.empty((world * mine.shape[0], mine.shape[1]),
                        dtype=mine.dtype, device=dev)
    dist.all_gather_into_tensor(every, mine, group=group)
    every = every.view((world,) + mine.shape)
    if timings is not None:
        msm_v2._sync(dev)
        timings["all_gather"] = time.perf_counter() - t0
    return _combined_msm(curve, tc, c, every[:, :U].transpose(0, 1),
                         every[:, U:2 * U].transpose(0, 1),
                         (every[:, 2 * U] != 0).view((world,) + binf.shape),
                         world, timings)
