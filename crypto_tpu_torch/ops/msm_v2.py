"""Device-scheduled Pippenger MSM with batched-affine bucket reduction.

Counterpart of `crypto_tpu/ops/msm_v2.py` `msm_device_scheduled`.  By
default, as in the reference, the levels run the doubling-free fast
kernels, which assume distinct non-opposite operands (true of every real
workload with distinct bases); a colliding pair (a duplicate base in a
bucket, or a partial-sum collision of probability ~2^-215 on random
bases) shows as a zero denominator, flags its window, and the flagged
windows are rerun with the total unified add/double before the tail.
`safe=True` runs the total formula everywhere (the reference's
`CRYPTO_TPU_SAFE_AFFINE`), exact for every input with no flag and no
rerun.  A curve over Fq2 (G2 of BLS12-381 or BN254) runs the reference's
Fq2 configuration whatever `safe` says: the total-formula Fq2 pre/post
at every level, no chunked level, no flag and no rerun.  Every layout is
read in rows per element, `F.U` (L for Fq, 2L for Fq2).  The steps:

1. signed c-bit window digits on the device (`device_digits`);
2. a stable-argsort bucket plan per window, with the buckets sorted by
   count and the per-rank occupancy profile (`_plan_windows_sorted`);
3. staircase bands from the Poisson occupancy model (`_model_bands`),
   checked against the pulled profile (`_bands_cover`) and rebuilt from it
   when it escapes the model (`_build_bands`); occupancy above
   `MAX_PROFILE_RANK` takes the grid of per-round pads instead;
4. unified batched-affine halving levels across all bands
   (`_bucket_sums_bands_unified`), each level one `pair_add_t`: the
   chunked level kernels around `batch_inv_t` of the chunk totals for wide
   levels, else one launch of the narrow level kernel, its batch inversion
   inside (G2: the Fq2 pre -> `batch_inv_t` -> post); each window's flag
   stays on the device until all levels are done;
5. one pull of the flags, and the flagged windows' levels again with the
   total formula, whose bucket sums replace theirs;
6. the Jacobian weighted tail (`tail_fn`), whose field muls run through
   the mont_mul kernel (the Fq2 mul kernel on G2);
7. the window combine by Horner's rule on the host.

Steps 4-5 are `bucket_sums` and steps 6-7 `finish`, which the sharded
MSM (`parallel/sharded_msm_v2.py`) runs around its all-gather.

Differences from the reference, all from the card's side of the design:

* The count profile is pulled first and the bands decided before any
  level runs (the reference dispatched optimistically to hide a TPU relay
  round trip), so no level ever runs on bands that do not cover the
  layout.  Every gather index is in range by construction.
* All windows that share a band layout run in the same level calls: a
  level's pair count is the windows' total, which fills the card and pays
  each batch inversion's Fermat root once per level, not once per window.
  The chunked level is taken from the reference's 4,096 pairs a call, so
  every level of a 2^20 MSM is chunked and the one-launch level serves
  the narrow levels of small MSMs; no threshold up to 2^24 timed
  measurably faster at 2^20 (`sweep_chunk_threshold.py`).  A collision
  then shares its level call (and, in the chunked level, its thread's
  chunk total) with other windows, so `pair_add_t` keeps the inversion
  valid and flags every window the zero touched, and only those are
  rerun.
* x and the sign-applied y are gathered as two (U, slots) limb tensors
  by the gather kernel (the reference's `gather_rows_t_fn`, there behind
  `CRYPTO_TPU_DMA_GATHER`) from two point-major tables built once per
  MSM (`slot_tables`: x, and y over -y), an empty slot taking a zero
  column; the reference's packed 30-bit x|y payload was a TPU gather
  trick.
* N is not padded to a power of two: the reference did so to share one
  compiled XLA program per size class, and nothing here is compiled per
  shape.  An MSM of no points returns infinity, as the reference's does.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..curves.sw import Point, SWCurve
from ..curves.tcurve import TCurve, TPoints, tcurve_for
from ..fields.ttower import TQuadField
from .kernels import curve_kernels as ck
from .kernels import field_kernels as fk

logger = logging.getLogger("crypto_tpu_torch.msm")

# count-profile resolution for the staircase bands; occupancies above this
# take the grid of per-round pads (adversarially skewed digits)
MAX_PROFILE_RANK = 256
# tallest band / grid round, in ranks
PAD_MAX = 64
# a level call with at least this many pairs takes the chunked kernels
CHUNK_MIN_PAIRS = 1 << 12
# the chunked level pads its pair count to a multiple of this (K strips of
# whole warps)
CHUNK_PAD = ck.CHUNK_K * 32
# slots laid out at once (windows x band slots); a layout above this runs
# in pieces whose bucket sums are added, so adversarial occupancy (the
# grid's many rounds) needs bounded memory
SLOT_CAP = 1 << 25


# ---------------------------------------------------------------------------
# digits
# ---------------------------------------------------------------------------

def scalars_to_bytes(scalars: Sequence[int], nbytes: int) -> np.ndarray:
    """(N, nbytes) uint8 little-endian (own copy of
    `crypto_tpu/ops/pippenger.py` `scalars_to_bytes`)."""
    buf = b"".join(int(s).to_bytes(nbytes, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), nbytes)


def device_digits(sbytes: torch.Tensor, c: int, nbits: int) -> torch.Tensor:
    """(N, nbytes) uint8 LE bytes -> (W, N) int32 signed digits in
    [-2^(c-1), 2^(c-1)], W = (nbits + c) // c."""
    if c not in (8, 16):
        raise ValueError("device digit extraction supports c in {8, 16}")
    W = (nbits + c) // c
    if sbytes.shape[1] < W * c // 8:
        raise ValueError(f"need {W * c // 8} bytes per scalar, got "
                         f"{sbytes.shape[1]}")
    b = sbytes.to(torch.int32)
    if c == 16:
        raw = b[:, 0:2 * W:2] + (b[:, 1:2 * W:2] << 8)
    else:
        raw = b[:, :W]
    half, full = 1 << (c - 1), 1 << c
    outs = []
    carry = torch.zeros(raw.shape[0], dtype=torch.int32, device=b.device)
    for w in range(W):
        d = raw[:, w] + carry
        wrap = d > half
        outs.append(torch.where(wrap, d - full, d))
        carry = wrap.to(torch.int32)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# batch inversion
# ---------------------------------------------------------------------------

def batch_inv_t(F, v: torch.Tensor) -> torch.Tensor:
    """Limb-major (U, n) nonzero -> elementwise inverses, via the
    half-split product tree (3 muls an element, every one through the
    field's mul kernel: mont_mul, or fq2_mul over Fq2) and one Fermat
    inversion at the root.  Odd widths are padded with a plain limb-0 1
    (nonzero in Fq and in Fq2) at each level of the tree."""
    n = v.shape[1]
    levels = []
    cur = v
    while cur.shape[1] > 1:
        if cur.shape[1] % 2:
            one = torch.zeros((cur.shape[0], 1), dtype=cur.dtype,
                              device=cur.device)
            one[0] = 1
            cur = torch.cat([cur, one], dim=1)
        levels.append(cur)
        h = cur.shape[1] // 2
        cur = F.mul(cur[:, :h], cur[:, h:])
    inv = F.inv(cur)
    for lev in reversed(levels):
        h = lev.shape[1] // 2
        inv = inv[:, :h]
        inv = torch.cat([F.mul(inv, lev[:, h:]), F.mul(inv, lev[:, :h])],
                        dim=1)
    return inv[:, :n].contiguous()


# ---------------------------------------------------------------------------
# bucket plan
# ---------------------------------------------------------------------------

def _layout_plan(digits: torch.Tensor, inf: torch.Tensor, B: int):
    """Every window's bucket-sort plan: (order (W, N), starts (W, B),
    counts (W, B)); bucket |d| - 1, zero digits and infinite points in
    none."""
    W = digits.shape[0]
    absd = digits.abs()
    live = (absd > 0) & ~inf[None, :]
    keys = torch.where(live, absd - 1, B).to(torch.int32)
    order = torch.argsort(keys, dim=1, stable=True)
    sk = torch.gather(keys, 1, order)
    ar = torch.arange(B + 1, dtype=torch.int32, device=digits.device)
    bounds = torch.searchsorted(sk, ar.expand(W, B + 1).contiguous())
    starts = bounds[:, :B]
    return order, starts, bounds[:, 1:] - starts


def _plan_windows_sorted(digits: torch.Tensor, inf: torch.Tensor, B: int):
    """`_layout_plan` plus each window's count-descending bucket
    permutation and occupancy profile: (order (W, N), starts_p (W, B),
    counts_p (W, B), invperm (W, B), nprofile (W, MAX_PROFILE_RANK) with
    nprofile[w, r] = #buckets with count > r, occs (W,))."""
    W = digits.shape[0]
    dev = digits.device
    order, starts, counts = _layout_plan(digits, inf, B)
    perm = torch.argsort(-counts, dim=1, stable=True)
    counts_p = torch.gather(counts, 1, perm)
    starts_p = torch.gather(starts, 1, perm)
    arB = torch.arange(B, dtype=perm.dtype, device=dev).expand(W, B)
    invperm = torch.empty_like(perm).scatter_(1, perm, arB)
    ranks = torch.arange(MAX_PROFILE_RANK, dtype=counts.dtype, device=dev)
    nprof = B - torch.searchsorted(
        counts_p.flip(1).contiguous(),
        ranks.expand(W, MAX_PROFILE_RANK).contiguous(), right=True)
    return order, starts_p, counts_p, invperm, nprof, counts_p[:, 0]


# ---------------------------------------------------------------------------
# staircase bands (host, numpy; copies of the reference's)
# ---------------------------------------------------------------------------

def _build_bands(nprof: np.ndarray, occ: int, B: int,
                 max_h: int = 64, min_q: int = 4096) -> tuple:
    """Greedy staircase: cover ranks [0, occ) with (Q, h, r0) bands where
    Q = #buckets needing rank r0 rounded up to a multiple of B/16 (>= 32),
    and h grows (pow2) until the profile drops below Q's step.  Once the
    profile is narrower than `min_q`, one final band covers the rest."""
    bands = []
    r = 0
    occ = int(occ)
    q_step = max(32, B >> 4)
    while r < occ:
        n_r = int(nprof[r]) if r < len(nprof) else 1
        n_r = max(n_r, 1)
        Q = min(B, -(-n_r // q_step) * q_step)
        if Q < min_q or Q * (occ - r) <= 2 * min_q:
            h = 1 << max(0, (occ - r - 1).bit_length())
            bands.append((Q, h, r))
            break
        h = 1
        while r + h < occ and h < max_h:
            nxt = int(nprof[min(r + h, len(nprof) - 1)])
            if min(B, -(-max(nxt, 1) // q_step) * q_step) < Q:
                break
            h *= 2
        bands.append((Q, h, r))
        r += h
    return tuple(bands)


def _poisson_profile(n_keys: int, lam: float, B: int) -> tuple:
    """(nprof, occ): expected #buckets with count > r for occupancy ~
    Poisson(lam) over `n_keys` active buckets, with a +4-sigma + 8 margin,
    capped at B; occ = first rank where the mean drops below 1e-4."""
    R = MAX_PROFILE_RANK
    nprof = np.zeros(R, dtype=np.int64)
    occ = R
    pmf = math.exp(-lam)
    cdf = pmf
    for r in range(R):
        s = max(0.0, 1.0 - cdf)
        mean = n_keys * s
        n_r = mean + 4.0 * math.sqrt(mean + 1.0) + 8.0
        nprof[r] = min(B, min(n_keys, int(math.ceil(n_r))))
        if mean < 1e-4 and occ == R:
            occ = r + 1
            break
        pmf *= lam / (r + 1)
        cdf += pmf
    return nprof, min(occ, R)


@functools.lru_cache(maxsize=None)
def _model_bands(N: int, c: int, max_h: int = 64,
                 top_keys: int | None = None) -> tuple:
    """Staircase bands for uniform scalars from the Poisson occupancy
    model: (bands, occ_model).  `top_keys` is the number of distinct
    digit values in the top window (the modulus truncated: 0x73ee for
    BLS12-381 Fr at c = 16); the profile is the elementwise max of the
    body- and top-window profiles, so one band layout covers every
    window."""
    B = 1 << (c - 1)
    nprof, occ_model = _poisson_profile(B, N / B, B)
    if top_keys is not None and 0 < top_keys:
        np_top, occ_top = _poisson_profile(min(top_keys, B),
                                           N / min(top_keys, B), B)
        nprof = np.maximum(nprof, np_top)
        occ_model = max(occ_model, occ_top)
    return _build_bands(nprof, occ_model, B, max_h=max_h), occ_model


def _bands_cover(bands: tuple, nprof_actual: np.ndarray, occ: int) -> bool:
    """True iff every (bucket, rank) slot the actual count profile needs is
    inside some band: for all r < occ, Q_band(r) >= #buckets with count > r."""
    height = sum(h for (_, h, _) in bands)
    if occ > height:
        return False
    for (Q, h, r0) in bands:
        hi = min(r0 + h, occ)
        if r0 < hi and np.any(nprof_actual[r0:hi] > Q):
            return False
    return True


def _grid_bands(occ: int, B: int) -> tuple:
    """The grid of per-round pads as bands over all B buckets: one round
    of pow2 height for occupancy <= PAD_MAX, else PAD_MAX rounds and a
    shrinking last one."""
    if occ <= PAD_MAX:
        pads = (1 << (occ - 1).bit_length(),)
    else:
        nfull, rem = divmod(occ, PAD_MAX)
        pads = (PAD_MAX,) * nfull
        if rem:
            pads += (1 << (rem - 1).bit_length(),)
    return tuple((B, h, PAD_MAX * i) for i, h in enumerate(pads))


@functools.lru_cache(maxsize=None)
def _band_grids_np(bands: tuple):
    bg = np.concatenate([np.tile(np.arange(Q, dtype=np.int64), h)
                         for (Q, h, r0) in bands])
    rk = np.concatenate([np.repeat(np.arange(h, dtype=np.int64), Q) + r0
                         for (Q, h, r0) in bands])
    return bg, rk


def band_grids(bands: tuple, device) -> tuple:
    """Concatenated (bucket, rank) index grids of a band layout, rank-major
    within each band (slot = rank*Q + bucket)."""
    bg, rk = _band_grids_np(bands)
    return (torch.from_numpy(bg).to(device), torch.from_numpy(rk).to(device))


# ---------------------------------------------------------------------------
# levels
# ---------------------------------------------------------------------------

def _pieces(bands: tuple, Wb: int) -> list:
    """Consecutive runs of bands of at most SLOT_CAP slots over Wb
    windows (at least one band each)."""
    out, cur, size = [], [], 0
    for band in bands:
        w = Wb * band[0] * band[1]
        if cur and size + w > SLOT_CAP:
            out.append(tuple(cur))
            cur, size = [], 0
        cur.append(band)
        size += w
    return out + [tuple(cur)]


def _pad_cols(t: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    if n == 0:
        return t
    pad = torch.full(t.shape[:-1] + (n,), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=-1)


def pair_add_t(F, x1, y1, m1, x2, y2, m2, fast: bool = False,
               trace: dict | None = None, windows: int = 1):
    """One batched-affine level over M pairs, limb-major: (x3, y3, inf3,
    zero).  The `_fused_ctx` dispatch: the chunked level kernels around
    the inversion of the chunk totals from CHUNK_MIN_PAIRS pairs, else one
    launch of the level kernel with its batch inversion inside (the
    reference's pre -> batch inversion -> post); the doubling-free
    kernels when `fast`, else the total formula.  Over Fq2 (a
    `TQuadField`, G2) every width takes the Fq2 pre -> batch inversion
    -> post on the total formula, as in the reference (no chunked level;
    `fast` is ignored).

    `zero` (M,) bool marks the lanes whose result is unreliable: on the
    fast path a colliding pair (P + P or P + (-P)) has d == 0, which zeroes
    its thread's chunk total and so spoils all K pairs t + j*M/K of that
    thread (the narrow level: that lane alone).  Zero totals and zero d
    are replaced by 1 before the inversion, so one collision cannot zero
    the root of the product tree and with it every inverse of the call;
    the other lanes stay exact.  All False on the total-formula path.

    `trace`: if a dict, M is appended to its list "level_pairs" and, on
    the fast path, (M, windows, K, zero_chunks) to "zero_chunks", where
    zero_chunks (M/K,) (K = 1 for the narrow level) marks the zero totals and
    `windows` is the number of equal window-major segments the M lanes
    form (the caller's layout)."""
    M = x1.shape[1]
    if trace is not None:
        trace.setdefault("level_pairs", []).append(M)
    if isinstance(F, TQuadField):
        d, dbl, inf3 = ck.affine_level_pre_fq2(F, x1, y1, m1, x2, y2, m2)
        x3, y3 = ck.affine_level_post_fq2(F, x1, y1, x2, y2,
                                          batch_inv_t(F, d), dbl, m1, m2)
        return x3, y3, inf3, torch.zeros(M, dtype=torch.bool,
                                          device=x1.device)
    if M >= CHUNK_MIN_PAIRS:
        pad = (-M) % CHUNK_PAD
        x1, y1, x2, y2 = (_pad_cols(t, pad, 0) for t in (x1, y1, x2, y2))
        m1, m2 = _pad_cols(m1, pad, 1), _pad_cols(m2, pad, 1)
        if fast:
            prefix, total, inf3 = ck.chunked_level_prefix_fast(
                F, x1, y1, m1, x2, y2, m2)
            zt = F.is_zero(total)
            total[0] |= zt.to(torch.int32)
            tinv = batch_inv_t(F, total)
            x3, y3 = ck.chunked_level_down_fast(F, x1, y1, m1, x2, y2, m2,
                                                prefix, tinv)
            zero = zt.repeat(ck.CHUNK_K)[:M]
            if trace is not None:
                trace.setdefault("zero_chunks", []).append(
                    (M, windows, ck.CHUNK_K, zt))
        else:
            prefix, total, dbl, inf3 = ck.chunked_level_prefix(
                F, x1, y1, m1, x2, y2, m2)
            tinv = batch_inv_t(F, total)
            x3, y3 = ck.chunked_level_down(F, x1, y1, m1, x2, y2, m2,
                                           prefix, tinv, dbl)
            zero = torch.zeros(M, dtype=torch.bool, device=x1.device)
        return x3[:, :M], y3[:, :M], inf3[:M], zero
    if fast:
        x3, y3, inf3, zero = ck.affine_level_fast(F, x1, y1, m1, x2, y2, m2)
        if trace is not None:
            trace.setdefault("zero_chunks", []).append((M, windows, 1, zero))
        return x3, y3, inf3, zero
    x3, y3, inf3 = ck.affine_level(F, x1, y1, m1, x2, y2, m2)
    return x3, y3, inf3, torch.zeros(M, dtype=torch.bool, device=x1.device)


def _window_flags(zero: torch.Tensor, windows: int) -> torch.Tensor:
    """(windows,) bool: the windows of a window-major lane layout that
    hold a spoiled lane."""
    return zero.reshape(windows, -1).any(dim=1)


def _level(F, lefts, rights, fast=False, trace=None):
    """pair_add_t over segment pairs, each segment (x (U, Wb, w), y, m
    (Wb, w)); returns the sums split back by the left widths, and the
    (Wb,) flags of the windows with a spoiled lane."""
    U = F.U
    Wb = lefts[0][2].shape[0]
    cat_x = [torch.cat([s[k] for s in side], dim=2).reshape(U, -1)
             for side in (lefts, rights) for k in (0, 1)]
    cat_m = [torch.cat([s[2] for s in side], dim=1).reshape(-1)
             for side in (lefts, rights)]
    cx, cy, cm, zero = pair_add_t(F, cat_x[0], cat_x[1], cat_m[0],
                                  cat_x[2], cat_x[3], cat_m[1], fast, trace,
                                  Wb)
    cx, cy, cm = cx.reshape(U, Wb, -1), cy.reshape(U, Wb, -1), \
        cm.reshape(Wb, -1)
    out, off = [], 0
    for s in lefts:
        w = s[2].shape[1]
        out.append((cx[:, :, off:off + w], cy[:, :, off:off + w],
                    cm[:, off:off + w]))
        off += w
    return out, _window_flags(zero, Wb)


def _bucket_sums_bands_unified(F, digits, xtab, ytab, order, starts_p,
                               counts_p, invperm, bands: tuple, B: int,
                               fast=False, trace=None):
    """Bucket sums of Wb windows under one band layout: (x, y (U, Wb, B),
    inf (Wb, B)) in natural bucket order, and the (Wb,) flags of the
    windows that a colliding pair spoiled (fast levels only).

    One gather each of x and y (rows of `fk.slot_tables`) lays out every
    band's slots (rank-major, so halving a band pairs equal buckets),
    through the gather kernel, index -1 on the empty slots, which get zero
    coordinates and an infinity mask (every level kernel replaces the
    denominator of an infinite operand, so the zeros raise no flag); then
    one `pair_add_t` per halving level across all active bands, and a
    padded tree combine of the band results (bands are prefix-nested, Q
    descending)."""
    U = F.U
    Wb, N = digits.shape
    bg, rk = band_grids(bands, digits.device)
    pos = starts_p[:, bg] + rk
    valid = rk < counts_p[:, bg]
    src = torch.gather(order, 1, torch.where(valid, pos, 0))
    neg = torch.gather(digits, 1, src) < 0
    xs = fk.gather_rows_t(xtab, torch.where(valid, src, -1).reshape(-1))
    ys = fk.gather_rows_t(ytab, torch.where(valid, src + N * neg, -1)
                          .reshape(-1))
    xs, ys = xs.reshape(U, Wb, -1), ys.reshape(U, Wb, -1)
    ms = (~valid).to(torch.int32)
    if trace is not None:
        trace.setdefault("slots", []).append(valid.numel())
    wflag = torch.zeros(Wb, dtype=torch.bool, device=digits.device)
    segs, off = [], 0
    for (Q, h, _r0) in bands:
        w = Q * h
        segs.append([(xs[:, :, off:off + w], ys[:, :, off:off + w],
                      ms[:, off:off + w]), Q])
        off += w
    while any(s[0][2].shape[1] > s[1] for s in segs):
        active = [s for s in segs if s[0][2].shape[1] > s[1]]
        lefts, rights = [], []
        for s in active:
            h = s[0][2].shape[1] // 2
            lefts.append(tuple(t[..., :h] for t in s[0]))
            rights.append(tuple(t[..., h:] for t in s[0]))
        outs, fl = _level(F, lefts, rights, fast, trace)
        wflag |= fl
        for s, r in zip(active, outs):
            s[0] = r

    def pad_dead(seg, w):
        p = w - seg[2].shape[1]
        return (_pad_cols(seg[0], p, 0), _pad_cols(seg[1], p, 0),
                _pad_cols(seg[2], p, 1))

    finals = [s[0] for s in segs]
    while len(finals) > 1:
        lefts = finals[0:len(finals) - 1:2]
        rights = [pad_dead(b, a[2].shape[1])
                  for a, b in zip(lefts, finals[1::2])]
        nxt, fl = _level(F, lefts, rights, fast, trace)
        wflag |= fl
        finals = nxt + ([finals[-1]] if len(finals) % 2 else [])
    ax, ay, am = pad_dead(finals[0], B)
    idx = invperm.unsqueeze(0).expand(U, Wb, B)
    return (torch.gather(ax, 2, idx), torch.gather(ay, 2, idx),
            torch.gather(am, 1, invperm) != 0, wflag)


def _window_sums(F, bands: tuple, ws: list, digits, tables, order,
                 starts_p, counts_p, invperm, B: int, fast: bool,
                 trace=None):
    """Bucket sums of the windows `ws` under one band layout, in pieces of
    at most SLOT_CAP slots whose sums are added: (x, y, inf, flags), the
    (len(ws),) flags as in `_bucket_sums_bands_unified`."""
    U = F.U
    wi = torch.tensor(ws, device=digits.device)
    acc = None
    for piece in _pieces(bands, len(ws)):
        sx, sy, sinf, fl = _bucket_sums_bands_unified(
            F, digits[wi], *tables, order[wi], starts_p[wi],
            counts_p[wi], invperm[wi], piece, B, fast, trace)
        if acc is not None:
            x3, y3, i3, zero = pair_add_t(
                F, acc[0].reshape(U, -1), acc[1].reshape(U, -1),
                acc[2].reshape(-1).to(torch.int32), sx.reshape(U, -1),
                sy.reshape(U, -1), sinf.reshape(-1).to(torch.int32), fast,
                trace, len(ws))
            sx, sy = x3.reshape(sx.shape), y3.reshape(sy.shape)
            sinf = i3.reshape(sinf.shape) != 0
            fl = fl | acc[3] | _window_flags(zero, len(ws))
        acc = (sx, sy, sinf, fl)
    return acc


# ---------------------------------------------------------------------------
# weighted tail
# ---------------------------------------------------------------------------

def _jac_reduce(tc: TCurve, P: TPoints, dim: int) -> TPoints:
    """Tree-reduce a pow2-long batch axis (dim counts the limb axis)."""
    n = P.X.shape[dim]
    while n > 1:
        half = n // 2
        a = TPoints(*(t.narrow(dim, 0, half) for t in P))
        b = TPoints(*(t.narrow(dim, half, half) for t in P))
        P = tc.add(a, b)
        n = half
    return TPoints(*(t.squeeze(dim) for t in P))


def tail_fn(tc: TCurve, c: int):
    """Bucket sums (U, Wb, B) -> each window's point, via the two-axis
    weighted reduction: bucket b = q*C + j has weight b + 1, so the sum is
    C * sum_q q*S_q + sum_j (j+1)*T_j (S_q summing row q, T_j column j).
    Jacobian coordinates and the total `TCurve.add`; runs every window of
    the batch in the same ops."""
    B = 1 << (c - 1)
    F = tc.F

    def weighted_sum_shift1(pts: TPoints, n: int) -> TPoints:
        """sum_i (i+1) * P_i over the last axis, by bit-decomposition
        masked tree sums and Horner doubling."""
        nbits = n.bit_length()
        idx = torch.arange(1, n + 1, device=F.device)
        bitk = torch.arange(nbits, device=F.device)
        masks = ((idx[None, :] >> bitk[:, None]) & 1) > 0      # (nbits, n)
        Wb = pts.X.shape[1]
        masks = masks[:, None, :].expand(nbits, Wb, n)
        stacked = TPoints(*(t.unsqueeze(1).expand(-1, nbits, -1, -1)
                            for t in pts))
        p = tc.select(masks, stacked, tc.infinity((nbits, Wb, n)))
        bitsums = _jac_reduce(tc, p, 3)                 # (L, nbits, Wb)
        acc = TPoints(*(t[:, nbits - 1] for t in bitsums))
        for bpos in range(nbits - 2, -1, -1):
            acc = tc.double(acc)
            acc = tc.add(acc, TPoints(*(t[:, bpos] for t in bitsums)))
        return acc

    def tail(px, py, pinf):
        L, Wb = px.shape[0], px.shape[1]
        logB = B.bit_length() - 1
        logC = (logB + 1) // 2
        C = 1 << logC
        R = B // C
        z = F.select(pinf, F.zeros(pinf.shape), F.ones(pinf.shape))
        grid = TPoints(*(t.reshape(L, Wb, R, C) for t in (px, py, z)))
        Sq = _jac_reduce(tc, grid, 3)               # over columns -> (Wb, R)
        Tc = _jac_reduce(tc, grid, 2)               # over rows -> (Wb, C)
        wq = weighted_sum_shift1(Sq, R)             # sum (q+1) S_q
        tq = _jac_reduce(tc, Sq, 2)                 # sum S_q
        qpart = tc.add(wq, tc.neg(tq))              # sum q S_q
        for _ in range(logC):
            qpart = tc.double(qpart)                # * C
        cpart = weighted_sum_shift1(Tc, C)          # sum (j+1) T_j
        out = tc.add(qpart, cpart)
        aff = tc.to_affine(out)
        return aff.X, aff.Y, aff.inf

    return tail


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _auto_c_v2(n: int) -> int:
    return 16 if n >= (1 << 17) else 8


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def digits_of(scalars, c: int, nbits: int, dev) -> torch.Tensor:
    """(W, N) int32 signed digits on `dev` from an int sequence or (N,
    nbytes) uint8 LE bytes (numpy or tensor); a (W, N) int32 digit tensor
    from `device_digits` passes through."""
    if isinstance(scalars, torch.Tensor) and scalars.dim() == 2 \
            and scalars.dtype == torch.int32:
        return scalars.to(dev)
    if isinstance(scalars, (np.ndarray, torch.Tensor)) \
            and scalars.dtype in (np.uint8, torch.uint8):
        sbytes = torch.as_tensor(scalars)
    else:
        W_ = (nbits + c) // c
        sbytes = torch.from_numpy(scalars_to_bytes(
            [int(s) for s in scalars], (W_ * c + 7) // 8).copy())
    return device_digits(sbytes.to(dev), c, nbits)


def msm_device_scheduled(curve: SWCurve, points, scalars,
                         c: int | None = None, nbits: int | None = None,
                         pad: int | None = None, device="cuda",
                         timings: dict | None = None,
                         safe: bool = False) -> Point:
    """sum_i scalars[i] * points[i] on the device; returns a host Point.

    `curve`: G1 or G2 of BLS12-381 or BN254 (its level, Fq2 and gather
    kernels at 12 or 8 limbs).  `points`: host Point list or `TPoints`
    with Z in {0, 1}.
    `scalars`: int sequence, (N, nbytes) uint8 LE bytes (numpy or tensor),
    or a (W, N) int32 digit tensor from `device_digits`.
    `pad`: run the grid with this many ranks per bucket (at least the
    largest bucket).  `safe`: run every level with the total formula (the
    reference's `CRYPTO_TPU_SAFE_AFFINE`); by default the levels are
    doubling-free and the windows a colliding pair spoiled are rerun with
    the total formula, each named in a warning (G2 always runs the total
    formula).  `timings`: if a dict, the seconds of each phase are stored
    in it (the device is synchronised between phases), the rerun windows
    in its list "rerun_windows", the slots of each layout in its list
    "slots", and each level call's record as `pair_add_t`'s `trace`
    describes (the rerun's calls in the dict "rerun_trace")."""
    dev = resolve_device(device)
    tc = tcurve_for(curve, dev)
    F = tc.F
    # G2 (Fq2) runs the total formula only, as the reference forces
    fast = not safe and not isinstance(F, TQuadField)
    t0 = time.perf_counter()
    if nbits is None:
        nbits = curve.scalar_field.bits
    if not isinstance(points, TPoints):
        points = tc.pack_points([p.normalize() for p in points])
    points = TPoints(*(t.to(dev) for t in points))
    N = points.X.shape[1]
    if c is None:
        c = _auto_c_v2(N)

    digits = digits_of(scalars, c, nbits, dev)
    W = digits.shape[0]
    if digits.shape[1] != N:
        raise ValueError(f"{digits.shape[1]} scalars for {N} points")
    if N == 0:
        return curve.infinity()
    inf_mask = tc.is_infinity(points)

    B = 1 << (c - 1)
    order, starts_p, counts_p, invperm, nprof_d, occs_d = \
        _plan_windows_sorted(digits, inf_mask, B)
    nprof = nprof_d.cpu().numpy()
    occs = np.maximum(occs_d.cpu().numpy(), 1)
    occ_a = int(occs.max())
    if pad is not None:
        if pad < occ_a:
            raise ValueError(f"pad={pad} is below the largest bucket "
                             f"({occ_a} points)")
        groups = {_grid_bands(pad, B): list(range(W))}
    elif occ_a > MAX_PROFILE_RANK:
        groups = {}
        for w in range(W):
            groups.setdefault(_grid_bands(int(occs[w]), B), []).append(w)
    else:
        smax = min(1 << nbits, curve.scalar_field.p)
        top_keys = (smax >> ((W - 1) * c)) + 1
        bands, occ_model = _model_bands(N, c, max_h=PAD_MAX,
                                        top_keys=top_keys)
        nprof_a = nprof.max(axis=0)
        if not (occ_a <= occ_model and _bands_cover(bands, nprof_a, occ_a)):
            logger.warning("msm_v2: count profile outside the Poisson model, "
                           "using exact bands: N=%d c=%d occ=%d (model %d)",
                           N, c, occ_a, occ_model)
            bands = _build_bands(nprof_a, occ_a, B, max_h=PAD_MAX)
        groups = {bands: list(range(W))}
    if timings is not None:
        _sync(dev)
        timings["digits_plan"] = time.perf_counter() - t0
    bx, by, binf = bucket_sums(F, points, digits,
                               (order, starts_p, counts_p, invperm), groups,
                               B, fast, timings)
    return finish(curve, tc, c, bx, by, binf, timings)


def bucket_sums(F, points: TPoints, digits: torch.Tensor, plan: tuple,
                groups: dict, B: int, fast: bool,
                timings: dict | None = None) -> tuple:
    """Every window's bucket sums, (x, y (U, W, B), inf (W, B)) in natural
    bucket order, from the windows' bucket plan `plan` (order, starts_p,
    counts_p, invperm of `_plan_windows_sorted`) and `groups`, {band
    layout: the windows that run under it}.  On the fast levels the
    windows that a colliding pair spoiled are rerun with the total formula
    after one pull of the flags.  `timings`: "levels", "rerun",
    "rerun_windows" and "rerun_trace" as `msm_device_scheduled` says."""
    dev = digits.device
    W = digits.shape[0]
    t0 = time.perf_counter()
    bx = torch.empty((F.U, W, B), dtype=torch.int32, device=dev)
    by = torch.empty_like(bx)
    binf = torch.empty((W, B), dtype=torch.bool, device=dev)
    flags = torch.zeros(W, dtype=torch.bool, device=dev)
    tables = fk.slot_tables(F, points.X.contiguous(), points.Y.contiguous())
    args = (digits, tables) + tuple(plan) + (B,)

    def run(bands, ws, fast_w, trace):
        sx, sy, sinf, fl = _window_sums(F, bands, ws, *args, fast_w, trace)
        wi = torch.tensor(ws, device=dev)
        bx[:, wi], by[:, wi], binf[wi] = sx, sy, sinf
        return wi, fl

    for bands, ws in groups.items():
        wi, fl = run(bands, ws, fast, timings)
        flags[wi] = fl
    if timings is not None:
        _sync(dev)
        timings["levels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    # one pull of the flags, before the tail; the safe path has none
    rerun = [int(w) for w in np.nonzero(flags.cpu().numpy())[0]] if fast \
        else []
    for w in rerun:
        logger.warning("msm_v2: colliding pair in window %d (duplicate "
                       "bases?), rerunning with total-formula kernels", w)
    rerun_trace = None if timings is None else {}
    for bands, ws in groups.items():
        again = [w for w in ws if w in rerun]
        if again:
            run(bands, again, False, rerun_trace)
    if timings is not None:
        _sync(dev)
        timings["rerun"] = time.perf_counter() - t0
        timings["rerun_windows"] = rerun
        timings["rerun_trace"] = rerun_trace
    return bx, by, binf


def finish(curve: SWCurve, tc: TCurve, c: int, bx, by, binf,
           timings: dict | None = None) -> Point:
    """The weighted tail (`tail_fn`) over every window's bucket sums, then
    the window combine by Horner's rule on the host: the MSM's point.
    `timings`: "tail" and "host_combine"."""
    F = tc.F
    t0 = time.perf_counter()
    ox, oy, oinf = tail_fn(tc, c)(bx, by, binf)
    hx = np.atleast_1d(F.unpack_host(ox))
    hy = np.atleast_1d(F.unpack_host(oy))
    hinf = oinf.cpu().numpy()
    if timings is not None:
        timings["tail"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    K = curve.K
    acc = curve.infinity()
    for w in range(hinf.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = acc.double()
        if not bool(hinf[w]):
            acc = acc + Point(hx[w], hy[w], K.one(), curve)
    if timings is not None:
        timings["host_combine"] = time.perf_counter() - t0
    return acc
