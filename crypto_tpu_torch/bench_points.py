"""Distinct G1 points with known discrete logs, built on the device.

The port's counterpart of `bench.py` `make_bench_points`: point (i, u, v)
is A_i + (C_u + D_v), three families with full-range random discrete logs
from a seeded generator, so its log a_i + c_u + d_v mod r is a uniform
~255-bit value and base collisions or in-bucket partial-sum collisions
have probability ~2^-215.  As in `bench.py`, two batched calls of the
full-add kernel (`make_add_fns`) build the Jacobian sums and one call of
the normalize kernel (`make_normalize_fn`) makes them affine.
`make_bench_scalars` gives the full-range scalars of `bench.py`.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from . import resolve_device
from .curves.tcurve import TCurve, TPoints
from .ops.kernels.point_kernels import make_add_fns, make_normalize_fn
from .ops.msm_v2 import scalars_to_bytes


def make_bench_points(tc: TCurve, n: int, seed: int = 0xBE7C4):
    """n distinct points of `tc.curve` (a prime-order group) as an affine
    `TPoints` (Z = 1) on `tc`'s device, and `dlog_fn(i)` giving point i's
    discrete log to the generator."""
    k = 64
    m = n // k
    m1 = min(128, m)
    m2 = m // m1 if m1 else 0
    if m1 * m2 * k != n:
        raise ValueError("n must be a power of two >= 2^12")
    r = tc.curve.scalar_field.p
    hrng = random.Random(seed)
    a_s = [hrng.randrange(1, r) for _ in range(k)]
    c_s = [hrng.randrange(1, r) for _ in range(m1)]
    d_s = [hrng.randrange(1, r) for _ in range(m2)]
    base = tc.curve.generator()
    A, C, D = (tc.pack_points([base.mul_raw(s) for s in ss])
               for ss in (a_s, c_s, d_s))
    add_fn, _affine_add, _double = make_add_fns(tc)
    flags = []

    def outer_sum(P: TPoints, Q: TPoints) -> TPoints:
        np_, nq = P.X.shape[1], Q.X.shape[1]
        S, flag = add_fn(TPoints(*(t.repeat_interleave(nq, dim=1) for t in P)),
                         TPoints(*(t.repeat(1, np_) for t in Q)))
        flags.append(flag)
        return S

    S = outer_sum(A, outer_sum(C, D))
    if bool(torch.stack(flags).any()):
        raise RuntimeError("bench point construction hit a doubling")
    if bool(tc.is_infinity(S).any()):
        raise RuntimeError("bench point construction hit infinity")
    points = make_normalize_fn(tc)(S)

    def dlog_fn(i: int) -> int:
        a, rest = divmod(i, m)
        u, v = divmod(rest, m2)
        return (a_s[a] + c_s[u] + d_s[v]) % r

    return points, dlog_fn


def make_bench_scalars(r: int, n: int, seed: int, nbytes: int = 32,
                       device="cuda"):
    """n uniform scalars mod r (full range) from `seed`: the Python ints
    and their (n, nbytes) uint8 little-endian bytes on `device`."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 63, size=(n, 5), dtype=np.int64).astype(object)
    sc = [(int(w0) | (int(w1) << 63) | (int(w2) << 126) | (int(w3) << 189)
           | (int(w4) << 252)) % r for (w0, w1, w2, w3, w4) in words]
    sb = torch.from_numpy(scalars_to_bytes(sc, nbytes).copy())
    return sc, sb.to(resolve_device(device))
