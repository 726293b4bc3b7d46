"""Distinct G1 or G2 points with known discrete logs, built on the device.

The port's counterpart of `bench.py` `make_bench_points`: point (i, u, v)
is A_i + (C_u + D_v), three families with full-range random discrete logs
from a seeded generator, so its log a_i + c_u + d_v mod r is a uniform
~255-bit value and base collisions or in-bucket partial-sum collisions
have probability ~2^-215.  On a G1 (BLS12-381's, as in `bench.py`, and
BN254's), two batched calls of the full-add kernel (`make_add_fns`) build
the Jacobian sums and one call of the normalize kernel
(`make_normalize_fn`) makes them affine.  On G2 (BLS12-381's and
BN254's), whose bench points the reference does not make and whose
coordinates lie in Fq2, the total `TCurve.add` (its products through the
Fq2 kernels) and `TCurve.to_affine` do the same.  The 320 family points are multiples of
the generator computed on the host (`mul_raw`).  `make_bench_scalars`
gives the full-range scalars of `bench.py`.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from . import resolve_device
from .curves.tcurve import TCurve, TPoints
from .ops.kernels.point_kernels import make_add_fns, make_normalize_fn
from .ops.msm_v2 import scalars_to_bytes


def _total_point_fns(tc: TCurve):
    """(add_fn, normalize_fn) with `make_add_fns`' and
    `make_normalize_fn`'s signatures over the total `TCurve` ops (the
    add never raises the doubling flag: it doubles)."""
    def add_fn(P: TPoints, Q: TPoints):
        S = tc.add(P, Q)
        return S, torch.zeros((), dtype=torch.bool, device=S.X.device)

    def normalize_fn(P: TPoints) -> TPoints:
        aff = tc.to_affine(P)
        F = tc.F
        z = F.select(aff.inf, F.zeros(aff.inf.shape), F.ones(aff.inf.shape))
        return TPoints(aff.X, aff.Y, z)

    return add_fn, normalize_fn


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
    if tc.F.U == tc.F.L:                    # a G1: the bench's kernels
        add_fn, _affine_add, _double = make_add_fns(tc)
        normalize_fn = make_normalize_fn(tc)
    else:
        add_fn, normalize_fn = _total_point_fns(tc)
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
    points = normalize_fn(S)

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
