"""Device-batched accumulator witness updates (manager side, with sk).

The port's twin of `crypto_tpu/accumulator/device_update.py`.  The host
path (`witness.py` `_batch_update_with_sk`, the reference's
`vb_accumulator/src/batch_utils.rs` polynomials) costs O(|batch| *
|members|) host field products plus one variable-base scalar
multiplication per member.  This path runs them batched over the
members:

* the d/v polynomials as Python loops over the batch (the reference's
  `lax.scan`s), each step three `TField.mul` calls (the mont_mul kernel
  on the card) and an add and a sub on (8, M) Fr tensors;
* d_D inverted by `ops/msm_v2.batch_inv_t` (a half-split product tree
  of mont_mul launches and one mont_pow root; the reference's
  `batch_inv` pads to a power of two instead: both give canonical
  inverses, so the values agree, and a zero d_D zeroes every inverse in
  both, since inv(0) = 0 at the root);
* the scalars' bits extracted on the device, and ONE batched
  double-and-add (`TCurve.scalar_mul`) over 2M lanes, [C_i | V], then one
  pairwise `TCurve.add` and `to_affine` (one mont_pow root), unpacked once
  on the host.

Routed from `witness.py` from `DEVICE_THRESHOLD` members on a CUDA device
(off with CRYPTO_TPU_NO_DEVICE_ACCUM=1; on, on any device, with
CRYPTO_TPU_FORCE_DEVICE_ACCUM=1), as the reference routes it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..curves.sw import Point
from ..curves.tcurve import TPoints, tcurve_for
from ..fields.tfield import TField, tfield_for
from ..ops.msm_v2 import batch_inv_t
from .batch_utils import _batch_inverse

DEVICE_THRESHOLD = 512
LIMB_BITS = 32


def enabled(n_members: int, device="cuda") -> bool:
    """Whether `witness._batch_update_with_sk` takes this path: from
    `DEVICE_THRESHOLD` members on a CUDA device (`device`: CUDA unless the
    caller names the CPU; raises without a card), unless an environment
    override says otherwise."""
    dev = resolve_device(device)
    if os.environ.get("CRYPTO_TPU_NO_DEVICE_ACCUM"):
        return False
    if os.environ.get("CRYPTO_TPU_FORCE_DEVICE_ACCUM"):
        return True
    return n_members >= DEVICE_THRESHOLD and dev.type == "cuda"


def _bits_msb(limbs: torch.Tensor, nbits: int) -> torch.Tensor:
    """(L, M) int32 plain (not Montgomery) 32-bit limbs -> (nbits, M) int32
    0/1, MSB first: row k holds bit nbits - 1 - k of each element, the row
    layout `TCurve.scalar_mul` takes (the reference returns (M, nbits)).
    `>>` on int32 is arithmetic, so the `& 1` after it drops bit 31's
    sign fill."""
    pos = torch.arange(nbits - 1, -1, -1, device=limbs.device)
    shift = (pos % LIMB_BITS).to(torch.int32)[:, None]
    return (limbs[pos // LIMB_BITS] >> shift) & 1


def _eval_add_polys(T: TField, x: torch.Tensor, additions, alpha):
    """Batched d_A(x) = prod(y_i - x) and
    v_A(x) = sum_s prod_{i<s}(y_i + alpha) * prod_{i>s}(y_i - x)
    over members x, (L, M) Montgomery: a loop of |additions| steps (3 muls
    per step, batched over members).  Reference: `batch_utils.rs` Poly_d /
    Poly_v_A."""
    F = alpha.f
    n = len(additions)
    ones = T.ones(x.shape[1:])
    if n == 0:
        return ones, torch.zeros_like(x)
    # host-precomputed factors: factor_s = prod_{i<s}(y_i + alpha)
    factors = [F(1)]
    for s in range(1, n):
        factors.append(factors[-1] * (additions[s - 1] + alpha))
    adds_p = T.pack([int(y) for y in additions])           # (L, n)
    facs_p = T.pack([int(f) for f in factors])             # (L, n)
    dA, suffix, acc = ones, ones, torch.zeros_like(x)
    # s descending, so `suffix` holds prod_{i>s}(y_i - x)
    for s in range(n - 1, -1, -1):
        acc = T.add(acc, T.mul(facs_p[:, s:s + 1], suffix))
        t = T.sub(adds_p[:, s:s + 1], x)
        suffix = T.mul(suffix, t)
        dA = T.mul(dA, t)
    return dA, acc


def _eval_rem_polys(T: TField, x: torch.Tensor, removals, alpha):
    """Batched d_D(x) = prod(y_i - x) and
    v_D(x) = sum_s prod_{i<=s} 1/(y_i + alpha) * prod_{i<s}(y_i - x)."""
    F = alpha.f
    n = len(removals)
    ones = T.ones(x.shape[1:])
    if n == 0:
        return ones, torch.zeros_like(x)
    inv = _batch_inverse([y + alpha for y in removals])
    factors = []
    f = F(1)
    for s in range(n):
        f = f * inv[s]
        factors.append(f)
    rems_p = T.pack([int(y) for y in removals])
    facs_p = T.pack([int(f) for f in factors])
    dD, prefix, acc = ones, ones, torch.zeros_like(x)
    for s in range(n):
        acc = T.add(acc, T.mul(facs_p[:, s:s + 1], prefix))
        t = T.sub(rems_p[:, s:s + 1], x)
        prefix = T.mul(prefix, t)
        dD = T.mul(dD, t)
    return dD, acc


def _update_scalars(T: TField, x: torch.Tensor, additions, removals,
                    alpha, lap):
    """(f, v) per member, (L, M) Montgomery: the witness factor d_A/d_D and
    the accumulator's scalar v_AD/d_D (v_A alone after additions, -v_D/d_D
    after removals)."""
    dA, vA = _eval_add_polys(T, x, additions, alpha)
    if not removals:
        lap("scans")
        return dA, vA
    dD, vD = _eval_rem_polys(T, x, removals, alpha)
    lap("scans")
    dDinv = batch_inv_t(T, dD)
    lap("batch_inv")
    if additions:
        fA = alpha.f(1)
        for a in additions:
            fA = fA * (a + alpha)
        v = T.sub(vA, T.mul(vD, T.pack([int(fA)])))           # v_AD
        f = T.mul(dA, dDinv)
    else:
        v = T.neg(vD)
        f = dDinv
    return f, T.mul(v, dDinv)


def batch_update_with_sk_device(additions, removals, elements, old_Cs,
                                old_accumulator, sk, device="cuda",
                                timings: dict | None = None):
    """Device variant of `witness._batch_update_with_sk` on `device` (CUDA
    unless the caller names the CPU; raises without a card): returns
    (d_factors host Fp list, new_Cs host Point list).  `timings`: if a
    dict, the seconds of each phase are stored in it, the device
    synchronised between them: "scans", "batch_inv" (with removals),
    "bits" (the factor products, from_mont, the bit rows and packing the
    2M points), "scalar_mul", "add", "to_affine" and "unpack"."""
    dev = resolve_device(device)
    curve = old_accumulator.curve
    F = sk.alpha.f
    tc = tcurve_for(curve, dev)
    T = tfield_for(F, dev)
    M = len(elements)
    t0 = time.perf_counter()

    def lap(key: str) -> None:
        nonlocal t0
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        timings[key] = t - t0
        t0 = t

    x = T.pack([int(y) for y in elements])                 # (L, M) mont
    f, vscal = _update_scalars(T, x, additions, removals, sk.alpha, lap)

    # ONE batched double-and-add over 2M lanes computes C_i * f_i (member
    # witnesses, variable bases) and V * v_i (broadcast accumulator base)
    # together; the halves then add pairwise.
    nbits = F.p.bit_length()
    bits2 = torch.cat([_bits_msb(T.from_mont(f), nbits),
                       _bits_msb(T.from_mont(vscal), nbits)], dim=1)
    Cs = tc.pack_points([c.normalize() for c in old_Cs])
    Vp = tc.pack_points([old_accumulator.normalize()])
    pts2 = TPoints(*(torch.cat([c, v.expand(-1, M)], dim=1)
                     for c, v in zip(Cs, Vp)))
    lap("bits")
    both = tc.scalar_mul(pts2, bits2)
    lap("scalar_mul")
    out = tc.add(TPoints(*(t[:, :M] for t in both)),
                 TPoints(*(t[:, M:] for t in both)))
    lap("add")
    aff = tc.to_affine(out)
    lap("to_affine")
    inf = aff.inf.cpu().numpy()
    xs = np.atleast_1d(tc.F.unpack_host(aff.X))
    ys = np.atleast_1d(tc.F.unpack_host(aff.Y))
    K = curve.K
    new_pts = [curve.infinity() if inf[i]
               else Point(xs[i], ys[i], K.one(), curve) for i in range(M)]
    d_factors = [F(int(v)) for v in np.atleast_1d(T.unpack(f))]
    lap("unpack")
    return d_factors, new_pts
