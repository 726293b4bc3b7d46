"""Batched-affine halving levels: CUDA kernels, wrappers and plain versions.

Four TPU kernels of `crypto_tpu/ops/pallas/curve_kernels.py` on the MSM's
levels, over BLS12-381 Fq (12 limbs) and BN254 Fq (8), as the reference's
take `base.L`.  The total formula (the safe path and the per-window
rerun):

* `affine_level` replaces `affine_kernels_for` (`call_pre` /
  `call_post`) and the batch inversion between them, `csrc/affine_level.cu`:
  one launch a level, (x1, y1, m1, x2, y2, m2) -> (x3, y3, inf3), the
  unified affine add/double.  Its plain version is the split level:
  `affine_level_pre_plain` (d = 2*y1 when doubling else x2 - x1, a plain
  limb-0 1 in dead lanes, and the masks) -> `msm_v2.batch_inv_t` ->
  `affine_level_post_plain`.
* `chunked_level_prefix` / `chunked_level_down` replace
  `chunked_level_kernels_for` (`call_prefix` / `call_down`),
  `csrc/chunked_level.cu`: Montgomery's trick over the K = 8 pairs
  t + j*(M/K) that thread t owns; only the (L, M/K) totals go through
  `batch_inv_t`, and down walks back, rebuilding each d that prefix
  formed from prefix's doubling mask (`_denom_of_dbl`).

The doubling-free formula (the MSM's default; `_denom_fast` is the
reference's contract: d = x2 - x1, a limb-0 1 where an operand is
infinite, and d == 0 left as 0 so a colliding pair shows):

* `affine_level_fast` replaces `affine_kernels_fast` and its inversion
  the same way: (x3, y3, inf3, zero) by the 3-mul distinct-points formula,
  `zero` marking the pairs whose d is 0; there d enters the inversion as a
  plain limb-0 1 (`msm_v2.pair_add_t`'s substitute), so no collision
  spoils another lane.  Its plain version is `affine_level_pre_fast_plain`
  -> that substitute -> `msm_v2.batch_inv_t` ->
  `affine_level_post_fast_plain`.
* `chunked_level_prefix_fast` / `chunked_level_down_fast` replace
  `chunked_level_kernels_fast`: prefix -> (prefix, total, inf3), a total
  of 0 where a pair of its thread collides; down -> (x3, y3).

The total formula over Fq2 (G2 of either curve, whose MSM runs it at
every level with no chunked level, as the reference does):

* `affine_level_pre_fq2` / `affine_level_post_fq2` replace
  `affine_kernels_for_fq2` (`call_pre` / `call_post`),
  `csrc/affine_level_fq2.cu`: pre(x1, y1, m1, x2, y2, m2) -> (d, dbl,
  inf3) and post(x1, y1, x2, y2, dinv, dbl, m1, m2) -> (x3, y3), the
  split total level, with (2L, M) coordinates (c0's limbs in rows [:L],
  c1's in [L:], `fields/ttower.py`); the limb-0 1 of a dead lane is in
  row 0 (c0).  Their plain versions are `affine_level_pre_plain` /
  `affine_level_post_plain`, which are generic over the field; the batch
  inversion between them is `msm_v2.batch_inv_t` on `fq2_mul`.

Coordinates are (L, M) limb-major int32 tensors (see `fields/tfield.py`),
masks (M,) int32, nonzero meaning infinity (m1, m2, inf3) or doubling
(dbl).  What bounds each kernel on the H100 and what the design does about
it is noted in its source file.  Each wrapper launches its kernel for CUDA
tensors (and counts the launch), takes the plain version for CPU tensors,
and raises otherwise; the plain versions compute the same canonical
values, so the two agree bit for bit on live lanes and flags (and on dead
lanes too, since both fill them the same way; an inverse is unique, so a
kernel's own inversion tree gives what `batch_inv_t`'s gives).  On CUDA
tensors the plain one-launch levels' `batch_inv_t` runs the `mont_mul` and
`mont_pow` kernels, each held to its own plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load_library
from .field_kernels import (check_kernel_field, check_limbs, check_masks,
                            mont_mul_plain, on_card, stream_of)

CHUNK_K = 8        # pairs each thread of the chunked level owns


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, in tensor ops)
# ---------------------------------------------------------------------------

def _denom_dbl_inf(F, x1, y1, x2, y2, i1, i2):
    """(d, is_dbl, is_inf3) of the unified add/double; limb-0 1 where the
    lane is dead (an infinite operand, P + (-P), or d == 0)."""
    same_x = F.eq(x1, x2)
    y_opp = F.eq(y1, F.neg(y2))
    both = ~i1 & ~i2
    is_dbl = same_x & ~y_opp & both
    is_inf3 = (same_x & y_opp & both) | (i1 & i2)
    return _denom_of_dbl(F, x1, y1, x2, is_dbl, i1, i2), is_dbl, is_inf3


def _denom_of_dbl(F, x1, y1, x2, is_dbl, i1, i2):
    """d of the unified add/double given its doubling mask: 2*y1 where
    doubling, else x2 - x1; limb-0 1 where an operand is infinite or d ==
    0.  With `_denom_dbl_inf`'s mask that is its d: a lane it finds dead
    with both operands finite (P + (-P), the same x) has x2 - x1 = 0."""
    d = F.select(is_dbl, F.double(y1), F.sub(x2, x1))
    one = torch.zeros_like(d)
    one[0] = 1
    return F.select(i1 | i2 | F.is_zero(d), one, d)


def _unified_apply(F, x1, y1, x2, y2, dinv, is_dbl, i1, i2):
    mul = F.mul_plain
    x1sq = F.square_plain(x1)
    num = F.select(is_dbl, F.add(F.double(x1sq), x1sq), F.sub(y2, y1))
    lam = mul(num, dinv)
    x3 = F.sub(F.sub(F.square_plain(lam), x1), x2)
    y3 = F.sub(mul(lam, F.sub(x1, x3)), y1)
    x3 = F.select(i1, x2, F.select(i2, x1, x3))
    y3 = F.select(i1, y2, F.select(i2, y1, y3))
    return x3, y3


def _denom_fast(F, x1, x2, i1, i2):
    """(d, is_inf3) of the doubling-free add: d = x2 - x1, a limb-0 1
    where either operand is infinite; d == 0 (a colliding pair) stays 0."""
    d = F.sub(x2, x1)
    one = torch.zeros_like(d)
    one[0] = 1
    return F.select(i1 | i2, one, d), i1 & i2


def _fast_apply(F, x1, y1, x2, y2, dinv, i1, i2):
    mul = F.mul_plain
    lam = mul(F.sub(y2, y1), dinv)
    x3 = F.sub(F.sub(mul(lam, lam), x1), x2)
    y3 = F.sub(mul(lam, F.sub(x1, x3)), y1)
    x3 = F.select(i1, x2, F.select(i2, x1, x3))
    y3 = F.select(i1, y2, F.select(i2, y1, y3))
    return x3, y3


def affine_level_pre_plain(F, x1, y1, m1, x2, y2, m2):
    d, is_dbl, is_inf3 = _denom_dbl_inf(F, x1, y1, x2, y2, m1 != 0, m2 != 0)
    return d, is_dbl.to(torch.int32), is_inf3.to(torch.int32)


def affine_level_post_plain(F, x1, y1, x2, y2, dinv, dbl, m1, m2):
    return _unified_apply(F, x1, y1, x2, y2, dinv, dbl != 0, m1 != 0, m2 != 0)


def affine_level_pre_fast_plain(F, x1, y1, m1, x2, y2, m2):
    d, is_inf3 = _denom_fast(F, x1, x2, m1 != 0, m2 != 0)
    return d, is_inf3.to(torch.int32)


def affine_level_post_fast_plain(F, x1, y1, x2, y2, dinv, m1, m2):
    return _fast_apply(F, x1, y1, x2, y2, dinv, m1 != 0, m2 != 0)


def _batch_inv(F, d):
    from ..msm_v2 import batch_inv_t      # msm_v2 imports this module
    return batch_inv_t(F, d)


def affine_level_plain(F, x1, y1, m1, x2, y2, m2):
    d, dbl, inf3 = affine_level_pre_plain(F, x1, y1, m1, x2, y2, m2)
    x3, y3 = affine_level_post_plain(F, x1, y1, x2, y2, _batch_inv(F, d), dbl,
                                     m1, m2)
    return x3, y3, inf3


def affine_level_fast_plain(F, x1, y1, m1, x2, y2, m2):
    d, inf3 = affine_level_pre_fast_plain(F, x1, y1, m1, x2, y2, m2)
    zero = F.is_zero(d)
    d[0] |= zero.to(torch.int32)
    x3, y3 = affine_level_post_fast_plain(F, x1, y1, x2, y2, _batch_inv(F, d),
                                          m1, m2)
    return x3, y3, inf3, zero


def chunked_level_prefix_plain(F, x1, y1, m1, x2, y2, m2):
    M = x1.shape[1]
    T = M // CHUNK_K
    prefix = torch.empty_like(x1)
    dbl = torch.empty_like(m1)
    inf3 = torch.empty_like(m1)
    acc = None
    for j in range(CHUNK_K):
        sl = slice(j * T, (j + 1) * T)
        d, is_dbl, is_inf3 = _denom_dbl_inf(
            F, x1[:, sl], y1[:, sl], x2[:, sl], y2[:, sl], m1[sl] != 0,
            m2[sl] != 0)
        acc = d if acc is None else mont_mul_plain(acc, d, F.mod)
        prefix[:, sl] = acc
        dbl[sl] = is_dbl.to(torch.int32)
        inf3[sl] = is_inf3.to(torch.int32)
    return prefix, acc.contiguous(), dbl, inf3


def chunked_level_down_plain(F, x1, y1, m1, x2, y2, m2, prefix, tinv, dbl):
    M = x1.shape[1]
    T = M // CHUNK_K
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    t = tinv
    for j in range(CHUNK_K - 1, -1, -1):
        sl = slice(j * T, (j + 1) * T)
        X1, Y1, X2, Y2 = x1[:, sl], y1[:, sl], x2[:, sl], y2[:, sl]
        i1, i2 = m1[sl] != 0, m2[sl] != 0
        if j > 0:
            dinv = mont_mul_plain(t, prefix[:, (j - 1) * T:j * T], F.mod)
            d = _denom_of_dbl(F, X1, Y1, X2, dbl[sl] != 0, i1, i2)
            t = mont_mul_plain(t, d, F.mod)
        else:
            dinv = t
        x3[:, sl], y3[:, sl] = _unified_apply(F, X1, Y1, X2, Y2, dinv,
                                              dbl[sl] != 0, i1, i2)
    return x3, y3


def chunked_level_prefix_fast_plain(F, x1, y1, m1, x2, y2, m2):
    M = x1.shape[1]
    T = M // CHUNK_K
    prefix = torch.empty_like(x1)
    inf3 = torch.empty_like(m1)
    acc = None
    for j in range(CHUNK_K):
        sl = slice(j * T, (j + 1) * T)
        d, is_inf3 = _denom_fast(F, x1[:, sl], x2[:, sl], m1[sl] != 0,
                                 m2[sl] != 0)
        acc = d if acc is None else mont_mul_plain(acc, d, F.mod)
        prefix[:, sl] = acc
        inf3[sl] = is_inf3.to(torch.int32)
    return prefix, acc.contiguous(), inf3


def chunked_level_down_fast_plain(F, x1, y1, m1, x2, y2, m2, prefix, tinv):
    M = x1.shape[1]
    T = M // CHUNK_K
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    t = tinv
    for j in range(CHUNK_K - 1, -1, -1):
        sl = slice(j * T, (j + 1) * T)
        X1, Y1, X2, Y2 = x1[:, sl], y1[:, sl], x2[:, sl], y2[:, sl]
        i1, i2 = m1[sl] != 0, m2[sl] != 0
        if j > 0:
            dinv = mont_mul_plain(t, prefix[:, (j - 1) * T:j * T], F.mod)
            d, _ = _denom_fast(F, X1, X2, i1, i2)
            t = mont_mul_plain(t, d, F.mod)
        else:
            dinv = t
        x3[:, sl], y3[:, sl] = _fast_apply(F, X1, Y1, X2, Y2, dinv, i1, i2)
    return x3, y3


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, F, coords, masks, fq2=False):
    """Checks of the level wrappers: a base field the kernels take
    (`check_kernel_field`), and L rows an element for the Fq kernels, 2L
    for the Fq2 ones."""
    check_kernel_field(name, F.mod)
    rows = 2 * F.L if fq2 else F.L
    if F.U != rows:
        raise ValueError(f"{name}: the kernel takes {rows} rows an "
                         f"element, got {F.U}")
    M = check_limbs(name, rows, *coords)
    check_masks(name, M, coords[0].device, *masks)
    return M


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _c_args(F, M, device, *extra):
    """The trailing C arguments: M, the limb count, the modulus, -p^-1,
    `extra`, the stream."""
    return [M, F.L, ctypes.addressof(F.mod.p_c), F.mod.n0inv, *extra,
            stream_of(device)]


def _chain_args(F):
    """The one-launch levels' extra C arguments: p - 2's limbs (their
    Fermat chain) and the Montgomery 1's."""
    return ctypes.addressof(F.mod.pm2_c), ctypes.addressof(F.mod.one_c)


def affine_level(F, x1, y1, m1, x2, y2, m2):
    """One total-formula level, its inversion inside: (x3, y3, inf3)."""
    M = _check("affine_level", F, (x1, y1, x2, y2), (m1, m2))
    if not on_card("affine_level", x1.device):
        return affine_level_plain(F, x1, y1, m1, x2, y2, m2)
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    inf3 = torch.empty_like(m1)
    if M:
        lib = load_library()
        check(lib.crypto_affine_level(*_ptrs(x1, y1, m1, x2, y2, m2, x3, y3,
                                             inf3),
                                      *_c_args(F, M, x1.device,
                                               *_chain_args(F))),
              "affine_level")
        affine_level.launches += 1
    return x3, y3, inf3


def affine_level_fast(F, x1, y1, m1, x2, y2, m2):
    """One doubling-free level, its inversion inside: (x3, y3, inf3,
    zero), zero (M,) bool where d == 0 (that lane's x3, y3 are the
    caller's to rerun)."""
    M = _check("affine_level_fast", F, (x1, y1, x2, y2), (m1, m2))
    if not on_card("affine_level_fast", x1.device):
        return affine_level_fast_plain(F, x1, y1, m1, x2, y2, m2)
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    inf3 = torch.empty_like(m1)
    zero = torch.empty(M, dtype=torch.bool, device=x1.device)
    if M:
        lib = load_library()
        check(lib.crypto_affine_level_fast(*_ptrs(x1, y1, m1, x2, y2, m2, x3,
                                                  y3, inf3, zero),
                                           *_c_args(F, M, x1.device,
                                                    *_chain_args(F))),
              "affine_level_fast")
        affine_level_fast.launches += 1
    return x3, y3, inf3, zero


def affine_level_pre_fq2(F, x1, y1, m1, x2, y2, m2):
    """Fq2 level denominators and case masks: (d (2L, M), dbl, inf3)."""
    M = _check("affine_level_pre_fq2", F, (x1, y1, x2, y2), (m1, m2),
               fq2=True)
    if not on_card("affine_level_pre_fq2", x1.device):
        return affine_level_pre_plain(F, x1, y1, m1, x2, y2, m2)
    d = torch.empty_like(x1)
    dbl = torch.empty_like(m1)
    inf3 = torch.empty_like(m1)
    if M:
        lib = load_library()
        check(lib.crypto_affine_pre_fq2(*_ptrs(x1, y1, m1, x2, y2, m2, d,
                                               dbl, inf3),
                                        *_c_args(F, M, x1.device)),
              "affine_level_pre_fq2")
        affine_level_pre_fq2.launches += 1
    return d, dbl, inf3


def affine_level_post_fq2(F, x1, y1, x2, y2, dinv, dbl, m1, m2):
    """The unified Fq2 add/double given dinv: (x3, y3)."""
    M = _check("affine_level_post_fq2", F, (x1, y1, x2, y2, dinv),
               (dbl, m1, m2), fq2=True)
    if not on_card("affine_level_post_fq2", x1.device):
        return affine_level_post_plain(F, x1, y1, x2, y2, dinv, dbl, m1, m2)
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    if M:
        lib = load_library()
        check(lib.crypto_affine_post_fq2(*_ptrs(x1, y1, x2, y2, dinv, dbl,
                                                m1, m2, x3, y3),
                                         *_c_args(F, M, x1.device)),
              "affine_level_post_fq2")
        affine_level_post_fq2.launches += 1
    return x3, y3


def chunked_level_prefix(F, x1, y1, m1, x2, y2, m2):
    """(prefix (L, M), total (L, M/K), dbl, inf3); M a multiple of K."""
    M = _check("chunked_level_prefix", F, (x1, y1, x2, y2), (m1, m2))
    if M % CHUNK_K:
        raise ValueError(f"chunked_level_prefix: M={M} is not a multiple "
                         f"of {CHUNK_K}")
    if not on_card("chunked_level_prefix", x1.device):
        return chunked_level_prefix_plain(F, x1, y1, m1, x2, y2, m2)
    prefix = torch.empty_like(x1)
    total = torch.empty((F.L, M // CHUNK_K), dtype=torch.int32,
                        device=x1.device)
    dbl = torch.empty_like(m1)
    inf3 = torch.empty_like(m1)
    if M:
        lib = load_library()
        check(lib.crypto_chunked_prefix(*_ptrs(x1, y1, m1, x2, y2, m2,
                                               prefix, total, dbl, inf3),
                                        *_c_args(F, M, x1.device)),
              "chunked_level_prefix")
        chunked_level_prefix.launches += 1
    return prefix, total, dbl, inf3


def chunked_level_down(F, x1, y1, m1, x2, y2, m2, prefix, tinv, dbl):
    """(x3, y3) from the inverted chunk totals."""
    M = _check("chunked_level_down", F, (x1, y1, x2, y2, prefix),
               (m1, m2, dbl))
    if M % CHUNK_K:
        raise ValueError(f"chunked_level_down: M={M} is not a multiple "
                         f"of {CHUNK_K}")
    check_limbs("chunked_level_down", F.L, tinv)
    if tinv.shape[1] != M // CHUNK_K or tinv.device != x1.device:
        raise ValueError("chunked_level_down: tinv must be (L, M/K) on the "
                         "coordinates' device")
    if not on_card("chunked_level_down", x1.device):
        return chunked_level_down_plain(F, x1, y1, m1, x2, y2, m2, prefix,
                                        tinv, dbl)
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    if M:
        lib = load_library()
        check(lib.crypto_chunked_down(*_ptrs(x1, y1, m1, x2, y2, m2, prefix,
                                             tinv, dbl, x3, y3),
                                      *_c_args(F, M, x1.device)),
              "chunked_level_down")
        chunked_level_down.launches += 1
    return x3, y3


def chunked_level_prefix_fast(F, x1, y1, m1, x2, y2, m2):
    """(prefix (L, M), total (L, M/K), inf3); a total is 0 where one of
    its thread's pairs collides.  M a multiple of K; y1, y2 not read."""
    M = _check("chunked_level_prefix_fast", F, (x1, y1, x2, y2), (m1, m2))
    if M % CHUNK_K:
        raise ValueError(f"chunked_level_prefix_fast: M={M} is not a "
                         f"multiple of {CHUNK_K}")
    if not on_card("chunked_level_prefix_fast", x1.device):
        return chunked_level_prefix_fast_plain(F, x1, y1, m1, x2, y2, m2)
    prefix = torch.empty_like(x1)
    total = torch.empty((F.L, M // CHUNK_K), dtype=torch.int32,
                        device=x1.device)
    inf3 = torch.empty_like(m1)
    if M:
        lib = load_library()
        check(lib.crypto_chunked_prefix_fast(*_ptrs(x1, m1, x2, m2, prefix,
                                                    total, inf3),
                                             *_c_args(F, M, x1.device)),
              "chunked_level_prefix_fast")
        chunked_level_prefix_fast.launches += 1
    return prefix, total, inf3


def chunked_level_down_fast(F, x1, y1, m1, x2, y2, m2, prefix, tinv):
    """(x3, y3) from the inverted chunk totals, distinct-points formula."""
    M = _check("chunked_level_down_fast", F, (x1, y1, x2, y2, prefix),
               (m1, m2))
    if M % CHUNK_K:
        raise ValueError(f"chunked_level_down_fast: M={M} is not a multiple "
                         f"of {CHUNK_K}")
    check_limbs("chunked_level_down_fast", F.L, tinv)
    if tinv.shape[1] != M // CHUNK_K or tinv.device != x1.device:
        raise ValueError("chunked_level_down_fast: tinv must be (L, M/K) on "
                         "the coordinates' device")
    if not on_card("chunked_level_down_fast", x1.device):
        return chunked_level_down_fast_plain(F, x1, y1, m1, x2, y2, m2,
                                             prefix, tinv)
    x3 = torch.empty_like(x1)
    y3 = torch.empty_like(y1)
    if M:
        lib = load_library()
        check(lib.crypto_chunked_down_fast(*_ptrs(x1, y1, m1, x2, y2, m2,
                                                  prefix, tinv, x3, y3),
                                           *_c_args(F, M, x1.device)),
              "chunked_level_down_fast")
        chunked_level_down_fast.launches += 1
    return x3, y3


for _fn in (affine_level, chunked_level_prefix, chunked_level_down,
            affine_level_fast, chunked_level_prefix_fast,
            chunked_level_down_fast, affine_level_pre_fq2,
            affine_level_post_fq2):
    _fn.launches = 0
