"""Jacobian point kernels on BLS12-381 G1 and BN254 G1: CUDA kernels,
wrappers, plain versions and the factories that batch them over
`TPoints`.

Two TPU kernel factories of `crypto_tpu/ops/pallas/curve_kernels.py`:

* `jacobian_add` / `jacobian_add_mixed` / `jacobian_double` replace
  `_kernels_for` (`call_full_add` / `call_affine_add` / `call_double`),
  `csrc/jacobian.cu`: add-2007-bl with a degenerate flag (P + P is not
  doubled: the flag is set and the caller redoes the batch on a total
  path), mmadd-2007-bl for two affine finite operands, dbl-2009-l.  An
  infinite result is (1, 1, 0) with plain-1 limbs, as in the reference.
* `jacobian_normalize` replaces `_mul_call_for`, the Montgomery-mul kernel
  that `make_normalize_fn` scans over the bits of p - 2,
  `csrc/normalize.cu`: a batch inversion by Montgomery's trick (prefix
  products of each thread's chunk of Z, a product tree over a block's
  chunk totals, one Fermat chain a root, the walk back) fused with
  x·z^-2, y·z^-3 in one launch, Z set to the Montgomery 1 (0 for an
  infinite point).

`make_add_fns(tc)` and `make_normalize_fn(tc)` are the counterparts of
the reference's factories: any batch shape, one launch for the whole
batch (the reference's `lax.map` over fixed blocks bounded its Mosaic
compiles and has no purpose here).  Coordinates are (L, M) limb-major
int32 tensors, L = 12 (BLS12-381 Fq) or 8 (BN254 Fq), the kernel's
instance chosen by L at each C entry point; flags (M,) int32.  Each
wrapper launches its kernel for CUDA tensors (and counts the launch),
takes the plain version for CPU tensors, and raises otherwise; kernel
and plain version agree bit for bit on canonical inputs.
"""

from __future__ import annotations

import ctypes

import torch

from ...curves.tcurve import TCurve, TPoints
from .build import check, load_library
from .field_kernels import (check_kernel_field, check_limbs, mont_mul_plain,
                            on_card, stream_of)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, in tensor ops)
# ---------------------------------------------------------------------------

def _to_infinity(F, mask, x3, y3, z3):
    """(x3, y3, z3) with (1, 1, 0) in plain-1 limbs where `mask`."""
    one = torch.zeros_like(x3)
    one[0] = 1
    return (F.select(mask, one, x3), F.select(mask, one, y3),
            F.select(mask, torch.zeros_like(z3), z3))


def jacobian_add_plain(F, x1, y1, z1, x2, y2, z2):
    def mul(a, b):
        return mont_mul_plain(a, b, F.mod)

    Z1Z1, Z2Z2 = mul(z1, z1), mul(z2, z2)
    U1 = mul(x1, Z2Z2)
    H = F.sub(mul(x2, Z1Z1), U1)
    S1 = mul(mul(y1, z2), Z2Z2)
    r = F.double(F.sub(mul(mul(y2, z1), Z1Z1), S1))
    s = F.add(z1, z2)
    z3 = mul(F.sub(F.sub(mul(s, s), Z1Z1), Z2Z2), H)
    H2 = F.double(H)
    I = mul(H2, H2)
    J, V = mul(H, I), mul(U1, I)
    x3 = F.sub(F.sub(mul(r, r), J), F.double(V))
    y3 = F.sub(mul(r, F.sub(V, x3)), F.double(mul(S1, J)))
    p_inf, q_inf = F.is_zero(z1), F.is_zero(z2)
    h0, r0 = F.is_zero(H), F.is_zero(r)
    both = ~p_inf & ~q_inf
    x3, y3, z3 = _to_infinity(F, h0 & ~r0 & both, x3, y3, z3)
    sel_q = q_inf & ~p_inf
    x3 = F.select(p_inf, x2, F.select(sel_q, x1, x3))
    y3 = F.select(p_inf, y2, F.select(sel_q, y1, y3))
    z3 = F.select(p_inf, z2, F.select(sel_q, z1, z3))
    return x3, y3, z3, (h0 & r0 & both).to(torch.int32)


def jacobian_add_mixed_plain(F, x1, y1, x2, y2):
    def mul(a, b):
        return mont_mul_plain(a, b, F.mod)

    H = F.sub(x2, x1)
    r = F.double(F.sub(y2, y1))
    I = F.double(F.double(mul(H, H)))
    J, V = mul(H, I), mul(x1, I)
    x3 = F.sub(F.sub(mul(r, r), J), F.double(V))
    y3 = F.sub(mul(r, F.sub(V, x3)), F.double(mul(y1, J)))
    z3 = F.double(H)
    h0, r0 = F.is_zero(H), F.is_zero(r)
    x3, y3, z3 = _to_infinity(F, h0 & ~r0, x3, y3, z3)
    return x3, y3, z3, (h0 & r0).to(torch.int32)


def jacobian_double_plain(F, x1, y1, z1):
    def mul(a, b):
        return mont_mul_plain(a, b, F.mod)

    A, B = mul(x1, x1), mul(y1, y1)
    C = mul(B, B)
    t = F.add(x1, B)
    D = F.double(F.sub(F.sub(mul(t, t), A), C))
    E = F.add(F.double(A), A)
    x3 = F.sub(mul(E, E), F.double(D))
    y3 = F.sub(mul(E, F.sub(D, x3)), F.double(F.double(F.double(C))))
    z3 = F.double(mul(y1, z1))
    return _to_infinity(F, F.is_zero(y1) | F.is_zero(z1), x3, y3, z3)


def _inverse_plain(F, z):
    """Canonical Montgomery inverses of an (L, M) batch, 0 for 0.  The
    batch trick over the whole batch (a product tree, one Fermat chain at
    its root, the walk back), where the kernel cuts its tree at threads'
    chunks and blocks: an inverse is unique, so the two agree bit for
    bit."""
    def mul(a, b):
        return mont_mul_plain(a, b, F.mod)

    zero = F.is_zero(z).unsqueeze(0)
    cur = torch.where(zero, F.r_mont.view(-1, 1), z)
    levels = []
    while cur.shape[1] > 1:
        if cur.shape[1] % 2:
            cur = torch.cat([cur, F.r_mont.view(-1, 1)], dim=1)
        levels.append(cur)
        h = cur.shape[1] // 2
        cur = mul(cur[:, :h], cur[:, h:])
    inv = cur
    for bit in bin(F.p - 2)[3:]:
        inv = mul(inv, inv)
        if bit == "1":
            inv = mul(inv, cur)
    for lev in reversed(levels):
        h = lev.shape[1] // 2
        inv = inv[:, :h]
        inv = torch.cat([mul(inv, lev[:, h:]), mul(inv, lev[:, :h])], dim=1)
    return torch.where(zero, 0, inv[:, :z.shape[1]])


def jacobian_normalize_plain(F, x, y, z):
    def mul(a, b):
        return mont_mul_plain(a, b, F.mod)

    zinv = _inverse_plain(F, z)
    inv2 = mul(zinv, zinv)
    xo = mul(x, inv2)
    yo = mul(y, mul(inv2, zinv))
    one = F.r_mont.view(-1, 1).expand_as(z)
    return xo, yo, torch.where(F.is_zero(z).unsqueeze(0), 0, one)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

# csrc/normalize.cu's T and CHUNK: threads a block, points a thread (one
# Fermat chain a block)
NORMALIZE_THREADS, NORMALIZE_CHUNK = 128, 16


def _check(name, F, coords):
    check_kernel_field(name, F.mod)
    return check_limbs(name, F.L, *coords)


def _launch(wrapper, cname, F, ins, n_out, flag, *extra):
    """Allocate n_out coordinate outputs (and a flag), launch the library's
    `cname` over M = ins[0].shape[1] points, count it on `wrapper`."""
    M = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    if flag:
        outs.append(torch.empty(M, dtype=torch.int32, device=ins[0].device))
    if M:
        err = getattr(load_library(), cname)(
            *(t.data_ptr() for t in (*ins, *outs)), M, F.L,
            ctypes.addressof(F.mod.p_c), F.mod.n0inv, *extra,
            stream_of(ins[0].device))
        check(err, wrapper.__name__)
        wrapper.launches += 1
    return tuple(outs)


def jacobian_add(F, x1, y1, z1, x2, y2, z2):
    """add-2007-bl: (x3, y3, z3, flag), flag set where P + P was asked."""
    ins = (x1, y1, z1, x2, y2, z2)
    _check("jacobian_add", F, ins)
    if not on_card("jacobian_add", x1.device):
        return jacobian_add_plain(F, *ins)
    return _launch(jacobian_add, "crypto_jac_add", F, ins, 3, True)


def jacobian_add_mixed(F, x1, y1, x2, y2):
    """mmadd-2007-bl of two affine finite operands: (x3, y3, z3, flag)."""
    ins = (x1, y1, x2, y2)
    _check("jacobian_add_mixed", F, ins)
    if not on_card("jacobian_add_mixed", x1.device):
        return jacobian_add_mixed_plain(F, *ins)
    return _launch(jacobian_add_mixed, "crypto_jac_add_mixed", F, ins, 3,
                   True)


def jacobian_double(F, x1, y1, z1):
    """dbl-2009-l, total: (x3, y3, z3)."""
    ins = (x1, y1, z1)
    _check("jacobian_double", F, ins)
    if not on_card("jacobian_double", x1.device):
        return jacobian_double_plain(F, *ins)
    return _launch(jacobian_double, "crypto_jac_double", F, ins, 3, False)


def jacobian_normalize(F, x, y, z):
    """Jacobian -> affine: (x·z^-2, y·z^-3, Montgomery 1 or 0)."""
    ins = (x, y, z)
    _check("jacobian_normalize", F, ins)
    if not on_card("jacobian_normalize", x.device):
        return jacobian_normalize_plain(F, *ins)
    return _launch(jacobian_normalize, "crypto_normalize", F, ins, 3,
                   False, ctypes.addressof(F.mod.pm2_c),
                   ctypes.addressof(F.mod.one_c))


for _fn in (jacobian_add, jacobian_add_mixed, jacobian_double,
            jacobian_normalize):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# batch factories over TPoints
# ---------------------------------------------------------------------------

def _flat(F, *pts: TPoints):
    return [t.reshape(F.L, -1).contiguous() for P in pts for t in P]


def _shaped(shape, outs) -> TPoints:
    return TPoints(*(t.reshape(shape) for t in outs))


def _any(flag: torch.Tensor) -> torch.Tensor:
    """The batch's flag as a 0-dim int32 tensor (0 for an empty batch)."""
    return flag.max() if flag.numel() else flag.new_zeros(())


def make_add_fns(tc: TCurve):
    """(add_fn, affine_add_fn, double_fn) over `TPoints` batches of any
    shape: add_fn(A, B) and affine_add_fn(A, B) -> (TPoints, flag), the
    flag a 0-dim int32 tensor, nonzero when some pair was P + P;
    double_fn(P) -> TPoints.  affine_add_fn takes both operands affine
    and finite and ignores their Z."""
    F = tc.F

    def add_fn(A: TPoints, B: TPoints):
        *xyz, flag = jacobian_add(F, *_flat(F, A, B))
        return _shaped(A.X.shape, xyz), _any(flag)

    def affine_add_fn(A: TPoints, B: TPoints):
        xy = [t.reshape(F.L, -1).contiguous() for t in (A.X, A.Y, B.X, B.Y)]
        *xyz, flag = jacobian_add_mixed(F, *xy)
        return _shaped(A.X.shape, xyz), _any(flag)

    def double_fn(P: TPoints) -> TPoints:
        return _shaped(P.X.shape, jacobian_double(F, *_flat(F, P)))

    return add_fn, affine_add_fn, double_fn


def make_normalize_fn(tc: TCurve):
    """Batched Jacobian -> affine `TPoints` (Z the Montgomery 1, or 0 for
    an infinite point), any batch shape, one kernel launch."""
    F = tc.F

    def norm(P: TPoints) -> TPoints:
        return _shaped(P.X.shape, jacobian_normalize(F, *_flat(F, P)))

    return norm
