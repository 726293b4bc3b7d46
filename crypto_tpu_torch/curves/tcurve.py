"""Batched short-Weierstrass point arithmetic on tensors (Jacobian, a = 0).

Counterpart of `crypto_tpu/curves/jcurve.py`, generic over the
coefficient field: G1 over Fq (`fields/tfield.py`, `(L, ...)` limb
tensors) and G2 over Fq2 (`fields/ttower.py`, `(2L, ...)`), of BLS12-381
(L = 12) and BN254 (L = 8).  A batch
of points is `TPoints(X, Y, Z)` with each coordinate a Montgomery limb
tensor; Z == 0 encodes infinity, and `infinity()` is (1, 1, 0).  Every op
is branch-free (select-based), total (doubling, P + (-P), infinity
operands), uses only the field protocol and works on any batch shape.
Field muls run through the mont_mul kernel (G1) or the Fq2 mul kernel
(G2) on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..fields.host import Field
from ..fields.tfield import tfield_for
from ..fields.tower import QuadExtField
from ..fields.ttower import tquad_for
from .sw import Point, SWCurve


def _device_field_for(K, device):
    """Device field context for a host coefficient field (Fq or Fq2)."""
    if isinstance(K, Field):
        return tfield_for(K, device)
    if isinstance(K, QuadExtField):
        return tquad_for(K, device)
    raise TypeError(f"no device field for coefficient field {K!r}")


class TPoints(NamedTuple):
    """Batch of Jacobian points as limb tensors."""
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor


class TAffine(NamedTuple):
    """Batch of affine points; `inf` is a boolean mask."""
    X: torch.Tensor
    Y: torch.Tensor
    inf: torch.Tensor


class TCurve:
    def __init__(self, curve: SWCurve, device="cuda"):
        if not curve.a.is_zero():
            raise ValueError("the formulas assume a == 0")
        self.curve = curve
        self.F = _device_field_for(curve.K, device)

    # ------------------------------------------------------------------
    # constructors / conversion
    # ------------------------------------------------------------------

    def infinity(self, shape=()) -> TPoints:
        one = self.F.ones(shape)
        return TPoints(one, one, self.F.zeros(shape))

    def pack_points(self, points) -> TPoints:
        """Host points -> device Jacobian batch (normalized to Z = 1 / 0)."""
        K = self.curve.K
        xs, ys, zs = [], [], []
        for p in points:
            if p.is_infinity():
                xs.append(K.one())
                ys.append(K.one())
                zs.append(K.zero())
            else:
                x, y = p.to_affine()
                xs.append(x)
                ys.append(y)
                zs.append(K.one())
        F = self.F
        return TPoints(F.pack(xs), F.pack(ys), F.pack(zs))

    def unpack(self, pts: TPoints) -> list:
        """Device batch -> host points (flattened)."""
        F = self.F
        xs, ys, zs = (np.atleast_1d(F.unpack_host(t)).reshape(-1)
                      for t in pts)
        return [self.curve.infinity() if z.is_zero()
                else Point(x, y, z, self.curve) for x, y, z in zip(xs, ys, zs)]

    # ------------------------------------------------------------------
    # predicates
    # ------------------------------------------------------------------

    def is_infinity(self, p: TPoints) -> torch.Tensor:
        return self.F.is_zero(p.Z)

    def select(self, mask: torch.Tensor, a: TPoints, b: TPoints) -> TPoints:
        F = self.F
        return TPoints(F.select(mask, a.X, b.X), F.select(mask, a.Y, b.Y),
                       F.select(mask, a.Z, b.Z))

    def eq(self, p: TPoints, q: TPoints) -> torch.Tensor:
        """Batched equality across different Z: X1 Z2^2 = X2 Z1^2 and Y1
        Z2^3 = Y2 Z1^3, or both at infinity."""
        F = self.F
        z1z1 = F.square(p.Z)
        z2z2 = F.square(q.Z)
        x_eq = F.eq(F.mul(p.X, z2z2), F.mul(q.X, z1z1))
        y_eq = F.eq(F.mul(F.mul(p.Y, z2z2), q.Z),
                    F.mul(F.mul(q.Y, z1z1), p.Z))
        p_inf, q_inf = self.is_infinity(p), self.is_infinity(q)
        return torch.where(p_inf | q_inf, p_inf & q_inf, x_eq & y_eq)

    def neg(self, p: TPoints) -> TPoints:
        return TPoints(p.X, self.F.neg(p.Y), p.Z)

    # ------------------------------------------------------------------
    # group law (branch-free, total)
    # ------------------------------------------------------------------

    def double(self, p: TPoints) -> TPoints:
        """dbl-2009-l (a = 0); Y = 0 or infinity gives infinity."""
        F = self.F
        A = F.square(p.X)
        B = F.square(p.Y)
        C = F.square(B)
        D = F.double(F.sub(F.sub(F.square(F.add(p.X, B)), A), C))
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.square(E), F.double(D))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.double(F.double(F.double(C))))
        Z3 = F.double(F.mul(p.Y, p.Z))
        bad = F.is_zero(p.Y) | self.is_infinity(p)
        return self.select(bad, self.infinity(bad.shape), TPoints(X3, Y3, Z3))

    def add(self, p: TPoints, q: TPoints) -> TPoints:
        """add-2007-bl with every case handled by selects."""
        F = self.F
        Z1Z1 = F.square(p.Z)
        Z2Z2 = F.square(q.Z)
        U1 = F.mul(p.X, Z2Z2)
        U2 = F.mul(q.X, Z1Z1)
        S1 = F.mul(F.mul(p.Y, q.Z), Z2Z2)
        S2 = F.mul(F.mul(q.Y, p.Z), Z1Z1)
        H = F.sub(U2, U1)
        r = F.double(F.sub(S2, S1))
        h_zero = F.is_zero(H)
        r_zero = F.is_zero(r)
        I = F.square(F.double(H))
        J = F.mul(H, I)
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.square(r), J), F.double(V))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(S1, J)))
        Z3 = F.mul(F.sub(F.sub(F.square(F.add(p.Z, q.Z)), Z1Z1), Z2Z2), H)
        res = TPoints(X3, Y3, Z3)
        p_inf = self.is_infinity(p)
        q_inf = self.is_infinity(q)
        live = ~p_inf & ~q_inf
        res = self.select(h_zero & r_zero & live, self.double(p), res)
        res = self.select(h_zero & ~r_zero & live,
                          self.infinity(h_zero.shape), res)
        res = self.select(p_inf, q, res)
        return self.select(q_inf & ~p_inf, p, res)

    def scalar_mul(self, p: TPoints, bits: torch.Tensor) -> TPoints:
        """Batched double-and-add (`JCurve.scalar_mul`, `jcurve.py:236`):
        from infinity, each step runs `double`, then `add(acc, p)`, and
        keeps the sum where the step's bit is set.  `bits` is an
        (nbits, ...) integer tensor of 0/1, MSB first: row k is step k and
        is shaped like the batch of `p` (step axis first, as the limbs
        are in the port's limb-major layout; the reference takes
        (..., nbits)).  Total: runs on the select-based `double` and
        `add`, so P + P, infinite bases and zero rows are handled."""
        acc = self.infinity(p.Z.shape[1:])
        for row in bits:
            acc = self.double(acc)
            acc = self.select(row > 0, self.add(acc, p), acc)
        return acc

    # ------------------------------------------------------------------
    # batch utilities
    # ------------------------------------------------------------------

    def unpack_affine(self, pts: TPoints) -> list:
        """Device points as host points with Z = 1 (infinity as infinity):
        the normalisation on the device (`to_affine`, one batched Fermat
        inversion), then one unpack of x and y.  The same points as the
        host `normalize` of each."""
        a = self.to_affine(pts)
        xs, ys = (np.atleast_1d(self.F.unpack_host(t)).reshape(-1)
                  for t in (a.X, a.Y))
        inf = a.inf.reshape(-1).tolist()
        one = self.curve.K.one()
        return [self.curve.infinity() if i else Point(x, y, one, self.curve)
                for x, y, i in zip(xs, ys, inf)]

    def to_affine(self, p: TPoints) -> TAffine:
        """Normalization by batched Fermat inversion (infinity keeps
        x = y = 0 and inf set)."""
        F = self.F
        zinv = F.inv(p.Z)
        zinv2 = F.square(zinv)
        return TAffine(F.mul(p.X, zinv2), F.mul(p.Y, F.mul(zinv2, zinv)),
                       self.is_infinity(p))


_CACHE: dict = {}


def tcurve_for(curve: SWCurve, device="cuda") -> TCurve:
    """The curve's context on `device` (CUDA unless the caller names the
    CPU; raises without a card)."""
    dev = resolve_device(device)
    key = (curve.name, str(dev))
    if key not in _CACHE:
        _CACHE[key] = TCurve(curve, dev)
    return _CACHE[key]
