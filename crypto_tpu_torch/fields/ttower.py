"""Batched extension-field towers on tensors: the port's `jtower.py`.

Counterparts of `crypto_tpu/fields/jtower.py` `JQuadField`,
`JCubicField` and `JQuadOverCubicField` for the towers of BLS12-381 and
BN254:

    Fq2  = Fq [u] / (u^2 + 1)      (2L, ...) rows: c0's L limbs, then c1's
    Fq6  = Fq2[v] / (v^3 - xi)     (6L, ...) rows: c0, c1, c2, each an Fq2
    Fq12 = Fq6[w] / (w^2 - v)      (12L, ...) rows: c0, c1, each an Fq6

with beta = -1 and xi = k + u for a small k (asserted): u + 1 for
BLS12-381 (L = 12), 9 + u for BN254 (L = 8).  Limb-major
rows are the Fq2 kernels' own layout (`Fq2Ctx`), so a batch of Fq2
coordinates goes to the kernels without a transpose.  `U` is the rows per
element (`TField.U = L`), which the MSM reads for every layout.

Fq2 `mul` goes through the Fq2 mul kernel and `square` through the Fq2
square kernel, the reference's complex squaring
(`ops/kernels/field_kernels.fq2_mul` / `fq2_sqr`); `inv` takes the norm
and one base-field Fermat inversion (the mont_mul and mont_pow kernels).
`add`, `sub` and `neg` of every tower level run as one base-field op over
an `(L, k, ...)` view of all k base coordinates, so they cost what one
base-field op costs.

Fq6 and Fq12 ops stack their independent Fq2 products along a batch axis
and run them as one `fq2_mul` launch (Fq6 Karatsuba's 6 products, an Fq12
product's 18), and their squares as one `fq2_sqr` launch; the reference
runs them as separate calls.  Every op is exact, so either form gives the
same canonical values.  Multiplying by xi = u + 1 is two base-field adds,
by 9 + u a short chain of them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.kernels.field_kernels import (fq2_mul, fq2_mul_plain, fq2_sqr,
                                         fq2_sqr_plain)
from .tfield import tfield_for
from .tower import CubicOverQuad, Fp2, Fp6, Fp12, QuadExtField, \
    QuadOverCubic


class TQuadField:
    """Device Fq2 context bound to a host `QuadExtField` and a device."""

    def __init__(self, host: QuadExtField, device="cuda"):
        if int(host.beta) != host.base.p - 1:
            raise ValueError("TQuadField assumes beta == -1 (u^2 = -1)")
        self.host = host
        self.base = tfield_for(host.base, device)
        self.device = self.base.device
        self.mod = self.base.mod
        self.L = self.base.L
        self.U = 2 * self.L

    def _pair(self, a: torch.Tensor) -> torch.Tensor:
        """(2L, ...) -> (L, 2, ...) view: both components as one base
        batch."""
        return a.unflatten(0, (2, self.L)).transpose(0, 1)

    def _unpair(self, t: torch.Tensor) -> torch.Tensor:
        return t.transpose(0, 1).reshape((self.U,) + t.shape[2:])

    # ------------------------------------------------------------------
    # host <-> device conversion
    # ------------------------------------------------------------------

    def pack(self, values, mont: bool = True) -> torch.Tensor:
        """Host Fp2 elements or ints (c1 = 0), nested lists ok -> (2L, ...)
        int32 tensor, in Montgomery form by default."""
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        c0 = [int(v.c0) if isinstance(v, Fp2) else int(v) for v in flat]
        c1 = [int(v.c1) if isinstance(v, Fp2) else 0 for v in flat]
        t = torch.cat([self.base.pack(c0, mont), self.base.pack(c1, mont)])
        return t.reshape((self.U,) + arr.shape)

    def unpack(self, limbs: torch.Tensor, mont: bool = True):
        """(2L, ...) tensor -> object array of (c0, c1) int pairs (a bare
        pair for a single element)."""
        c0, c1 = (np.asarray(self.base.unpack(h, mont), dtype=object)
                  for h in (limbs[:self.L], limbs[self.L:]))
        out = np.empty(c0.size, dtype=object)
        for i, pair in enumerate(zip(c0.reshape(-1), c1.reshape(-1))):
            out[i] = (int(pair[0]), int(pair[1]))
        return out.reshape(c0.shape) if c0.shape else out[0]

    def unpack_host(self, limbs: torch.Tensor):
        """(2L, ...) tensor -> host Fp2 elements (object array)."""
        pairs = self.unpack(limbs)
        if isinstance(pairs, tuple):
            return self.host(*pairs)
        out = np.empty(pairs.size, dtype=object)
        for i, pair in enumerate(pairs.reshape(-1)):
            out[i] = self.host(*pair)
        return out.reshape(pairs.shape)

    # ------------------------------------------------------------------
    # field ops (Montgomery domain)
    # ------------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._unpair(self.base.add(self._pair(a), self._pair(b)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._unpair(self.base.sub(self._pair(a), self._pair(b)))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._unpair(self.base.neg(self._pair(a)))

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Karatsuba product through the Fq2 mul kernel."""
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        out = fq2_mul(self.base, a.reshape(self.U, -1).contiguous(),
                      b.reshape(self.U, -1).contiguous())
        return out.reshape(shape)

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """What `mul` computes on (2L, M) batches, in plain tensor ops on
        any device (the kernels' plain versions use it)."""
        return fq2_mul_plain(self.base, a, b)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        """Complex square (two base products) through the Fq2 square
        kernel."""
        shape = a.shape
        return fq2_sqr(self.base, a.reshape(self.U, -1).contiguous()
                       ).reshape(shape)

    def square_plain(self, a: torch.Tensor) -> torch.Tensor:
        """What `square` computes on (2L, M) batches, in plain tensor ops."""
        return fq2_sqr_plain(self.base, a)

    def mul_base(self, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """a * s with s a base-field batch (L, ...)."""
        return self._unpair(self.base.mul(self._pair(a), s.unsqueeze(1)))

    def conjugate(self, a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a[:self.L], self.base.neg(a[self.L:])])

    def mul_beta(self, a: torch.Tensor) -> torch.Tensor:
        """A base-field batch (L, ...) times beta = -1."""
        return self.base.neg(a)

    def frobenius(self, a: torch.Tensor, power: int = 1) -> torch.Tensor:
        """a^(p^power): the conjugate for odd powers."""
        return self.conjugate(a) if power % 2 else a

    def from_base(self, c0: torch.Tensor) -> torch.Tensor:
        """A base-field batch (L, ...) as Fq2 elements (c1 = 0)."""
        return torch.cat([c0, torch.zeros_like(c0)])

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2): the norm, then one
        base-field Fermat inversion; 0 maps to 0."""
        sq = self.base.mul(self._pair(a), self._pair(a))
        norm = self.base.add(sq[:, 0], sq[:, 1])
        return self.conjugate(self.mul_base(a, self.base.inv(norm)))

    # ------------------------------------------------------------------
    # predicates / constants
    # ------------------------------------------------------------------

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
        """where(mask, a, b), mask shaped like the batch."""
        return torch.where(mask.unsqueeze(0), a, b)

    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros((self.U,) + tuple(shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, shape=()) -> torch.Tensor:
        """Montgomery one (c0 = R mod p, c1 = 0), materialised."""
        shape = tuple(shape)
        r = self.base.r_mont
        one = torch.cat([r, torch.zeros_like(r)])
        return one.view((self.U,) + (1,) * len(shape)).expand(
            (self.U,) + shape).contiguous()


def stack(*ts: torch.Tensor) -> torch.Tensor:
    """Elements of one field (rows first, batch shapes broadcast) stacked
    along a new batch axis 1: the operand of one batched op."""
    return torch.stack(torch.broadcast_tensors(*ts), 1)


def _on_base(F, op, *xs: torch.Tensor) -> torch.Tensor:
    """`op`, a base-field op, over every base coordinate of tower elements
    (kL, ...) at once, through (L, k, ...) views."""
    ys = [x.unflatten(0, (-1, F.L)).transpose(0, 1) for x in xs]
    return op(*ys).transpose(0, 1).flatten(0, 1)


def _pack_coords(sub, values, names, U: int) -> torch.Tensor:
    """Host tower elements (nested lists ok) -> (U, ...): each coordinate
    `names[i]` packed by the sub-field context `sub`, row blocks in
    order."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    t = torch.cat([sub.pack([getattr(v, c) for v in flat]) for c in names])
    return t.reshape((U,) + arr.shape)


def _unpack_coords(sub, limbs: torch.Tensor, k: int, make):
    """(U, ...) tensor -> object array of make(k sub-field values) (a bare
    value for a single element)."""
    parts = [np.asarray(sub.unpack_host(c), dtype=object)
             for c in limbs.chunk(k)]
    out = np.empty(parts[0].size, dtype=object)
    for i, cs in enumerate(zip(*(p.reshape(-1) for p in parts))):
        out[i] = make(*cs)
    return out.reshape(parts[0].shape) if parts[0].shape else out[0]


XI_MAX = 16        # the largest k of xi = k + u that mul_xi takes


class TCubicField:
    """Fq6 = Fq2[v]/(v^3 - xi), xi = k + u (u + 1 or 9 + u), as (6L, ...)
    tensors: c0's 2L rows, then c1's, then c2's (`JCubicField`)."""

    def __init__(self, host: CubicOverQuad, device="cuda"):
        k = int(host.xi.c0)
        if int(host.xi.c1) != 1 or not 1 <= k <= XI_MAX:
            raise ValueError(f"TCubicField assumes xi == k + u with 1 <= k "
                             f"<= {XI_MAX}")
        self.xi_k = k
        self.host = host
        self.fq2 = tquad_for(host.fq2, device)
        self.base = self.fq2.base
        self.device = self.fq2.device
        self.L = self.fq2.L
        self.U = 6 * self.L
        # v^(p^i) = frob_c1[i] v and (v^2)^(p^i) = frob_c2[i] v^2, i < 6:
        # (2L, 2, 6), the two coefficients of each power side by side
        self.frob = self.fq2.pack([host.frob_c1, host.frob_c2])

    def coords(self, a: torch.Tensor) -> torch.Tensor:
        """(6L, ...) -> its Fq2 coordinates, a (2L, 3, ...) view."""
        return a.unflatten(0, (3, self.fq2.U)).movedim(0, 1)

    def join(self, c: torch.Tensor) -> torch.Tensor:
        """(2L, 3, ...) Fq2 coordinates -> the (6L, ...) element."""
        return c.movedim(1, 0).flatten(0, 1)

    # ------------------------------------------------------------------
    # host <-> device conversion
    # ------------------------------------------------------------------

    def pack(self, values) -> torch.Tensor:
        """Host Fp6 elements (nested lists ok) -> (6L, ...) tensor."""
        return _pack_coords(self.fq2, values, ("c0", "c1", "c2"), self.U)

    def unpack_host(self, limbs: torch.Tensor):
        """(6L, ...) tensor -> host Fp6 elements (object array)."""
        return _unpack_coords(self.fq2, limbs, 3,
                              lambda *cs: Fp6(*cs, self.host))

    # ------------------------------------------------------------------
    # field ops (Montgomery domain)
    # ------------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.add, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.sub, a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.neg, a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul_xi(self, c: torch.Tensor) -> torch.Tensor:
        """An Fq2 batch (2L, ...) times xi = k + u: (k c0 - c1) + (c0 + k
        c1) u.  For u + 1, two base-field adds; else k (c0, c1) first, by
        doublings and adds over both components at once (9 (c0, c1) is
        three doublings and an add)."""
        F, L = self.base, self.L
        kc = c
        if self.xi_k > 1:
            for bit in bin(self.xi_k)[3:]:
                kc = self.fq2.double(kc)
                if bit == "1":
                    kc = self.fq2.add(kc, c)
        return torch.cat([F.sub(kc[:L], c[L:]), F.add(c[:L], kc[L:])])

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Karatsuba over Fq2 (host `Fp6.__mul__`): the six products v0,
        v1, v2, (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2) in one
        `fq2_mul` launch."""
        F2 = self.fq2
        ca, cb = (self.coords(x) for x in torch.broadcast_tensors(a, b))
        i, j = [1, 0, 0], [2, 1, 2]
        ab = torch.stack([ca, cb], 1)
        s = F2.add(ab[:, :, i], ab[:, :, j])
        v = F2.mul(torch.cat([ca, s[:, 0]], 1), torch.cat([cb, s[:, 1]], 1))
        # t0 - v1 - v2, t1 - v0 - v1, t2 - v0 - v2
        d = F2.sub(F2.sub(v[:, 3:], v[:, i]), v[:, j])
        x = self.mul_xi(stack(d[:, 0], v[:, 2]))
        return self.join(F2.add(stack(v[:, 0], d[:, 1], d[:, 2]),
                                stack(x[:, 0], x[:, 1], v[:, 1])))

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_by_v(self, a: torch.Tensor) -> torch.Tensor:
        """a * v: (c0, c1, c2) -> (xi c2, c0, c1)."""
        c = self.coords(a)
        return self.join(stack(self.mul_xi(c[:, 2]), c[:, 0], c[:, 1]))

    def mul_fq2(self, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """a * s with s an Fq2 batch (2L, ...)."""
        return self.join(self.fq2.mul(self.coords(a), s.unsqueeze(1)))

    def frobenius(self, a: torch.Tensor, power: int = 1) -> torch.Tensor:
        """a^(p^power): each coordinate's Frobenius, c1 and c2 times their
        coefficients (one `fq2_mul` launch)."""
        c = self.fq2.frobenius(self.coords(a), power)
        k = self.frob[:, :, power % 6]
        k = k.view(k.shape + (1,) * (c.dim() - 2))
        return self.join(torch.cat([c[:, :1], self.fq2.mul(c[:, 1:], k)], 1))

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Cubic-extension inversion (host `Fp6.inverse`); 0 maps to 0."""
        F2 = self.fq2
        c = self.coords(a)
        a0, a1, a2 = c.unbind(1)
        sq = F2.square(stack(a0, a2, a1))                  # a0^2 a2^2 a1^2
        pr = F2.mul(stack(a1, a0, a0), stack(a2, a1, a2))  # a1a2 a0a1 a0a2
        x = self.mul_xi(stack(pr[:, 0], sq[:, 1]))
        t = F2.sub(stack(sq[:, 0], x[:, 1], sq[:, 2]),
                   stack(x[:, 0], pr[:, 1], pr[:, 2]))     # t0 t1 t2
        p = F2.mul(stack(a0, a2, a1), t)                   # a0t0 a2t1 a1t2
        d = F2.add(p[:, 0], self.mul_xi(F2.add(p[:, 1], p[:, 2])))
        return self.join(F2.mul(t, F2.inv(d).unsqueeze(1)))

    # ------------------------------------------------------------------
    # constants
    # ------------------------------------------------------------------

    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros((self.U,) + tuple(shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, shape=()) -> torch.Tensor:
        """Montgomery one (c0 = 1, c1 = c2 = 0), materialised."""
        out = self.zeros(shape)
        out[:self.fq2.U] = self.fq2.ones(shape)
        return out


class TQuadOverCubicField:
    """Fq12 = Fq6[w]/(w^2 - v) as (12L, ...) tensors: c0's 6L rows, then
    c1's (`JQuadOverCubicField`)."""

    def __init__(self, host: QuadOverCubic, device="cuda"):
        self.host = host
        self.fq6 = tcubic_for(host.fq6, device)
        self.fq2 = self.fq6.fq2
        self.base = self.fq2.base
        self.device = self.fq2.device
        self.L = self.fq2.L
        self.U = 12 * self.L
        # the Frobenius coefficients of the five Fq2 coordinates other
        # than c0.c0, power by power (i < 12): c0.c1 and c0.c2 take Fq6's,
        # c1's three take w's (host `frob_c1`) times Fq6's (1, c1, c2)
        rows = []
        for i in range(12):
            g, k1, k2 = host.frob_c1[i], host.fq6.frob_c1[i % 6], \
                host.fq6.frob_c2[i % 6]
            rows.append([k1, k2, g, k1 * g, k2 * g])
        self.frob = self.fq2.pack(rows).permute(0, 2, 1).contiguous()

    def coords(self, a: torch.Tensor) -> torch.Tensor:
        """(12L, ...) -> its Fq6 coordinates, a (6L, 2, ...) view."""
        return a.unflatten(0, (2, self.fq6.U)).movedim(0, 1)

    def join(self, c: torch.Tensor) -> torch.Tensor:
        """(6L, 2, ...) Fq6 coordinates -> the (12L, ...) element."""
        return c.movedim(1, 0).flatten(0, 1)

    def coords2(self, a: torch.Tensor) -> torch.Tensor:
        """(12L, ...) -> its six Fq2 coordinates in row order, c0's three
        then c1's, as a (2L, 6, ...) view."""
        return a.unflatten(0, (6, self.fq2.U)).movedim(0, 1)

    # ------------------------------------------------------------------
    # host <-> device conversion
    # ------------------------------------------------------------------

    def pack(self, values) -> torch.Tensor:
        """Host Fp12 elements (nested lists ok) -> (12L, ...) tensor."""
        return _pack_coords(self.fq6, values, ("c0", "c1"), self.U)

    def unpack_host(self, limbs: torch.Tensor):
        """(12L, ...) tensor -> host Fp12 elements (object array)."""
        return _unpack_coords(self.fq6, limbs, 2,
                              lambda *cs: Fp12(*cs, self.host))

    # ------------------------------------------------------------------
    # field ops (Montgomery domain)
    # ------------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.add, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.sub, a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _on_base(self.base, self.base.neg, a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Karatsuba over Fq6 (host `Fp12.__mul__`): v0 = a0 b0, v1 = a1 b1
        and (a0+a1)(b0+b1) as one stacked Fq6 product (18 Fq2 products,
        one `fq2_mul` launch)."""
        F6 = self.fq6
        ca, cb = (self.coords(x) for x in torch.broadcast_tensors(a, b))
        s = F6.add(stack(ca[:, 0], cb[:, 0]), stack(ca[:, 1], cb[:, 1]))
        v = F6.mul(stack(ca[:, 0], ca[:, 1], s[:, 0]),
                   stack(cb[:, 0], cb[:, 1], s[:, 1]))
        u = F6.add(stack(v[:, 0], v[:, 0]),
                   stack(F6.mul_by_v(v[:, 1]), v[:, 1]))   # c0, v0 + v1
        return self.join(stack(u[:, 0], F6.sub(v[:, 2], u[:, 1])))

    def square(self, a: torch.Tensor) -> torch.Tensor:
        """(a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w (host
        `Fp12.square`): a0 a1 and (a0 + a1)(a0 + v a1) as one stacked Fq6
        product."""
        F6 = self.fq6
        c = self.coords(a)
        a0, a1 = c[:, 0], c[:, 1]
        s = F6.add(stack(a0, a0), stack(a1, F6.mul_by_v(a1)))
        v = F6.mul(stack(a0, s[:, 0]), stack(a1, s[:, 1]))  # v0, t
        u = F6.add(stack(v[:, 0], v[:, 0]),
                   stack(F6.mul_by_v(v[:, 0]), v[:, 0]))    # v0 + v v0, 2 v0
        return self.join(stack(F6.sub(v[:, 1], u[:, 0]), u[:, 1]))

    def conjugate(self, a: torch.Tensor) -> torch.Tensor:
        """a0 - a1 w: the unitary inverse of a cyclotomic element."""
        h = self.fq6.U
        return torch.cat([a[:h], self.fq6.neg(a[h:])])

    def frobenius(self, a: torch.Tensor, power: int = 1) -> torch.Tensor:
        """a^(p^power): every Fq2 coordinate's Frobenius, the five other
        than c0.c0 times their coefficients in one `fq2_mul` launch (host
        `Fp12.frobenius`, whose c1 products by Fq6's and w's coefficients
        are folded into one coefficient each)."""
        c = self.fq2.frobenius(self.coords2(a), power)
        k = self.frob[:, :, power % 12]
        k = k.view(k.shape + (1,) * (c.dim() - 2))
        out = torch.cat([c[:, :1], self.fq2.mul(c[:, 1:], k)], 1)
        return out.movedim(1, 0).flatten(0, 1)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """1/(a0 + a1 w) = (a0 - a1 w)/(a0^2 - v a1^2); 0 maps to 0."""
        F6 = self.fq6
        c = self.coords(a)
        sq = F6.mul(c, c)                                  # a0^2, a1^2
        norm = F6.sub(sq[:, 0], F6.mul_by_v(sq[:, 1]))
        out = F6.mul(c, F6.inv(norm).unsqueeze(1))
        return self.join(stack(out[:, 0], F6.neg(out[:, 1])))

    def cyclotomic_square(self, a: torch.Tensor) -> torch.Tensor:
        """Granger-Scott squaring of cyclotomic elements (host
        `Fp12.cyclotomic_square`): Fq12 as a cube of Fq4 = Fq2[y]/(y^2 -
        xi) over the pairs (z0, z1), (z2, z3), (z4, z5), with c0 = (z0, z4,
        z3) and c1 = (z2, z1, z5).  Each Fq4 square (x + y y)^2 is (x^2 +
        xi y^2) + ((x + y)^2 - x^2 - y^2) y: the nine Fq2 squares in one
        `fq2_sqr` launch (the host's two products each give the same
        values)."""
        F2, mul_xi = self.fq2, self.fq6.mul_xi
        z = self.coords2(a)                   # z0 z4 z3 z2 z1 z5
        x, y = z[:, [0, 3, 1]], z[:, [4, 2, 5]]   # (z0, z2, z4), (z1, z3, z5)
        sq = F2.square(torch.cat([x, y, F2.add(x, y)], 1))
        A, B, C = sq[:, :3], sq[:, 3:6], sq[:, 6:]
        ab = F2.add(torch.cat([A, A], 1), torch.cat([mul_xi(B), B], 1))
        re, im = ab[:, :3], F2.sub(C, ab[:, 3:])          # t0 t2 t4, t1 t3 t5
        tp = torch.cat([mul_xi(im[:, 2:]), im[:, :2]], 1)  # xi t5, t1, t3
        # c0 = 3 (t0, t2, t4) - 2 (z0, z4, z3), c1 = 3 (xi t5, t1, t3) +
        # 2 (z2, z1, z5)
        w = torch.cat([F2.sub(re, z[:, :3]), F2.add(tp, z[:, 3:])], 1)
        out = F2.add(F2.double(w), torch.cat([re, tp], 1))
        return out.movedim(1, 0).flatten(0, 1)

    # ------------------------------------------------------------------
    # constants
    # ------------------------------------------------------------------

    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros((self.U,) + tuple(shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, shape=()) -> torch.Tensor:
        """Montgomery one, materialised."""
        out = self.zeros(shape)
        out[:self.fq2.U] = self.fq2.ones(shape)
        return out


_CACHE: dict = {}


def _cached(cls, host, key, device):
    dev = resolve_device(device)
    key = (cls.__name__, key, str(dev))
    if key not in _CACHE:
        _CACHE[key] = cls(host, dev)
    return _CACHE[key]


def tquad_for(host: QuadExtField, device="cuda") -> TQuadField:
    """The Fq2 context on `device` (CUDA unless the caller names the CPU;
    raises without a card)."""
    return _cached(TQuadField, host, (host.base.p, int(host.beta)), device)


def tcubic_for(host: CubicOverQuad, device="cuda") -> TCubicField:
    """The Fq6 context on `device` (CUDA unless the caller names the CPU;
    raises without a card)."""
    xi = host.xi
    return _cached(TCubicField, host,
                   (host.fq2.base.p, int(xi.c0), int(xi.c1)), device)


def tfield12_for(host: QuadOverCubic, device="cuda") -> TQuadOverCubicField:
    """The Fq12 context on `device` (CUDA unless the caller names the CPU;
    raises without a card)."""
    xi = host.fq6.xi
    return _cached(TQuadOverCubicField, host,
                   (host.fq6.fq2.base.p, int(xi.c0), int(xi.c1)), device)
