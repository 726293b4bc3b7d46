"""Batched Fq2 arithmetic on tensors: the port's `JQuadField`.

Counterpart of `crypto_tpu/fields/jtower.py` `JQuadField` for
Fq2 = Fq[u]/(u^2 - beta) with beta = -1 (asserted, as the reference's
fused Fq2 kernels assume; true of BLS12-381).  An element is a
`(2L, ...)` int32 tensor: c0's L Montgomery limbs in rows [:L], c1's in
rows [L:].  This is the reference kernels' transposed layout (`Fq2Ctx`),
so a batch goes to the Fq2 kernels without a transpose.  `U = 2L` is the
rows per element (`TField.U = L`), which the MSM reads for every layout.

`mul` goes through the Fq2 mul kernel and `square` through the Fq2
square kernel, the reference's complex squaring
(`ops/kernels/field_kernels.fq2_mul` / `fq2_sqr`); `inv` takes the norm and one
base-field Fermat inversion (the mont_mul kernel).  `add`, `sub` and
`neg` run as one base-field op over an `(L, 2, ...)` view of both
components, so they cost what a base-field op costs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.kernels.field_kernels import (fq2_mul, fq2_mul_plain, fq2_sqr,
                                         fq2_sqr_plain)
from .tfield import tfield_for
from .tower import Fp2, QuadExtField


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


_CACHE: dict = {}


def tquad_for(host: QuadExtField, device="cuda") -> TQuadField:
    """The Fq2 context on `device` (CUDA unless the caller names the CPU;
    raises without a card)."""
    dev = resolve_device(device)
    key = (host.base.p, int(host.beta), str(dev))
    if key not in _CACHE:
        _CACHE[key] = TQuadField(host, dev)
    return _CACHE[key]
