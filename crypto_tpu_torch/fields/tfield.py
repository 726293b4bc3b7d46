"""Batched prime-field arithmetic on tensors: the port's `JField`.

Counterpart of `crypto_tpu/fields/jfield.py`.  A batch of field elements
is an int32 tensor of shape `(L, ...)`: L 32-bit limbs (uint32 bit
patterns), least significant first, limb-major, in Montgomery form with
R = 2^(32L).  Limb-major is the kernels' layout, so `mul` hands a batch to
the Montgomery kernel without a transpose.

`mul` (and everything built on it: `square`, `to_mont`, `from_mont`)
goes through `ops/kernels/field_kernels.mont_mul`, and `pow_fixed` and
`inv` through `field_kernels.mont_pow` (the whole Fermat chain in one
launch): the CUDA kernels for tensors on the card, their plain versions
on the CPU.
`add`, `sub`, `neg`, `double` and the predicates are plain tensor code on
either device.  Carries run as one integer addition over a packed bit mask
(the carry-lookahead identity: carries = ((P|G) + G) ^ P), so an add costs
a fixed handful of tensor ops whatever the limb count.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.kernels.field_kernels import MASK32, Modulus, limbs32, mont_mul, \
    mont_mul_plain, mont_pow, to_i32, u32
from .host import Field


class TField:
    """Device field context bound to a host `Field` and a torch device."""

    def __init__(self, field: Field, device="cuda"):
        if field.limb_bits != 32:
            raise ValueError("TField expects a Field with 32-bit limbs")
        self.field = field
        self.p = field.p
        self.L = field.num_limbs
        self.U = self.L            # rows per element (2L for Fq2, `TQuadField`)
        self.device = resolve_device(device)
        self.mod = Modulus(field.p, self.L)
        dev = self.device
        self._p64 = u32(self._const(field.p))          # (L,) int64
        self._idx = torch.arange(self.L, dtype=torch.int64, device=dev)
        self._w = torch.ones(self.L, dtype=torch.int64,
                             device=dev) << self._idx
        self.r_mont = self._const(field.R)                # Montgomery one
        self.r2 = self._const(field.R2)

    def _const(self, v: int) -> torch.Tensor:
        """(L,) limbs of v, taken as is (p itself included)."""
        return to_i32(torch.tensor(limbs32(v, self.L), dtype=torch.int64,
                                   device=self.device))

    def _col(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """(L,) constant viewed to broadcast against an ndim-dim batch."""
        return t.view((self.L,) + (1,) * (ndim - 1))

    # ------------------------------------------------------------------
    # host <-> device conversion
    # ------------------------------------------------------------------

    def pack(self, values, mont: bool = True) -> torch.Tensor:
        """Python ints (nested lists ok) -> (L, ...) int32 tensor, in
        Montgomery form by default."""
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        p, R, nb = self.p, 1 << (32 * self.L), 4 * self.L
        buf = bytearray()
        for v in flat:
            v = int(v) % p
            if mont:
                v = v * R % p
            buf += v.to_bytes(nb, "little")
        rows = np.frombuffer(bytes(buf), dtype="<u4").reshape(-1, self.L)
        t = torch.from_numpy(rows.view(np.int32).T.copy())
        return t.reshape((self.L,) + arr.shape).to(self.device)

    def unpack(self, limbs: torch.Tensor, mont: bool = True):
        """(L, ...) tensor -> object array of Python ints (a bare int for a
        single element)."""
        a = limbs.detach().to("cpu").numpy()
        shape = a.shape[1:]
        rows = np.ascontiguousarray(a.reshape(self.L, -1).T).view("<u4")
        rinv = pow(1 << (32 * self.L), -1, self.p)
        out = np.empty(rows.shape[0], dtype=object)
        for i, row in enumerate(rows):
            v = int.from_bytes(row.tobytes(), "little")
            out[i] = v * rinv % self.p if mont else v
        return out.reshape(shape) if shape else out[0]

    def unpack_host(self, limbs: torch.Tensor):
        """(L, ...) tensor -> host `Field` elements (object array)."""
        ints = self.unpack(limbs)
        arr = np.asarray(ints, dtype=object)
        out = np.empty(arr.size, dtype=object)
        for i, v in enumerate(arr.reshape(-1)):
            out[i] = self.field(int(v))
        return out.reshape(arr.shape) if arr.shape else out[0]

    # ------------------------------------------------------------------
    # limb helpers (int64 tensors of uint32 values)
    # ------------------------------------------------------------------

    def _carries(self, gen: torch.Tensor, prop: torch.Tensor):
        """Carry into each limb and out of the top one, for per-limb
        generate/propagate masks (disjoint), via one packed addition."""
        w = self._col(self._w, gen.dim())
        G = (gen.to(torch.int64) * w).sum(0)
        P = (prop.to(torch.int64) * w).sum(0)
        C = ((P | G) + G) ^ P
        cin = (C.unsqueeze(0) >> self._col(self._idx, gen.dim())) & 1
        return cin, (C >> self.L) & 1

    def _add_raw(self, ua, ub):
        s = ua + ub
        low = s & MASK32
        cin, cout = self._carries(s >> 32, low == MASK32)
        return (low + cin) & MASK32, cout

    def _sub_raw(self, ua, ub):
        d = ua - ub
        bin_, bout = self._carries(d < 0, d == 0)
        return (d - bin_) & MASK32, bout

    # ------------------------------------------------------------------
    # public field ops (Montgomery domain)
    # ------------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, co = self._add_raw(u32(a), u32(b))
        d, bo = self._sub_raw(s, self._col(self._p64, s.dim()))
        keep = (bo == 1) & (co == 0)
        return to_i32(torch.where(keep.unsqueeze(0), s, d))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d, bo = self._sub_raw(u32(a), u32(b))
        dp, _ = self._add_raw(d, self._col(self._p64, d.dim()))
        return to_i32(torch.where((bo == 1).unsqueeze(0), dp, d))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        """p - a, with neg(0) = 0."""
        d, _ = self._sub_raw(self._col(self._p64, a.dim()), u32(a))
        return torch.where(self.is_zero(a).unsqueeze(0), a, to_i32(d))

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·R^-1 mod p through the mont_mul kernel."""
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        out = mont_mul(a.reshape(self.L, -1).contiguous(),
                       b.reshape(self.L, -1).contiguous(), self.mod)
        return out.reshape(shape)

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """What `mul` computes on (L, M) batches, in plain tensor ops on any
        device (the kernels' plain versions use it)."""
        return mont_mul_plain(a, b, self.mod)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def square_plain(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul_plain(a, a)

    def pow_fixed(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a fixed exponent, square-and-multiply, through the
        mont_pow kernel: the whole chain in one launch."""
        if e == 0:
            return self.ones(a.shape[1:])
        return mont_pow(a.reshape(self.L, -1).contiguous(), e,
                        self.mod).reshape(a.shape)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Batched Fermat inversion a^(p-2); 0 maps to 0."""
        return self.pow_fixed(a, self.p - 2)

    # ------------------------------------------------------------------
    # predicates / conversion
    # ------------------------------------------------------------------

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
        """where(mask, a, b), mask shaped like the batch."""
        return torch.where(mask.unsqueeze(0), a, b)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self._col(self.r2, a.dim()))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mul(a, one)

    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros((self.L,) + tuple(shape), dtype=torch.int32,
                           device=self.device)

    def ones(self, shape=()) -> torch.Tensor:
        """Montgomery one (R mod p), materialised."""
        shape = tuple(shape)
        return self._col(self.r_mont, len(shape) + 1).expand(
            (self.L,) + shape).contiguous()


_CACHE: dict = {}


def tfield_for(field: Field, device="cuda") -> TField:
    """The field's context on `device` (CUDA unless the caller names the
    CPU; raises without a card)."""
    dev = resolve_device(device)
    key = (field.p, str(dev))
    if key not in _CACHE:
        _CACHE[key] = TField(field, dev)
    return _CACHE[key]
