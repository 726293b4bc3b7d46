"""Fixed-base scalar multiplication through a window table on the device.

Counterpart of `crypto_tpu/ops/fixed_base.py` (arkworks `FixedBase`,
reference `utils/src/msm.rs:8-45`), used for CRS generation
(`legogroth16/snark.py` `_fixed_base_many`) and
`utils/msm.multiply_field_elems_with_same_group_elem`.

A (W, 256) table of digit multiples, table[w][d] = d * 2^(8w) * base,
is built once on the device: 8W host doublings give the bit points
base * 2^(8w + b) of every row, then eight masked `TCurve.add`s over all
W x 256 entries at once sum each digit's bit points (eight batched adds
a table, where building row by row took eight doublings a row, 8W - 8
dependent steps).  After that N scalars cost a gather (N, W) of table
points and a
log-depth tree of `TCurve.add` over the window axis (W - 1 batched adds
for the whole batch), on G1 through the mont_mul kernel and on G2
through the Fq2 mul and square kernels.  A batch of points is limb-major,
`(U, ...)`, so the table is `(U, W, 256)` and the gather `(U, N, W)`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.sw import Point, SWCurve
from ..curves.tcurve import TCurve, TPoints, tcurve_for

WINDOW_BITS = 8


class FixedBaseTable:
    """Window table of one base point on a device (CUDA unless the caller
    names the CPU; raises without a card)."""

    def __init__(self, curve: SWCurve, base: Point, nbits: int | None = None,
                 device="cuda"):
        self.curve = curve
        self.tc: TCurve = tcurve_for(curve, device)
        self.nbits = nbits or curve.scalar_field.bits
        self.W = (self.nbits + WINDOW_BITS - 1) // WINDOW_BITS
        self.table = self._build(base)       # TPoints of shape (U, W, 256)

    def _build(self, base: Point) -> TPoints:
        tc = self.tc
        D = 1 << WINDOW_BITS
        dev = tc.F.device
        # the bit points base * 2^(8w + b) of every row (host doublings)
        bit_pts = []
        acc = base
        for _ in range(self.W * WINDOW_BITS):
            bit_pts.append(acc)
            acc = acc.double()
        packed = TPoints(*(t.reshape(t.shape[0], self.W, WINDOW_BITS)
                           for t in tc.pack_points(bit_pts)))   # (U, W, 8)
        # digit d of row w is the sum of row w's bit points of its set bits
        digits = np.arange(D, dtype=np.int64)
        table = tc.infinity((self.W, D))
        for b in range(WINDOW_BITS):
            mask = torch.from_numpy((digits >> b) & 1 > 0).to(dev).expand(
                self.W, D)
            bp = TPoints(*(t[:, :, b:b + 1].expand(-1, -1, D)
                           for t in packed))
            table = tc.select(mask, tc.add(table, bp), table)
        return table

    def digits(self, scalars) -> torch.Tensor:
        """(N, W) int64 base-256 digits of the scalars, least significant
        first (the scalars taken mod 2^(8W), as the reference's digit loop
        does)."""
        mask = (1 << (WINDOW_BITS * self.W)) - 1
        buf = b"".join((int(s) & mask).to_bytes(self.W, "little")
                       for s in scalars)
        d = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), self.W)
        return torch.from_numpy(d.astype(np.int64)).to(self.tc.F.device)

    def mul_many(self, scalars) -> TPoints:
        """(N,) scalars -> (U, N) Jacobian points scalar_i * base, on the
        device."""
        digs = self.digits(scalars)
        w_idx = torch.arange(self.W, device=digs.device).expand_as(digs)
        P = TPoints(*(t[:, w_idx, digs] for t in self.table))  # (U, N, W)
        m = self.W
        while m > 1:
            half = m // 2
            rest = m - 2 * half
            s = self.tc.add(TPoints(*(t[..., :half] for t in P)),
                            TPoints(*(t[..., half:2 * half] for t in P)))
            if rest:
                s = TPoints(*(torch.cat([u, t[..., 2 * half:m]], dim=-1)
                              for u, t in zip(s, P)))
            P = s
            m = half + rest
        return TPoints(*(t[..., 0] for t in P))

    def mul_many_host(self, scalars) -> list:
        return self.tc.unpack(self.mul_many(scalars))


@functools.lru_cache(maxsize=32)
def _table_cache(curve: SWCurve, key: tuple, nbits: int | None,
                 device: str) -> FixedBaseTable:
    return FixedBaseTable(curve, Point(*key, curve), nbits, device)


def table_for(curve: SWCurve, base: Point, nbits: int | None = None,
              device="cuda") -> FixedBaseTable:
    """The cached table of `base` on `device` (CUDA unless the caller
    names the CPU; raises without a card)."""
    b = base.normalize()
    return _table_cache(curve, (b.X, b.Y, b.Z), nbits,
                        str(tcurve_for(curve, device).F.device))
