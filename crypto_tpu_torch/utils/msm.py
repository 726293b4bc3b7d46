"""Host MSM and fixed-base window tables: the port's own copy of
`crypto_tpu/utils/msm.py` (reference `utils/src/msm.rs`).

These serve protocol-sized inputs (tens to hundreds of points) on the
host.  Above `DEVICE_FIXED_BASE_THRESHOLD` scalars,
`multiply_field_elems_with_same_group_elem` runs on the device table of
`ops/fixed_base.py`; large variable-base MSMs go to
`ops/msm_v2.msm_device_scheduled` at their call sites: those over host
points (the BBS+ batch verifier's, SnarkPack's) from
`DEVICE_MSM_THRESHOLD` points on.
"""

from __future__ import annotations

import math

from .. import resolve_device
from ..curves.sw import Point
from ..ops.fixed_base import table_for

# from this many host points on, an MSM goes to the device
DEVICE_MSM_THRESHOLD = 256


def msm(points: list, scalars) -> Point:
    """Variable-base MSM, Pippenger bucket method (host ints)."""
    if not points:
        raise ValueError("empty MSM")
    curve = points[0].curve
    ks = [int(s) for s in scalars]
    if len(points) != len(ks):
        raise ValueError(f"{len(ks)} scalars for {len(points)} points")
    n = len(points)
    if n <= 4:
        acc = curve.infinity()
        for p, k in zip(points, ks):
            acc = acc + p.mul_raw(k % curve.scalar_field.p)
        return acc
    c = 4 if n < 32 else (8 if n < 1024 else 12)
    nbits = curve.scalar_field.bits
    windows = (nbits + c - 1) // c
    result = curve.infinity()
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            result = result.double()
        buckets = [None] * (1 << c)
        for p, k in zip(points, ks):
            digit = (k >> (w * c)) & ((1 << c) - 1)
            if digit:
                buckets[digit] = p if buckets[digit] is None \
                    else buckets[digit] + p
        running = curve.infinity()
        acc = curve.infinity()
        for b in range((1 << c) - 1, 0, -1):
            if buckets[b] is not None:
                running = running + buckets[b]
            acc = acc + running
        result = result + acc
    return result


class WindowTable:
    """Fixed-base scalar-multiplication table (reference
    `utils/src/msm.rs:8-45`): every digit multiple of each window, for a
    single base used many times."""

    def __init__(self, num_multiplications: int, base: Point):
        self.base = base
        self.curve = base.curve
        nbits = self.curve.scalar_field.bits
        # window size heuristic of arkworks FixedBase::get_mul_window_size
        self.c = 3 if num_multiplications < 32 else max(
            3, int(math.log2(num_multiplications) * 69 // 100) + 2)
        self.windows = (nbits + self.c - 1) // self.c
        # table[w][d] = base * (d << (c*w)) for d in [0, 2^c)
        self.table = []
        g = base
        for _ in range(self.windows):
            row = [self.curve.infinity()]
            for d in range(1, 1 << self.c):
                row.append(row[-1] + g)
            self.table.append(row)
            g = row[-1] + g  # base * 2^(c*(w+1))

    def mul(self, scalar) -> Point:
        k = int(scalar) % self.curve.scalar_field.p
        acc = self.curve.infinity()
        for w in range(self.windows):
            d = (k >> (w * self.c)) & ((1 << self.c) - 1)
            if d:
                acc = acc + self.table[w][d]
        return acc

    def __mul__(self, scalar):
        return self.mul(scalar)


DEVICE_FIXED_BASE_THRESHOLD = 512


def multiply_field_elems_with_same_group_elem(base: Point, scalars,
                                              device="cuda") -> list:
    """[base * s for s in scalars] (reference `utils/src/misc.rs`
    `points`): from `DEVICE_FIXED_BASE_THRESHOLD` scalars on, on the
    device table of `ops/fixed_base.py` (on `device`: CUDA unless the
    caller names the CPU; raises without a card), below it through a
    host window table."""
    dev = resolve_device(device)
    if len(scalars) >= DEVICE_FIXED_BASE_THRESHOLD \
            and not base.is_infinity():
        return table_for(base.curve, base, device=dev).mul_many_host(
            [int(s) for s in scalars])
    table = WindowTable(max(len(scalars), 1), base)
    return [table.mul(s) for s in scalars]
