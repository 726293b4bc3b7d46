"""Randomized batch-verification checkers: the port's own copy of
`crypto_tpu/utils/checkers.py`.

* `RandomizedMultChecker` (reference `utils/src/randomized_mult_checker.rs`):
  accumulate scalar-multiplication checks `sum_i P_i s_i = T` weighted by
  powers of one random scalar; verify with one MSM == identity (the
  port's host `utils/msm.py` `msm`).
* `RandomizedPairingChecker` (reference
  `utils/src/randomized_pairing_check.rs`): accumulate pairing-product
  checks; one multi-Miller loop and one final exponentiation at the end.
  `lazy` defers the Miller loops; from `DEVICE_THRESHOLD` deferred pairs
  on they run batched on the device (`curves/tpairing.py`), unless
  `CRYPTO_TPU_PAIRING_BACKEND=host`.  The checker runs on `device`, CUDA
  unless the caller names the CPU, and raises without a card.
"""

from __future__ import annotations

import os

from .. import resolve_device
from ..curves import bls12_381 as bl
from ..curves.sw import Point
from ..curves.tpairing import tpairing_for
from .msm import msm


class RandomizedMultChecker:
    def __init__(self, random):
        self.random = random
        self.current = random.f.one()
        # key: normalized affine (x, y) -> index into lists
        self._index = {}
        self.points: list[Point] = []
        self.scalars = []

    def _add(self, p: Point, s):
        if p.is_infinity():
            return
        pn = p.normalize()
        key = (pn.X, pn.Y)
        if key in self._index:
            i = self._index[key]
            self.scalars[i] = self.scalars[i] + s
        else:
            self._index[key] = len(self.points)
            self.points.append(pn)
            self.scalars.append(s)

    def add_1(self, p, s, t):
        self._add(p, self.current * s)
        self._add(t, -self.current)
        self.current = self.current * self.random

    def add_2(self, p1, s1, p2, s2, t):
        self._add(p1, self.current * s1)
        self._add(p2, self.current * s2)
        self._add(t, -self.current)
        self.current = self.current * self.random

    def add_3(self, p1, s1, p2, s2, p3, s3, t):
        self._add(p1, self.current * s1)
        self._add(p2, self.current * s2)
        self._add(p3, self.current * s3)
        self._add(t, -self.current)
        self.current = self.current * self.random

    def add_many(self, points, scalars, t):
        for p, s in zip(points, scalars):
            self._add(p, self.current * s)
        self._add(t, -self.current)
        self.current = self.current * self.random

    def verify(self) -> bool:
        if not self.points:
            return True
        return msm(self.points, self.scalars).is_infinity()


class RandomizedPairingChecker:
    """Accumulates checks of the form prod e(a_i, b_i) == out (GT)."""

    # from this many deferred pairs on, the multi-Miller loop runs batched
    # on the device
    DEVICE_THRESHOLD = 8

    def __init__(self, random, lazy: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.random = random
        self.current = random.f.one()
        self.lazy = lazy
        self.left = bl.Fq12.one()       # accumulated miller-loop product
        self.right = bl.Fq12.one()      # accumulated GT target
        self.pending = []               # [(g1, g2)] for lazy mode

    def _accumulate(self, pairs, out):
        """prod e(a_i, b_i) == out, weighted by current random power."""
        m = int(self.current)
        weighted = [(a.mul_raw(m), b) for (a, b) in pairs]
        if self.lazy:
            self.pending.extend(weighted)
        else:
            self.left = self.left * bl.miller_loop(weighted)
        if not out.is_one():
            self.right = self.right * (out ** m)
        self.current = self.current * self.random

    def add_sources_and_target(self, a: Point, b: Point, out):
        self._accumulate([(a, b)], out)

    def add_multiple_sources_and_target(self, a_list, b_list, out):
        self._accumulate(list(zip(a_list, b_list)), out)

    def add_sources(self, a, b, c, d):
        # e(a,b) == e(c,d)  <=>  e(a,b) * e(-c,d) == 1
        self._accumulate([(a, b), (-c, d)], bl.Fq12.one())

    def add_multiple_sources(self, a_list, b_list, c_list, d_list):
        pairs = list(zip(a_list, b_list)) + [(-c, d) for c, d in zip(c_list, d_list)]
        self._accumulate(pairs, bl.Fq12.one())

    def verify(self) -> bool:
        left = self.left
        if self.pending:
            left = left * self._miller(self.pending)
        return bl.final_exponentiation(left) == self.right

    def _miller(self, pairs):
        backend = os.environ.get("CRYPTO_TPU_PAIRING_BACKEND")
        if backend == "host" or (backend is None
                                 and len(pairs) < self.DEVICE_THRESHOLD):
            return bl.miller_loop(pairs)
        norm = [(a.normalize(), b.normalize()) for (a, b) in pairs]
        return tpairing_for("bls12_381", self.device).miller_product(norm)
