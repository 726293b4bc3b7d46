"""Pedersen commitments: the port's own copy of
`crypto_tpu/utils/commitment.py` (reference `utils/src/commitment.rs`),
host code over the host `utils/msm.py` `msm`."""

from __future__ import annotations

from ..curves.sw import SWCurve, Point
from ..hashing import group_elem_from_try_and_incr, concat_slices, blake2b512
from .msm import msm


class PedersenCommitmentKey:
    """Key (g, h); commitment = g*m + h*r."""

    __slots__ = ("g", "h")

    def __init__(self, g: Point, h: Point):
        self.g = g
        self.h = h

    @classmethod
    def new(cls, curve: SWCurve, label: bytes, digest=blake2b512) -> "PedersenCommitmentKey":
        g = group_elem_from_try_and_incr(curve, concat_slices(label, b" : G"), digest)
        h = group_elem_from_try_and_incr(curve, concat_slices(label, b" : H"), digest)
        return cls(g.normalize(), h.normalize())

    def commit(self, message, randomness) -> Point:
        return (self.g * int(message) + self.h * int(randomness)).normalize()


class PedersenCommitmentKeyVec:
    """Vector commitment key [g_1..g_n] (+h): commitment = sum g_i*m_i (+ h*r)."""

    def __init__(self, bases: list[Point], h: Point | None = None):
        self.bases = bases
        self.h = h

    def commit(self, messages, randomness=None) -> Point:
        pts = list(self.bases[: len(messages)])
        sc = list(messages)
        if randomness is not None:
            assert self.h is not None
            pts.append(self.h)
            sc.append(randomness)
        return msm(pts, sc).normalize()
