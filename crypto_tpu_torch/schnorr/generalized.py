"""Generalized Pedersen / Schnorr commitment over a vector of bases: the
port's own copy of `crypto_tpu/schnorr/generalized.py` (reference
`schnorr_pok/src/pok_generalized_pedersen.rs:86-218`).

Prove knowledge of (x_1..x_n) with Y = sum_i G_i * x_i:
  T = sum G_i * r_i;  s_i = r_i + c * x_i;
  verify: sum G_i * s_i - Y*c == T   (one MSM, the host `utils/msm.py`
  `msm`, as in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter
from ..utils.msm import msm


@dataclass
class SchnorrCommitment:
    blindings: list
    t: Point

    @classmethod
    def new(cls, bases: Sequence[Point],
            blindings: Sequence[Fp]) -> "SchnorrCommitment":
        if len(bases) != len(blindings):
            raise ValueError(f"{len(blindings)} blindings for {len(bases)} "
                             f"bases")
        t = msm(list(bases), blindings).normalize()
        return cls(blindings=list(blindings), t=t)

    def response(self, witnesses: Sequence[Fp],
                 challenge: Fp) -> "SchnorrResponse":
        if len(witnesses) != len(self.blindings):
            raise ValueError(f"{len(witnesses)} witnesses for "
                             f"{len(self.blindings)} blindings")
        return SchnorrResponse(
            [b + w * challenge for b, w in zip(self.blindings, witnesses)])

    def challenge_contribution(self, writer: ByteWriter) -> None:
        writer.point(self.t)


@dataclass
class SchnorrResponse:
    responses: list

    def is_valid(self, bases: Sequence[Point], y: Point, t: Point,
                 challenge: Fp) -> bool:
        if len(bases) != len(self.responses):
            raise ValueError(f"{len(self.responses)} responses for "
                             f"{len(bases)} bases")
        lhs = msm(list(bases) + [y], list(self.responses) + [-challenge])
        return lhs == t

    def get_response(self, i: int) -> Fp:
        return self.responses[i]


@dataclass
class PartialSchnorrResponse:
    """Responses for only a subset of witness indices; the rest are shared
    with other protocols and supplied at verification
    (reference `schnorr_pok/src/partial.rs:35-407`)."""
    responses: dict  # index -> Fp
    total: int

    def is_valid(self, bases: Sequence[Point], y: Point, t: Point,
                 challenge: Fp, missing_responses: dict) -> bool:
        if set(self.responses) | set(missing_responses) \
                != set(range(self.total)):
            return False
        if set(self.responses) & set(missing_responses):
            return False
        full = [None] * self.total
        for i, r in self.responses.items():
            full[i] = r
        for i, r in missing_responses.items():
            full[i] = r
        return SchnorrResponse(full).is_valid(bases, y, t, challenge)

    def get_response(self, i: int) -> Fp:
        if i not in self.responses:
            raise KeyError(f"response {i} was skipped (shared elsewhere)")
        return self.responses[i]


def partial_response(commitment: SchnorrCommitment, witnesses, challenge: Fp,
                     skip_indices: set) -> PartialSchnorrResponse:
    """Like SchnorrCommitment.response but omits the given indices."""
    out = {}
    for i, (b, w) in enumerate(zip(commitment.blindings, witnesses)):
        if i not in skip_indices:
            out[i] = b + w * challenge
    return PartialSchnorrResponse(responses=out, total=len(witnesses))
