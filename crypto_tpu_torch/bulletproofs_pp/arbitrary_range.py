"""BP++ arbitrary-range proofs [min, max) via two perfect-range proofs per
value: the port's own copy of `crypto_tpu/bulletproofs_pp/arbitrary_range.py`
(reference `bulletproofs_plus_plus/src/range_proof_arbitrary_range.rs`):
prove v - min >= 0 and max - 1 - v >= 0, both < 2^num_bits, aggregated in
ONE batched perfect-range proof."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.sw import Point
from ..fields.host import Fp
from ..transcript.transcript import Transcript
from .range_proof import Proof, Prover, SetupParams
from .wnla import BppError


@dataclass
class ProofArbitraryRange:
    V: list
    proof: Proof

    @classmethod
    def new(cls, rng, num_bits: int, values_and_bounds: list,
            randomness: list, params: SetupParams, transcript: Transcript,
            base: int = 2) -> "ProofArbitraryRange":
        """values_and_bounds: [(v, min, max)]; randomness: 2 per value."""
        V, v = cls.compute_commitments_and_values(values_and_bounds,
                                                 randomness, params)
        prover = Prover(base, num_bits, V, v, randomness)
        return cls(V=V, proof=prover.prove(rng, params, transcript))

    def verify(self, num_bits: int, params: SetupParams,
               transcript: Transcript) -> bool:
        return self.proof.verify(num_bits, self.V, params, transcript)

    @staticmethod
    def compute_commitments_and_values(values_and_bounds, randomness,
                                       params: SetupParams):
        if len(values_and_bounds) * 2 != len(randomness):
            raise BppError("need 2 randomness values per bound pair")
        V, v = [], []
        for i, (v_i, lo, hi) in enumerate(values_and_bounds):
            if not (lo <= v_i < hi):
                raise BppError("value out of claimed range")
            V.append(params.compute_pedersen_commitment(
                v_i - lo, randomness[2 * i]))
            V.append(params.compute_pedersen_commitment(
                hi - 1 - v_i, randomness[2 * i + 1]))
            v.append(v_i - lo)
            v.append(hi - 1 - v_i)
        return V, v

    @property
    def num_proofs(self) -> int:
        return len(self.V) // 2

    def get_commitments_to_values(self, bounds: list,
                                  params: SetupParams) -> list:
        """Recover per-value commitment pairs: (comm(v) from the lower leg,
        comm(-v) offset from the upper leg)."""
        if len(bounds) != self.num_proofs:
            raise BppError("bounds count mismatch")
        out = []
        for i, (lo, hi) in enumerate(bounds):
            # V[2i] commits v - lo  ->  comm(v) = V[2i] + g*lo
            c_lo = (self.V[2 * i] + params.G * lo).normalize()
            # V[2i+1] commits hi-1-v  ->  comm(v) = g*(hi-1) - V[2i+1]
            c_hi = (params.G * (hi - 1) - self.V[2 * i + 1]).normalize()
            out.append((c_lo, c_hi))
        return out
