"""Plain Schnorr signature over any short Weierstrass group (reference
`utils/src/schnorr_signature.rs`): the port's own copy of
`crypto_tpu/utils/schnorr_signature.py`, the user's hardware signer in
BBS#.  Host code."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, field_elem_from_try_and_incr
from ..serialize import serialize_point


@dataclass
class SchnorrSignature:
    response: Fp
    challenge: Fp

    @classmethod
    def new(cls, rng, message: bytes, secret_key: Fp, g: Point,
            digest=blake2b512) -> "SchnorrSignature":
        F = secret_key.f
        r = F.rand(rng)
        t = (g * int(r)).normalize()
        challenge = cls.compute_challenge(t, message, F, digest)
        return cls(response=r + challenge * secret_key, challenge=challenge)

    def verify(self, message: bytes, public_key: Point, g: Point,
               digest=blake2b512) -> bool:
        t = (g * int(self.response)
             - public_key * int(self.challenge)).normalize()
        return self.compute_challenge(
            t, message, self.challenge.f, digest) == self.challenge

    @staticmethod
    def compute_challenge(t: Point, message: bytes, F, digest) -> Fp:
        return field_elem_from_try_and_incr(
            F, serialize_point(t) + message, digest)
