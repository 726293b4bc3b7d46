"""Schnorr PoK of discrete log(s): the port's own copy of
`crypto_tpu/schnorr/discrete_log.py` (reference
`schnorr_pok/src/discrete_log.rs`).

Protocol idiom: ``init -> challenge_contribution -> gen_proof`` /
``verify``.

* PokDiscreteLog: prove x in Y = G*x.  T = G*r; s = r + c*x;
  verify G*s - Y*c == T (`discrete_log.rs:112-175`).
* PokPedersenCommitment: prove (x1,x2) in Y = G1*x1 + G2*x2
  (`discrete_log.rs:178-274`).

Host code only; `verify_with_randomized_mult_checker` feeds a
`utils.checkers.RandomizedMultChecker`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter


@dataclass
class PokDiscreteLogProtocol:
    t: Point
    blinding: Fp
    witness: Fp

    @classmethod
    def init(cls, witness: Fp, blinding: Fp,
             base: Point) -> "PokDiscreteLogProtocol":
        return cls(t=(base * int(blinding)).normalize(), blinding=blinding,
                   witness=witness)

    def challenge_contribution(self, base: Point, y: Point,
                               writer: ByteWriter) -> None:
        compute_challenge_contribution(base, y, self.t, writer)

    def gen_proof(self, challenge: Fp) -> "PokDiscreteLog":
        return PokDiscreteLog(
            t=self.t, response=self.blinding + self.witness * challenge)

    def gen_partial_proof(self) -> "PartialPokDiscreteLog":
        """For proofs whose response equals another proof's (shared witness
        AND blinding); the verifier supplies the response."""
        return PartialPokDiscreteLog(t=self.t)


@dataclass
class PokDiscreteLog:
    t: Point
    response: Fp

    def challenge_contribution(self, base: Point, y: Point,
                               writer: ByteWriter) -> None:
        compute_challenge_contribution(base, y, self.t, writer)

    def verify(self, y: Point, base: Point, challenge: Fp) -> bool:
        return (base * int(self.response) - y * int(challenge)) == self.t

    def verify_with_randomized_mult_checker(self, y: Point, base: Point,
                                            challenge: Fp, rmc) -> None:
        rmc.add_2(base, self.response, y, -challenge, self.t)


@dataclass
class PartialPokDiscreteLog:
    """PokDiscreteLog missing its response (borrowed from a sibling proof,
    reference `discrete_log.rs` `PartialPokDiscreteLog`)."""
    t: Point

    def challenge_contribution(self, base: Point, y: Point,
                               writer: ByteWriter) -> None:
        compute_challenge_contribution(base, y, self.t, writer)

    def verify(self, y: Point, base: Point, challenge: Fp,
               response: Fp) -> bool:
        return (base * int(response) - y * int(challenge)) == self.t


@dataclass
class PartialPokPedersenCommitment:
    """PokPedersenCommitment with both responses supplied externally."""
    t: Point

    def challenge_contribution(self, base1: Point, base2: Point, y: Point,
                               writer: ByteWriter) -> None:
        writer.points((base1, base2, y, self.t))

    def verify(self, y: Point, base1: Point, base2: Point, challenge: Fp,
               response1: Fp, response2: Fp) -> bool:
        lhs = base1 * int(response1) + base2 * int(response2) \
            - y * int(challenge)
        return lhs == self.t


def compute_challenge_contribution(base: Point, y: Point, t: Point,
                                   writer: ByteWriter) -> None:
    writer.points((base, y, t))


@dataclass
class PokPedersenCommitmentProtocol:
    t: Point
    blinding1: Fp
    witness1: Fp
    blinding2: Fp
    witness2: Fp

    @classmethod
    def init(cls, witness1: Fp, blinding1: Fp, base1: Point, witness2: Fp,
             blinding2: Fp, base2: Point) -> "PokPedersenCommitmentProtocol":
        t = (base1 * int(blinding1) + base2 * int(blinding2)).normalize()
        return cls(t=t, blinding1=blinding1, witness1=witness1,
                   blinding2=blinding2, witness2=witness2)

    def challenge_contribution(self, base1: Point, base2: Point, y: Point,
                               writer: ByteWriter) -> None:
        writer.points((base1, base2, y, self.t))

    def gen_proof(self, challenge: Fp) -> "PokPedersenCommitment":
        return PokPedersenCommitment(
            t=self.t,
            response1=self.blinding1 + self.witness1 * challenge,
            response2=self.blinding2 + self.witness2 * challenge,
        )

    def gen_partial_proof(self) -> "PartialPokPedersenCommitment":
        return PartialPokPedersenCommitment(t=self.t)


@dataclass
class PokPedersenCommitment:
    t: Point
    response1: Fp
    response2: Fp

    def challenge_contribution(self, base1: Point, base2: Point, y: Point,
                               writer: ByteWriter) -> None:
        writer.points((base1, base2, y, self.t))

    def verify(self, y: Point, base1: Point, base2: Point,
               challenge: Fp) -> bool:
        lhs = base1 * int(self.response1) + base2 * int(self.response2) \
            - y * int(challenge)
        return lhs == self.t

    def verify_with_randomized_mult_checker(self, y, base1, base2, challenge,
                                            rmc) -> None:
        rmc.add_3(base1, self.response1, base2, self.response2, y,
                  -challenge, self.t)
