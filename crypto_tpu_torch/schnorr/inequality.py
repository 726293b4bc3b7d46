"""ZK proof of inequality of a committed value with a public value or
another committed value: the port's own copy of
`crypto_tpu/schnorr/inequality.py` (reference
`schnorr_pok/src/inequality.rs`, U-Prove inequality-proof extension,
optimized).  Host code.

Given C = G*m + H*r and public v, prove m != v:
  a random; k = -a*r;  B = G*(m-v)*a  (verifier checks B != identity)
  note B = (C - G*v)*a + H*k
  three Schnorr proofs:
    (a) knowledge of (m, r) in C
    (b) knowledge of w = (m-v)*a in B = G*w
    (c) knowledge of (a, k) in B = (C - G*v)*a + H*k
Committed-vs-committed inequality reduces to the public case with
C := C1 - C2, v := 0.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter
from ..utils.commitment import PedersenCommitmentKey
from .discrete_log import (PartialPokPedersenCommitment, PokDiscreteLog,
                           PokDiscreteLogProtocol,
                           PokPedersenCommitment,
                           PokPedersenCommitmentProtocol)

F = bls.Fr


class InequalityError(Exception):
    pass


def _base_for_b(commitment: Point, inequal_to: Fp,
                ck: PedersenCommitmentKey) -> Point:
    return (commitment - ck.g * int(inequal_to)).normalize()


@dataclass
class DiscreteLogInequalityProtocol:
    b: Point
    sc_c: PokPedersenCommitmentProtocol
    sc_b: PokDiscreteLogProtocol
    sc_b_ped: PokPedersenCommitmentProtocol

    @classmethod
    def init_with_public_value(cls, rng, value: Fp, randomness: Fp,
                               commitment: Point, inequal_to: Fp,
                               ck: PedersenCommitmentKey):
        if value == inequal_to:
            raise InequalityError("values are equal")
        F = value.f  # field-generic: works over any curve's scalar field
        a = F.rand_nonzero(rng)
        k = -(randomness * a)
        sc_c = PokPedersenCommitmentProtocol.init(
            value, F.rand(rng), ck.g, randomness, F.rand(rng), ck.h)
        w = (value - inequal_to) * a
        b_pt = (ck.g * int(w)).normalize()
        sc_b = PokDiscreteLogProtocol.init(w, F.rand(rng), ck.g)
        sc_b_ped = PokPedersenCommitmentProtocol.init(
            a, F.rand(rng), _base_for_b(commitment, inequal_to, ck),
            k, F.rand(rng), ck.h)
        return cls(b=b_pt, sc_c=sc_c, sc_b=sc_b, sc_b_ped=sc_b_ped)

    @classmethod
    def init_with_committed_value(cls, rng, value1, randomness1, commitment1,
                                  value2, randomness2, commitment2, ck):
        if value1 == value2:
            raise InequalityError("values are equal")
        return cls.init_with_public_value(
            rng, value1 - value2, randomness1 - randomness2,
            (commitment1 - commitment2).normalize(), value1.f(0), ck)

    def challenge_contribution(self, commitment: Point, inequal_to: Fp,
                               ck: PedersenCommitmentKey, writer: ByteWriter):
        _contribution(self.b, self.sc_c.t, self.sc_b.t, self.sc_b_ped.t,
                      commitment, inequal_to, ck, writer)

    def gen_proof(self, challenge: Fp) -> "InequalityProof":
        return InequalityProof(
            b=self.b,
            sc_c=self.sc_c.gen_proof(challenge),
            sc_b=self.sc_b.gen_proof(challenge),
            sc_b_ped=self.sc_b_ped.gen_proof(challenge))


def _contribution(b, t_c, t_b, t_ped, commitment, inequal_to, ck,
                  writer: ByteWriter):
    writer.point(ck.g)
    writer.point(ck.h)
    writer.point(commitment)
    writer.field(inequal_to)
    writer.point(b)
    writer.point(t_c)
    writer.point(t_b)
    writer.point(t_ped)


@dataclass
class InequalityProof:
    b: Point
    sc_c: PokPedersenCommitment
    sc_b: PokDiscreteLog
    sc_b_ped: PokPedersenCommitment

    def challenge_contribution(self, commitment, inequal_to, ck, writer):
        _contribution(self.b, self.sc_c.t, self.sc_b.t, self.sc_b_ped.t,
                      commitment, inequal_to, ck, writer)

    def verify_with_public_value(self, commitment: Point, inequal_to: Fp,
                                 challenge: Fp,
                                 ck: PedersenCommitmentKey) -> bool:
        if self.b.is_infinity():
            return False
        if not self.sc_c.verify(commitment, ck.g, ck.h, challenge):
            return False
        if not self.sc_b.verify(self.b, ck.g, challenge):
            return False
        return self.sc_b_ped.verify(
            self.b, _base_for_b(commitment, inequal_to, ck), ck.h, challenge)

    def verify_with_committed_value(self, commitment1: Point,
                                    commitment2: Point, challenge: Fp,
                                    ck: PedersenCommitmentKey) -> bool:
        return self.verify_with_public_value(
            (commitment1 - commitment2).normalize(),
            self.sc_c.response1.f(0), challenge, ck)

    def response_for_value(self) -> Fp:
        """Response for m (for cross-statement equality)."""
        return self.sc_c.response1


@dataclass
class UnknownDiscreteLogInequalityProtocol:
    """Prove z != y*k for witness k with y = g*k known (i.e. the prover's
    key k does NOT explain z over base h): publish c = h*(k*beta) - z*beta
    (nonzero iff h*k != z) and prove the same (alpha=k*beta, beta) opens
    both c over (h, -z) and ZERO over (g, -y) — shared blindings make the
    zero-leg responses equal the c-leg's (reference
    `schnorr_pok/src/inequality.rs:369-556`)."""
    c: Point
    sc_c: PokPedersenCommitmentProtocol
    sc_zero: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, value: Fp, g: Point, h: Point, y: Point, z: Point):
        Fv = value.f
        beta = Fv.rand(rng)
        alpha = value * beta
        minus_z = (-z).normalize()
        minus_y = (-y).normalize()
        c = (h * int(alpha) + minus_z * int(beta)).normalize()
        if c.is_infinity():
            raise InequalityError("values are equal")
        alpha_blinding, beta_blinding = Fv.rand(rng), Fv.rand(rng)
        sc_c = PokPedersenCommitmentProtocol.init(
            alpha, alpha_blinding, h, beta, beta_blinding, minus_z)
        sc_zero = PokPedersenCommitmentProtocol.init(
            alpha, alpha_blinding, g, beta, beta_blinding, minus_y)
        return cls(c=c, sc_c=sc_c, sc_zero=sc_zero)

    def challenge_contribution(self, g, h, y, z, writer: ByteWriter):
        _unknown_dlog_contribution(self.c, self.sc_c.t, self.sc_zero.t,
                                   g, h, y, z, writer)

    def gen_proof(self, challenge: Fp) -> "UnknownDiscreteLogInequalityProof":
        return UnknownDiscreteLogInequalityProof(
            c=self.c, sc_c=self.sc_c.gen_proof(challenge),
            sc_zero=self.sc_zero.gen_partial_proof())


def _unknown_dlog_contribution(c, t_c, t_zero, g, h, y, z,
                               writer: ByteWriter):
    minus_z = (-z).normalize()
    minus_y = (-y).normalize()
    zero = g.curve.infinity()
    writer.point(c)
    for p in (h, minus_z, c, t_c):
        writer.point(p)
    for p in (g, minus_y, zero, t_zero):
        writer.point(p)


@dataclass
class UnknownDiscreteLogInequalityProof:
    c: Point
    sc_c: PokPedersenCommitment
    sc_zero: "PartialPokPedersenCommitment"

    def challenge_contribution(self, g, h, y, z, writer: ByteWriter):
        _unknown_dlog_contribution(self.c, self.sc_c.t, self.sc_zero.t,
                                   g, h, y, z, writer)

    def verify(self, g: Point, h: Point, y: Point, z: Point,
               challenge: Fp) -> bool:
        if self.c.is_infinity():
            return False
        minus_z = (-z).normalize()
        minus_y = (-y).normalize()
        if not self.sc_c.verify(self.c, h, minus_z, challenge):
            return False
        return self.sc_zero.verify(
            g.curve.infinity(), g, minus_y, challenge,
            self.sc_c.response1, self.sc_c.response2)
