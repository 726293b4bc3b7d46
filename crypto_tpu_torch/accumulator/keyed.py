"""Keyed-verification accumulator proofs: the port's own copy of
`crypto_tpu/accumulator/keyed.py` (reference
`vb_accumulator/src/{setup_keyed_verification,proofs_keyed_verification}.rs`).
Host code.

When the verifier holds the accumulator secret key alpha (KVAC-style
deployments), no pairings are needed anywhere: the witness relation
C*(y + alpha) = V gives, after randomization C' = C*r,
C_bar := V*r - C'*y = C'*alpha.  The prover sends (C', C_bar) with a
Schnorr proof of (r, y) in C_bar = V*r + (-C')*y; the verifier checks the
Schnorr proof and C_bar == C'*alpha.

Also includes the delegated "keyed proof" object (`keyed_proof.rs` idiom):
the pair (C', C_bar) can be handed to the key holder who checks
C_bar == C'*alpha, optionally producing a proof of (in)validity of that
delegation via a shared-response double Schnorr of alpha.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter
from ..schnorr.discrete_log import (PokDiscreteLog, PokDiscreteLogProtocol,
                                    PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol,
                                    compute_challenge_contribution)
from ..hashing import compute_random_oracle_challenge
from .core import MembershipWitness
from .setup import AccumSecretKey

F = bls.Fr


@dataclass
class KeyedMembershipProofProtocol:
    C_prime: Point
    C_bar: Point
    sc: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, member: Fp, blinding: Optional[Fp],
             witness: MembershipWitness, accumulator_value: Point):
        r = F.rand_nonzero(rng)
        C_prime = (witness.C * int(r)).normalize()
        C_prime_neg = (-C_prime).normalize()
        C_bar = (accumulator_value * int(r)
                 + C_prime_neg * int(member)).normalize()
        sc = PokPedersenCommitmentProtocol.init(
            r, F.rand(rng), accumulator_value,
            member, blinding if blinding is not None else F.rand(rng),
            C_prime_neg)
        return cls(C_prime=C_prime, C_bar=C_bar, sc=sc)

    def challenge_contribution(self, accumulator_value: Point,
                               writer: ByteWriter):
        _keyed_contribution(self.C_prime, self.C_bar, self.sc.t,
                            accumulator_value, writer)

    def gen_proof(self, challenge: Fp) -> "KeyedMembershipProof":
        return KeyedMembershipProof(C_prime=self.C_prime, C_bar=self.C_bar,
                                    sc=self.sc.gen_proof(challenge))


def _keyed_contribution(C_prime, C_bar, t, V, writer: ByteWriter):
    writer.point(C_prime)
    writer.point(C_bar)
    writer.point(t)
    writer.point(V)


@dataclass
class KeyedMembershipProof:
    C_prime: Point
    C_bar: Point
    sc: PokPedersenCommitment

    def challenge_contribution(self, accumulator_value, writer):
        _keyed_contribution(self.C_prime, self.C_bar, self.sc.t,
                            accumulator_value, writer)

    def verify_schnorr(self, accumulator_value: Point, challenge: Fp) -> bool:
        if self.C_prime.is_infinity():
            return False
        return self.sc.verify(self.C_bar, accumulator_value,
                              (-self.C_prime).normalize(), challenge)

    def verify(self, accumulator_value: Point, challenge: Fp,
               sk: AccumSecretKey) -> bool:
        if not self.verify_schnorr(accumulator_value, challenge):
            return False
        return (self.C_prime * int(sk.alpha)) == self.C_bar

    def keyed_part(self) -> "KeyedProof":
        return KeyedProof(C_prime=self.C_prime, C_bar=self.C_bar)

    def response_for_element(self) -> Fp:
        return self.sc.response2


@dataclass
class KeyedProof:
    """Delegatable part: the key holder checks C_bar == C'*alpha
    (`keyed_proof.rs`)."""
    C_prime: Point
    C_bar: Point

    def verify(self, sk: AccumSecretKey) -> bool:
        return (self.C_prime * int(sk.alpha)) == self.C_bar

    def create_proof_of_validity(self, rng, sk: AccumSecretKey,
                                 pk_base: Point, pk: Point):
        """Shared-response double Schnorr of alpha: C_bar = C'*alpha and
        pk = pk_base*alpha."""
        blinding = F.rand(rng)
        p1 = PokDiscreteLogProtocol.init(sk.alpha, blinding, self.C_prime)
        p2 = PokDiscreteLogProtocol.init(sk.alpha, blinding, pk_base)
        w = ByteWriter()
        p1.challenge_contribution(self.C_prime, self.C_bar, w)
        p2.challenge_contribution(pk_base, pk, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        return ProofOfValidityOfKeyedProof(sc_bar=p1.gen_proof(c), t_pk=p2.t)


@dataclass
class ProofOfValidityOfKeyedProof:
    sc_bar: PokDiscreteLog
    t_pk: Point

    def verify(self, keyed: KeyedProof, pk_base: Point, pk: Point) -> bool:
        w = ByteWriter()
        self.sc_bar.challenge_contribution(keyed.C_prime, keyed.C_bar, w)
        compute_challenge_contribution(pk_base, pk, self.t_pk, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        if not self.sc_bar.verify(keyed.C_bar, keyed.C_prime, c):
            return False
        shared = PokDiscreteLog(t=self.t_pk, response=self.sc_bar.response)
        return shared.verify(pk, pk_base, c)
