"""Zero-knowledge proofs of accumulator (non)membership, CDH variants:
the port's own copy of `crypto_tpu/accumulator/proofs_cdh.py` (reference
`vb_accumulator/src/proofs_cdh.rs`): the prover pairs nothing.

Membership: the witness C satisfies C*(y+alpha) = V, a weak-BB signature
on the member y with "generator" V, so the proof is exactly the weak-BB
PoK (`short_group_sig/weak_bb.py`).

Non-membership: witness (C, d), relation C*(y+alpha) + P*d = V:
  r random; C' = C*r; d' = d*r
  C_bar = V*r - C'*y - P*d' ;  J = Q*d'   (Q a public generator)
  Schnorr proofs: (r, y, d') in C_bar = V*r + (-C')*y + (-P)*d' and d' in
  J = Q*d'
  Verifier: J != identity, the Schnorr checks, and e(C_bar, P_tilde) ==
  e(C', pk): on the host, or deferred into a `RandomizedPairingChecker`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..schnorr.discrete_log import PokDiscreteLog, PokDiscreteLogProtocol
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..serialize import ByteWriter
from ..short_group_sig.weak_bb import (PoKWeakBBSig, PoKWeakBBSigProtocol,
                                       WeakBBPublicKeyG2)
from .core import MembershipWitness, NonMembershipWitness
from .setup import AccumPublicKey, AccumSetupParams

F = bls.Fr


@dataclass
class MembershipProofProtocol:
    inner: PoKWeakBBSigProtocol

    @classmethod
    def init(cls, rng, member: Fp, blinding: Optional[Fp],
             witness: MembershipWitness, accumulator_value: Point):
        return cls(PoKWeakBBSigProtocol.init(
            rng, witness.C, member, accumulator_value, blinding))

    def challenge_contribution(self, accumulator_value: Point,
                               writer: ByteWriter):
        self.inner.challenge_contribution(accumulator_value, writer)

    def gen_proof(self, challenge: Fp) -> "MembershipProof":
        return MembershipProof(self.inner.gen_proof(challenge))


@dataclass
class MembershipProof:
    inner: PoKWeakBBSig

    def challenge_contribution(self, accumulator_value: Point,
                               writer: ByteWriter):
        self.inner.challenge_contribution(accumulator_value, writer)

    def verify(self, accumulator_value: Point, challenge: Fp,
               pk: AccumPublicKey, params: AccumSetupParams) -> bool:
        return self.inner.verify(challenge, WeakBBPublicKeyG2(pk.Q_tilde),
                                 accumulator_value, params.P_tilde)

    def verify_with_pairing_checker(self, accumulator_value, challenge, pk,
                                    params, checker) -> bool:
        return self.inner.verify_with_pairing_checker(
            challenge, WeakBBPublicKeyG2(pk.Q_tilde), accumulator_value,
            params.P_tilde, checker)

    def get_schnorr_response_for_element(self) -> Fp:
        return self.inner.get_resp_for_message()


@dataclass
class NonMembershipProofProtocol:
    C_prime: Point
    C_bar: Point
    J: Point
    sc: SchnorrCommitment          # for C_bar = V*r + (-C')*y + (-P)*d'
    sc_wits: list
    sc_J: PokDiscreteLogProtocol   # for J = Q*d'

    @classmethod
    def init(cls, rng, non_member: Fp, blinding: Optional[Fp],
             witness: NonMembershipWitness, accumulator_value: Point,
             params: AccumSetupParams, Q: Point):
        r = F.rand_nonzero(rng)
        d_prime = witness.d * r
        C_prime = (witness.C * int(r)).normalize()
        C_prime_neg = (-C_prime).normalize()
        P_neg = (-params.P).normalize()
        C_bar = (accumulator_value * int(r) + C_prime_neg * int(non_member)
                 + P_neg * int(d_prime)).normalize()
        J = (Q * int(d_prime)).normalize()
        y_blinding = blinding if blinding is not None else F.rand(rng)
        d_blinding = F.rand(rng)
        sc = SchnorrCommitment.new(
            [accumulator_value, C_prime_neg, P_neg],
            [F.rand(rng), y_blinding, d_blinding])
        sc_J = PokDiscreteLogProtocol.init(d_prime, d_blinding, Q)
        return cls(C_prime=C_prime, C_bar=C_bar, J=J, sc=sc,
                   sc_wits=[r, non_member, d_prime], sc_J=sc_J)

    def challenge_contribution(self, accumulator_value: Point,
                               params: AccumSetupParams, Q: Point,
                               writer: ByteWriter):
        _nm_challenge_contribution(
            self.C_prime, self.C_bar, self.J, self.sc.t, self.sc_J.t,
            accumulator_value, params, Q, writer)

    def gen_proof(self, challenge: Fp) -> "NonMembershipProof":
        return NonMembershipProof(
            C_prime=self.C_prime, C_bar=self.C_bar, J=self.J,
            T=self.sc.t, sc_resp=self.sc.response(self.sc_wits, challenge),
            sc_J=self.sc_J.gen_proof(challenge))


def _nm_challenge_contribution(C_prime, C_bar, J, T, T_J, V, params, Q,
                               writer):
    writer.points((C_bar, C_prime, J, V, params.P, Q, T, T_J))


@dataclass
class NonMembershipProof:
    C_prime: Point
    C_bar: Point
    J: Point
    T: Point
    sc_resp: SchnorrResponse
    sc_J: PokDiscreteLog

    def challenge_contribution(self, accumulator_value, params, Q, writer):
        _nm_challenge_contribution(
            self.C_prime, self.C_bar, self.J, self.T, self.sc_J.t,
            accumulator_value, params, Q, writer)

    def verify(self, accumulator_value: Point, challenge: Fp,
               pk: AccumPublicKey, params: AccumSetupParams,
               Q: Point) -> bool:
        if not self._verify_schnorr(accumulator_value, challenge, params, Q):
            return False
        return bls.multi_pairing([
            (self.C_bar, (-params.P_tilde).normalize()),
            (self.C_prime, pk.Q_tilde)]).is_one()

    def verify_with_pairing_checker(self, accumulator_value, challenge, pk,
                                    params, Q, checker) -> bool:
        if not self._verify_schnorr(accumulator_value, challenge, params, Q):
            return False
        checker.add_sources(self.C_bar, params.P_tilde, self.C_prime,
                            pk.Q_tilde)
        return True

    def _verify_schnorr(self, V, challenge, params, Q) -> bool:
        if self.J.is_infinity() or self.C_prime.is_infinity():
            return False
        bases = [V, (-self.C_prime).normalize(), (-params.P).normalize()]
        if not self.sc_resp.is_valid(bases, self.C_bar, self.T, challenge):
            return False
        if not self.sc_J.verify(self.J, Q, challenge):
            return False
        # the d' response is shared between the two Schnorr proofs
        return self.sc_resp.get_response(2) == self.sc_J.response

    def get_schnorr_response_for_element(self) -> Fp:
        return self.sc_resp.get_response(1)
