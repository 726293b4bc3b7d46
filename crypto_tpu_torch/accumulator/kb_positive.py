"""KB positive accumulator: the port's own copy of
`crypto_tpu/accumulator/kb_positive.py` (reference
`vb_accumulator/src/kb_positive_accumulator/`): membership credentials
that can be issued without updating the accumulator.

A NonAdaptivePositiveAccumulator starts at a random value and only changes
on REMOVE (V' = V * 1/(e + alpha)); the witness is C = V * 1/(e + alpha)
just like the VB positive accumulator.  The adaptive KB accumulator wraps
it: the element added is not the user's value y but the RANDOMNESS r of a
deterministic BB signature on y — so adds don't touch the accumulator
value, removals delete r.  Membership proof = PoK of the BB signature on y
(with randomness r) AND PoK of r's accumulator membership, with r's
Schnorr responses shared between the two.  The membership check's
pairing product goes through `curves.tpairing.multi_pairings_routed` on
`device` (CUDA unless the caller names the CPU), which sends it to the
batched device pairing or to the host by its size; the proofs pair on
the host, as `bb_sig` and `proofs_cdh` do."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..hashing import blake2b512, field_elem_from_try_and_incr
from ..serialize import ByteWriter
from ..short_group_sig.bb_sig import (BBPublicKey, BBSecretKey, BBSig,
                                      BBSigParams, PoKBBSig, PoKBBSigProtocol)
from .core import AccumulatorError, MembershipWitness
from .proofs_cdh import MembershipProof, MembershipProofProtocol
from .setup import AccumPublicKey, AccumSecretKey, AccumSetupParams

F = bls.Fr


def bb_sig_prf(message: Fp, sk: BBSecretKey, digest=blake2b512) -> Fp:
    """Deterministic BB-sig randomness r = H(sk || message)
    (reference `bb_sig.rs` `prf`)."""
    return field_elem_from_try_and_incr(
        F, sk.x.to_bytes_le() + sk.y.to_bytes_le() + message.to_bytes_le(),
        digest)


def bb_sig_deterministic(message: Fp, sk: BBSecretKey,
                         params: BBSigParams) -> BBSig:
    r = bb_sig_prf(message, sk)
    denom = sk.x + message + sk.y * r
    if denom.is_zero():
        raise AccumulatorError("degenerate BB signature")
    return BBSig(A=(params.g1 * int(denom.inverse())).normalize(), r=r)


@dataclass
class KBPosSecretKey:
    sig: BBSecretKey
    accum: AccumSecretKey

    @classmethod
    def generate(cls, rng):
        return cls(sig=BBSecretKey.generate(rng),
                   accum=AccumSecretKey.generate(rng))


@dataclass
class KBPosPublicKey:
    sig: BBPublicKey
    accum: AccumPublicKey

    @classmethod
    def generate(cls, sk: KBPosSecretKey, params: "KBPosSetupParams"):
        return cls(sig=BBPublicKey.generate(sk.sig, params.sig),
                   accum=AccumPublicKey.generate(sk.accum, params.accum))


@dataclass
class KBPosSetupParams:
    sig: BBSigParams
    accum: AccumSetupParams

    @classmethod
    def new(cls, label: bytes):
        return cls(sig=BBSigParams.new(label),
                   accum=AccumSetupParams.new(label))


@dataclass
class NonAdaptivePositiveAccumulator:
    """Accumulator whose value ignores additions (`non_adaptive_
    accumulator.rs`): V fixed at init, divided on removal."""
    value: Point

    @classmethod
    def initialize(cls, rng, params_gen: Point):
        return cls(value=(params_gen * int(F.rand_nonzero(rng))).normalize())

    def add(self, element: Fp, state):
        if state.has(element):
            raise AccumulatorError("element already present")
        state.add(element)
        return self

    def add_batch(self, elements, state):
        for e in elements:
            self.add(e, state)
        return self

    def remove(self, element: Fp, sk: AccumSecretKey, state):
        if not state.has(element):
            raise AccumulatorError("element not present")
        state.remove(element)
        inv = (element + sk.alpha).inverse()
        return NonAdaptivePositiveAccumulator(
            value=(self.value * int(inv)).normalize())

    def remove_batch(self, elements, sk: AccumSecretKey, state):
        acc = self
        for e in elements:
            acc = acc.remove(e, sk, state)
        return acc

    def get_membership_witness(self, member: Fp, sk: AccumSecretKey,
                               state) -> MembershipWitness:
        if not state.has(member):
            raise AccumulatorError("not a member")
        inv = (member + sk.alpha).inverse()
        return MembershipWitness(C=(self.value * int(inv)).normalize())

    def compute_membership_witnesses_for_batch(self, members,
                                               sk: AccumSecretKey):
        return [MembershipWitness(
            C=(self.value * int((m + sk.alpha).inverse())).normalize())
            for m in members]

    def verify_membership(self, member: Fp, witness: MembershipWitness,
                          pk: AccumPublicKey, params: AccumSetupParams,
                          device="cuda") -> bool:
        rhs = (params.P_tilde * int(member) + pk.Q_tilde).normalize()
        return multi_pairings_routed([[
            (witness.C, rhs),
            ((-self.value).normalize(), params.P_tilde),
        ]], device)[0].is_one()


@dataclass
class KBPositiveAccumulatorWitness:
    signature: BBSig
    accum_witness: MembershipWitness

    @property
    def accumulator_member(self) -> Fp:
        return self.signature.r

    def update_after_removal(self, removal: Fp, new_accumulator: Point
                             ) -> "KBPositiveAccumulatorWitness":
        from .witness import update_membership_after_removal
        new_wit = update_membership_after_removal(
            self.accum_witness, self.accumulator_member, removal,
            new_accumulator)
        return KBPositiveAccumulatorWitness(signature=self.signature,
                                            accum_witness=new_wit)


@dataclass
class KBPositiveAccumulator:
    accum: NonAdaptivePositiveAccumulator

    @classmethod
    def initialize(cls, rng, params_gen: Point):
        return cls(accum=NonAdaptivePositiveAccumulator.initialize(
            rng, params_gen))

    @property
    def value(self) -> Point:
        return self.accum.value

    def add(self, element: Fp, sk: KBPosSecretKey,
            params: KBPosSetupParams, state) -> KBPositiveAccumulatorWitness:
        sig = bb_sig_deterministic(element, sk.sig, params.sig)
        self.accum.add(sig.r, state)
        wit = self.accum.get_membership_witness(sig.r, sk.accum, state)
        return KBPositiveAccumulatorWitness(signature=sig,
                                            accum_witness=wit)

    def remove(self, element: Fp, sk: KBPosSecretKey,
               state) -> "KBPositiveAccumulator":
        r = bb_sig_prf(element, sk.sig)
        return KBPositiveAccumulator(
            accum=self.accum.remove(r, sk.accum, state))

    def verify_membership(self, element: Fp,
                          witness: KBPositiveAccumulatorWitness,
                          pk: KBPosPublicKey, params: KBPosSetupParams,
                          device="cuda") -> bool:
        if not witness.signature.verify(element, pk.sig, params.sig):
            return False
        return self.accum.verify_membership(
            witness.accumulator_member, witness.accum_witness, pk.accum,
            params.accum, device)


# ---------------------------------------------------------------------------
# membership proof: BB-sig PoK + accumulator-membership PoK linked on r
# ---------------------------------------------------------------------------

@dataclass
class KBPosMembershipProofProtocol:
    sig_pok: PoKBBSigProtocol
    accum_pok: MembershipProofProtocol

    @classmethod
    def init(cls, rng, element: Fp,
             witness: KBPositiveAccumulatorWitness,
             accumulator_value: Point, params: KBPosSetupParams,
             element_blinding: Optional[Fp] = None):
        r_blinding = F.rand(rng)
        sig_pok = PoKBBSigProtocol.init(
            rng, witness.signature, element, params.sig,
            m_blinding=element_blinding, r_blinding=r_blinding)
        accum_pok = MembershipProofProtocol.init(
            rng, witness.accumulator_member, r_blinding,
            witness.accum_witness, accumulator_value)
        return cls(sig_pok=sig_pok, accum_pok=accum_pok)

    def challenge_contribution(self, accumulator_value: Point,
                               params: KBPosSetupParams,
                               writer: ByteWriter):
        self.sig_pok.challenge_contribution(params.sig, writer)
        self.accum_pok.challenge_contribution(accumulator_value, writer)

    def gen_proof(self, challenge: Fp) -> "KBPosMembershipProof":
        return KBPosMembershipProof(
            sig_proof=self.sig_pok.gen_proof(challenge),
            accum_proof=self.accum_pok.gen_proof(challenge))


@dataclass
class KBPosMembershipProof:
    sig_proof: PoKBBSig
    accum_proof: MembershipProof

    def challenge_contribution(self, accumulator_value: Point,
                               params: KBPosSetupParams,
                               writer: ByteWriter):
        self.sig_proof.challenge_contribution(params.sig, writer)
        self.accum_proof.challenge_contribution(accumulator_value, writer)

    def verify(self, accumulator_value: Point, challenge: Fp,
               pk: KBPosPublicKey, params: KBPosSetupParams,
               pairing_checker=None) -> bool:
        if not self.sig_proof.verify(challenge, pk.sig, params.sig):
            return False
        if not self.accum_proof.verify(accumulator_value, challenge,
                                       pk.accum, params.accum):
            return False
        # r shared: BB sig's randomness response == accumulator element resp
        return self.sig_proof.resp2.get_response(0) == \
            self.accum_proof.get_schnorr_response_for_element()

    def get_schnorr_response_for_element(self) -> Fp:
        """Response for the signed element y (cross-statement linking)."""
        return self.sig_proof.resp1.get_response(1)
