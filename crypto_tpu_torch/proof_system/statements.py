"""Statement implementations: the port's own copy of
`crypto_tpu/proof_system/statements.py` (reference
`proof_system/src/statement/` + `sub_protocols/`).

Round-1 set: BBS+ signature PoK, VB accumulator (non)membership (CDH),
Pedersen commitment opening.  Witness indexing per statement:

* PoKBBSSignatureG1: witness i = message m_i (0-based; responses only exist
  for undisclosed messages)
* VBAccumulatorMembershipCDH / NonMembershipCDH: witness 0 = the element
* PedersenCommitment: witness i = the i-th opening scalar

Every pairing check here can defer into the verifier's shared
`RandomizedPairingChecker` (two pairs each for BBS+ and the accumulator
statements); without one they pair on the host, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..accumulator import proofs_cdh as acc_proofs
from ..accumulator.core import MembershipWitness, NonMembershipWitness
from ..accumulator.setup import AccumPublicKey, AccumSetupParams
from ..bbs_plus.proof import (MessageOrBlinding, PoKOfSignatureG1Proof,
                              PoKOfSignatureG1Protocol)
from ..bbs_plus.setup import PublicKeyG2, SignatureParamsG1
from ..bbs_plus.signature import BBSPlusError, SignatureG1
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..serialize import ByteWriter
from .base import ProofSystemError, Statement

F = bls.Fr


# ---------------------------------------------------------------------------
# BBS+
# ---------------------------------------------------------------------------

@dataclass
class BBSWitness:
    signature: SignatureG1
    messages: list  # all messages
    # message indices NOT revealed keep their responses


@dataclass
class PoKBBSSignatureG1(Statement):
    params: SignatureParamsG1
    public_key: PublicKeyG2
    revealed_messages: dict  # {idx: Fp}

    def init_subprotocol(self, rng, blindings, witness: BBSWitness):
        mabs = []
        for i, m in enumerate(witness.messages):
            if i in self.revealed_messages:
                mabs.append(MessageOrBlinding.reveal_message(m))
            elif i in blindings:
                mabs.append(MessageOrBlinding.blind_with(m, blindings[i]))
            else:
                mabs.append(MessageOrBlinding.blind_randomly(m))
        protocol = PoKOfSignatureG1Protocol.init(
            rng, witness.signature, self.params, mabs)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(
                    stmt.revealed_messages, stmt.params, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof: PoKOfSignatureG1Proof,
                                     writer: ByteWriter):
        proof.challenge_contribution(self.revealed_messages, self.params, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        try:
            if pairing_checker is not None:
                proof.verify_with_randomized_pairing_checker(
                    self.revealed_messages, challenge, self.public_key,
                    self.params, pairing_checker)
            else:
                proof.verify(self.revealed_messages, challenge,
                             self.public_key, self.params)
        except BBSPlusError as e:
            raise ProofSystemError(f"BBS+ statement failed: {e}")

    def response_for_witness(self, proof, wit_idx):
        return proof.get_resp_for_message(wit_idx, set(self.revealed_messages))


# ---------------------------------------------------------------------------
# Accumulators (CDH variants)
# ---------------------------------------------------------------------------

@dataclass
class AccumMembershipWit:
    element: Fp
    witness: MembershipWitness


@dataclass
class VBAccumulatorMembershipCDH(Statement):
    accumulator_value: Point
    params: AccumSetupParams
    public_key: AccumPublicKey

    def init_subprotocol(self, rng, blindings, witness: AccumMembershipWit):
        protocol = acc_proofs.MembershipProofProtocol.init(
            rng, witness.element, blindings.get(0), witness.witness,
            self.accumulator_value)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.accumulator_value, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.accumulator_value, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if pairing_checker is not None:
            ok = proof.verify_with_pairing_checker(
                self.accumulator_value, challenge, self.public_key,
                self.params, pairing_checker)
        else:
            ok = proof.verify(self.accumulator_value, challenge,
                              self.public_key, self.params)
        if not ok:
            raise ProofSystemError("accumulator membership proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.get_schnorr_response_for_element()


@dataclass
class AccumNonMembershipWit:
    element: Fp
    witness: NonMembershipWitness


@dataclass
class VBAccumulatorNonMembershipCDH(Statement):
    accumulator_value: Point
    params: AccumSetupParams
    public_key: AccumPublicKey
    Q: Point

    def init_subprotocol(self, rng, blindings, witness: AccumNonMembershipWit):
        protocol = acc_proofs.NonMembershipProofProtocol.init(
            rng, witness.element, blindings.get(0), witness.witness,
            self.accumulator_value, self.params, self.Q)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(
                    stmt.accumulator_value, stmt.params, stmt.Q, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.accumulator_value, self.params,
                                     self.Q, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if pairing_checker is not None:
            ok = proof.verify_with_pairing_checker(
                self.accumulator_value, challenge, self.public_key,
                self.params, self.Q, pairing_checker)
        else:
            ok = proof.verify(self.accumulator_value, challenge,
                              self.public_key, self.params, self.Q)
        if not ok:
            raise ProofSystemError("accumulator non-membership proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.get_schnorr_response_for_element()


# ---------------------------------------------------------------------------
# Pedersen commitment opening
# ---------------------------------------------------------------------------

@dataclass
class PedersenCommitmentStmt(Statement):
    bases: list      # [G_i]
    commitment: Point

    def init_subprotocol(self, rng, blindings, witness: list):
        assert len(witness) == len(self.bases)
        rand = [blindings.get(i, F.rand(rng)) for i in range(len(witness))]
        comm = SchnorrCommitment.new(self.bases, rand)
        stmt = self
        wits = list(witness)

        class SP:
            def challenge_contribution(self, writer):
                stmt._contribution(comm.t, writer)

            def gen_proof(self, challenge):
                return PedersenCommitmentProof(
                    t=comm.t, response=comm.response(wits, challenge))

        return SP()

    def _contribution(self, t: Point, writer: ByteWriter):
        writer.points(self.bases)
        writer.point(self.commitment)
        writer.point(t)

    def proof_challenge_contribution(self, proof, writer):
        self._contribution(proof.t, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.response.is_valid(self.bases, self.commitment, proof.t,
                                       challenge):
            raise ProofSystemError("Pedersen commitment proof failed")

    def response_for_witness(self, proof, wit_idx):
        return proof.response.get_response(wit_idx)


@dataclass
class PedersenCommitmentProof:
    t: Point
    response: SchnorrResponse


@dataclass
class KBUniversalAccumulatorMembership(VBAccumulatorMembershipCDH):
    """KB universal membership = VB positive membership in the MEMBER
    accumulator (reference `sub_protocols/accumulator/
    keyed_verification/kb_universal*`-adjacent prover variants);
    construct with accumulator_value = kb.mem.value()."""


@dataclass
class KBUniversalAccumulatorNonMembership(VBAccumulatorMembershipCDH):
    """KB universal NON-membership = VB positive membership in the
    NON-MEMBER accumulator; accumulator_value = kb.non_mem.value().
    The witness is the non-membership witness from the KB accumulator."""
