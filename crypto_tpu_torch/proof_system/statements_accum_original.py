"""Original (2020/777 section 7) VB accumulator statements and KB
positive accumulator statements for the composite proof system: the
port's own copy of `crypto_tpu/proof_system/statements_accum_original.py`.

* `VBAccumulatorMembership` / `VBAccumulatorNonMembership` — the ORIGINAL
  pairing-based proofs whose Schnorr commitment includes a GT element
  (reference `proof_system/src/statement/accumulator.rs` +
  `vb_accumulator/src/proofs.rs:126-290`; the repo protocol lives in
  `accumulator/proofs_original.py`).
* `KBPositiveAccumulatorMembership` / `KBPositiveAccumulatorMembershipCDH`
  — PoK of a (deterministic) BB signature on the member plus PoK of the
  signature randomness' membership in the non-adaptive accumulator, with
  the randomness responses linked (reference
  `vb_accumulator/src/kb_positive_accumulator/proofs{,_cdh}.rs`; repo
  protocol `accumulator/kb_positive.py`).  Witness 0 = the signed element.

Witness indexing: witness 0 = the (non)member element for all statements
here (responses shareable across statements).

The original proofs pair in the prover (R_E) and the verifier, through
`curves.tpairing.multi_pairings_routed` on `Statement.device`.  Where the
verifier has a shared `RandomizedPairingChecker`, their equation defers
into it with R_E as its GT target (the reference checks it eagerly even
then): two more pairs in the checker's one device Miller product.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..accumulator import proofs_original as orig
from ..accumulator.kb_positive import (KBPosMembershipProofProtocol,
                                       KBPositiveAccumulatorWitness,
                                       KBPosPublicKey, KBPosSetupParams)
from ..accumulator.setup import AccumPublicKey, AccumSetupParams
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..serialize import ByteWriter
from .base import ProofSystemError, Statement
from .statements import AccumMembershipWit, AccumNonMembershipWit

F = bls.Fr


def _verify_original(stmt, proof, challenge, pairing_checker) -> bool:
    """An original (non)membership proof's check: its equation deferred
    into the shared checker, or paired on the statement's device."""
    args = (stmt.accumulator_value, challenge, stmt.public_key, stmt.params,
            stmt.proving_key)
    if pairing_checker is not None:
        return proof.verify_with_pairing_checker(*args, pairing_checker)
    return proof.verify(*args, device=stmt.device)


@dataclass
class VBAccumulatorMembership(Statement):
    """Original 2020/777 §7 membership proof (GT-element Schnorr
    commitment `R_E`); reference `statement/accumulator.rs`
    `VBAccumulatorMembership` + `vb_accumulator/src/proofs.rs:126-760`."""
    accumulator_value: Point
    params: AccumSetupParams
    public_key: AccumPublicKey
    proving_key: orig.MembershipProvingKey

    def init_subprotocol(self, rng, blindings, witness: AccumMembershipWit):
        protocol = orig.MembershipProofProtocol.init(
            rng, witness.element, blindings.get(0), witness.witness,
            self.accumulator_value, self.public_key, self.params,
            self.proving_key, self.device)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(
                    stmt.accumulator_value, stmt.public_key, stmt.params,
                    stmt.proving_key, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        proof.challenge_contribution(self.accumulator_value, self.public_key,
                                     self.params, self.proving_key, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not _verify_original(self, proof, challenge, pairing_checker):
            raise ProofSystemError(
                "original accumulator membership proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.response_for_element()


@dataclass
class VBAccumulatorNonMembership(Statement):
    """Original universal-accumulator non-membership proof (adds the d != 0
    commitment legs); reference `vb_accumulator/src/proofs.rs:1100-1560`."""
    accumulator_value: Point
    params: AccumSetupParams
    public_key: AccumPublicKey
    proving_key: orig.NonMembershipProvingKey

    def init_subprotocol(self, rng, blindings, witness: AccumNonMembershipWit):
        protocol = orig.NonMembershipProofProtocol.init(
            rng, witness.element, blindings.get(0), witness.witness,
            self.accumulator_value, self.public_key, self.params,
            self.proving_key, self.device)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(
                    stmt.accumulator_value, stmt.public_key, stmt.params,
                    stmt.proving_key, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        proof.challenge_contribution(self.accumulator_value, self.public_key,
                                     self.params, self.proving_key, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not _verify_original(self, proof, challenge, pairing_checker):
            raise ProofSystemError(
                "original accumulator non-membership proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.response_for_element()


@dataclass
class KBPosAccumWitness:
    element: object            # Fp: the signed member
    witness: KBPositiveAccumulatorWitness


@dataclass
class KBPositiveAccumulatorMembership(Statement):
    """KB positive accumulator membership: linked BB-sig PoK + accumulator
    membership PoK (reference `statement/accumulator.rs`
    `KBPositiveAccumulatorMembership`)."""
    accumulator_value: Point
    params: KBPosSetupParams
    public_key: KBPosPublicKey

    def init_subprotocol(self, rng, blindings, witness: KBPosAccumWitness):
        protocol = KBPosMembershipProofProtocol.init(
            rng, witness.element, witness.witness, self.accumulator_value,
            self.params, element_blinding=blindings.get(0))
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.accumulator_value,
                                                stmt.params, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        proof.challenge_contribution(self.accumulator_value, self.params,
                                     writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify(self.accumulator_value, challenge,
                            self.public_key, self.params,
                            pairing_checker=pairing_checker):
            raise ProofSystemError("KB positive accumulator proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.get_schnorr_response_for_element()


@dataclass
class KBPositiveAccumulatorMembershipCDH(KBPositiveAccumulatorMembership):
    """CDH spelling (reference `accumulator/cdh.rs`
    `KBPositiveAccumulatorMembershipCDH`): the accumulator leg of the repo's
    combined protocol is already the CDH (pairing-free-prover) variant
    (`accumulator/proofs_cdh.py`), so this shares the implementation."""
