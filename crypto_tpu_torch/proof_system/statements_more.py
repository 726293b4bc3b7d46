"""Additional proof-system statements: PS signatures, BBS (2023), BBDT16
KVAC: the port's own copy of `crypto_tpu/proof_system/statements_more.py`
(reference `proof_system/src/statement/{ps_signature,bbs_23,
bbdt16_kvac}.rs` and the matching sub-protocols).

Notes on equality semantics:
* PoKPSSignature / PoKBBDT16MAC expose plain message responses — equality
  classes work across any statement types.
* PoKBBSSignature23 responses are for m*r (r = signature randomizer), so
  witness equality only composes among BBS23 statements sharing the same
  externally-supplied r (the reference's design for the non-CDL variant,
  `bbs_plus/src/proof_23.rs:1-22`).
* PoKBBDT16MAC verification here checks only the Schnorr part (the verifier
  is keyless); the designated key holder additionally checks the extracted
  keyed part C == B_0 * x.
* PoKPSSignature and PoKBBSSignature23G1 defer their two pairs into the
  verifier's shared `RandomizedPairingChecker` when there is one (the
  reference's PS statement ignores the checker and pairs on the host:
  the same verdict); without one, the PS pairs go through
  `curves.tpairing.multi_pairings_routed` on the statement's device and
  the BBS23 pairs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..coconut.core import (PSSignature, PSSignatureParams, PSPublicKey,
                            PSSignaturePoKProtocol)
from ..bbs_plus.bbs23 import (Signature23G1, SignatureParams23G1,
                              PublicKey23G2, PoKOfSignature23G1Protocol)
from ..kvac.bbdt16 import (MAC, MACParams, PoKOfMACProtocol, KVACSecretKey)
from ..bbs_plus.proof import MessageOrBlinding
from .base import Statement, ProofSystemError

F = bls.Fr


# ---------------------------------------------------------------------------
# Pointcheval-Sanders
# ---------------------------------------------------------------------------

@dataclass
class PSSigWitness:
    signature: PSSignature
    messages: list


@dataclass
class PoKPSSignature(Statement):
    params: PSSignatureParams
    public_key: PSPublicKey
    revealed_messages: dict

    def init_subprotocol(self, rng, blindings, witness: PSSigWitness):
        protocol = PSSignaturePoKProtocol.init(
            rng, witness.signature, witness.messages,
            set(self.revealed_messages), self.public_key, self.params,
            blindings=blindings)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.public_key, stmt.params,
                                                writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.public_key, self.params, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify(challenge, self.revealed_messages,
                            self.public_key, self.params,
                            pairing_checker=pairing_checker,
                            device=self.device):
            raise ProofSystemError("PS signature PoK failed")

    def response_for_witness(self, proof, wit_idx):
        return proof.response_for_message(wit_idx)


# ---------------------------------------------------------------------------
# BBS 2023
# ---------------------------------------------------------------------------

@dataclass
class BBS23Witness:
    signature: Signature23G1
    messages: list
    sig_randomizer: Optional[Fp] = None


@dataclass
class PoKBBSSignature23G1(Statement):
    params: SignatureParams23G1
    public_key: PublicKey23G2
    revealed_messages: dict

    def init_subprotocol(self, rng, blindings, witness: BBS23Witness):
        protocol = PoKOfSignature23G1Protocol.init(
            rng, witness.signature, self.params, witness.messages,
            set(self.revealed_messages),
            sig_randomizer=witness.sig_randomizer, blindings=blindings)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.revealed_messages,
                                                stmt.params, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.revealed_messages, self.params,
                                     writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        ok = proof.verify(self.revealed_messages, challenge, self.public_key,
                          self.params, pairing_checker=pairing_checker)
        if not ok:
            raise ProofSystemError("BBS23 PoK failed")

    def response_for_witness(self, proof, wit_idx):
        # witness is m*r — only comparable across BBS23 statements with a
        # shared signature randomizer
        return proof.response.get_response(
            proof.hidden_indices.index(wit_idx) + 1)


# ---------------------------------------------------------------------------
# BBDT16 KVAC
# ---------------------------------------------------------------------------

@dataclass
class KVACWitness:
    mac: MAC
    messages: list


@dataclass
class PoKBBDT16MAC(Statement):
    params: MACParams
    revealed_messages: dict

    def init_subprotocol(self, rng, blindings, witness: KVACWitness):
        mabs = []
        for i, m in enumerate(witness.messages):
            if i in self.revealed_messages:
                mabs.append(MessageOrBlinding.reveal_message(m))
            elif i in blindings:
                mabs.append(MessageOrBlinding.blind_with(m, blindings[i]))
            else:
                mabs.append(MessageOrBlinding.blind_randomly(m))
        protocol = PoKOfMACProtocol.init(rng, witness.mac, self.params, mabs)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.revealed_messages,
                                                stmt.params, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.revealed_messages, self.params,
                                     writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify_schnorr(self.revealed_messages, challenge,
                                    self.params):
            raise ProofSystemError("KVAC MAC PoK (schnorr) failed")

    def verify_with_key(self, proof, sk: KVACSecretKey) -> bool:
        """Designated key holder's extra check."""
        return (proof.B_0 * int(sk.x)) == proof.C

    def response_for_witness(self, proof, wit_idx):
        return proof.get_resp_for_message(wit_idx, set(self.revealed_messages))


@dataclass
class PoKBBDT16MACFullVerifier(PoKBBDT16MAC):
    """`bbdt16_kvac.rs` PoKOfMACFullVerifier: the verifier knows the MAC
    secret key and checks B_0 * x == C in addition to the Schnorr legs."""
    secret_key: KVACSecretKey = None

    def verify_proof(self, proof, challenge, pairing_checker=None):
        super().verify_proof(proof, challenge, pairing_checker)
        if not self.verify_with_key(proof, self.secret_key):
            raise ProofSystemError("KVAC MAC keyed check failed")
