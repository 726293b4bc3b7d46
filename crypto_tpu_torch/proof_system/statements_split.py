"""Prover/verifier statement splits, G2 Pedersen and the BBS23-IETF
statements: the port's own copy of
`crypto_tpu/proof_system/statements_split.py`.

The reference keeps SEPARATE Statement variants for the prover and verifier
sides of signature statements (`statement/mod.rs:33,96-97,131-133`): the
prover variant carries only public data the prover needs (params, revealed
messages), the verifier variant additionally holds the public key.  This
module provides those spellings (a prover-side statement refuses to
verify) plus:

* `PedersenCommitmentG2` (`statement/mod.rs:103`): the G1 Pedersen
  statement's protocol over G2 bases (the host `Point` covers both).
* `PoKBBSSignature23IETFG1Prover` / `...Verifier` (`statement/mod.rs:
  132-133`): the IETF-draft-compatible single-relation BBS PoK
  (`bbs_plus/bbs23.py` `PoKOfSignature23IETFProtocol`); its pairs defer
  into the verifier's shared checker when there is one, else pair on the
  host.
* the named aliases of the other reference variants, among them `VeTZ21`
  and `VeTZ21Robust` over `statements_ranges.VerifiableEncryptionTZ21`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..bbs_plus.bbs23 import (PoKOfSignature23IETFProtocol, PublicKey23G2,
                              SignatureParams23G1)
from ..curves import bls12_381 as bls
from ..serialize import ByteWriter
from .base import ProofSystemError, Statement
from .statements import (KBUniversalAccumulatorMembership,
                         KBUniversalAccumulatorNonMembership,
                         PedersenCommitmentStmt, PoKBBSSignatureG1,
                         VBAccumulatorMembershipCDH,
                         VBAccumulatorNonMembershipCDH)
from .statements_more import BBS23Witness, PoKBBSSignature23G1
from .statements_ranges import R1CSCircomStatement, VerifiableEncryptionTZ21
from .statements_snark import BoundCheckLegoGroth16, SaverStatement

F = bls.Fr


@dataclass
class PedersenCommitmentG2(PedersenCommitmentStmt):
    """Pedersen commitment opening over G2 bases
    (`statement/mod.rs:103`).  The Schnorr machinery is curve-generic, so
    the implementation is shared with the G1 statement."""


class _ProverSideMixin:
    """A prover-side statement never verifies; the verifier uses the
    matching *Verifier statement (reference prover/verifier split)."""

    def verify_proof(self, proof, challenge, pairing_checker=None):
        raise ProofSystemError(
            f"{type(self).__name__} is a prover-side statement; use the "
            "matching Verifier statement to verify")


@dataclass
class PoKBBSSignatureG1Prover(_ProverSideMixin, PoKBBSSignatureG1):
    """Prover-side BBS+ statement (`statement/mod.rs:33`): carries no
    public key.  Construct as `PoKBBSSignatureG1Prover(params,
    revealed_messages=...)`."""
    public_key: object = None
    revealed_messages: dict = dc_field(default_factory=dict)


@dataclass
class PoKBBSSignatureG1Verifier(PoKBBSSignatureG1):
    """Verifier-side BBS+ statement (`statement/mod.rs:96`)."""


@dataclass
class PoKBBSSignature23G1Prover(_ProverSideMixin, PoKBBSSignature23G1):
    """Prover-side BBS-2023 statement (`statement/mod.rs:42`)."""
    public_key: object = None
    revealed_messages: dict = dc_field(default_factory=dict)


@dataclass
class PoKBBSSignature23G1Verifier(PoKBBSSignature23G1):
    """Verifier-side BBS-2023 statement (`statement/mod.rs:97`)."""


# ---------------------------------------------------------------------------
# BBS23 IETF-draft variant statements
# ---------------------------------------------------------------------------

@dataclass
class PoKBBSSignature23IETFG1Verifier(Statement):
    """IETF-draft BBS PoK statement, verifier side
    (`statement/mod.rs:133`; protocol `bbs_plus/src/proof_23_ietf.rs`).
    Witness indexing: witness i = message m_i (responses exist only for
    hidden messages)."""
    params: SignatureParams23G1
    public_key: PublicKey23G2
    revealed_messages: dict

    def init_subprotocol(self, rng, blindings, witness: BBS23Witness):
        protocol = PoKOfSignature23IETFProtocol.init(
            rng, witness.signature, self.params, witness.messages,
            set(self.revealed_messages), blindings=blindings)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.revealed_messages,
                                                stmt.params, writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        proof.challenge_contribution(self.revealed_messages, self.params,
                                     writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        ok = proof.verify(self.revealed_messages, challenge, self.public_key,
                          self.params, pairing_checker=pairing_checker)
        if not ok:
            raise ProofSystemError("BBS23-IETF PoK failed")

    def response_for_witness(self, proof, wit_idx):
        return proof.get_resp_for_message(proof.hidden_indices.index(wit_idx))


@dataclass
class PoKBBSSignature23IETFG1Prover(_ProverSideMixin,
                                    PoKBBSSignature23IETFG1Verifier):
    """Prover-side IETF BBS statement (`statement/mod.rs:132`)."""
    public_key: object = None
    revealed_messages: dict = dc_field(default_factory=dict)


# ---------------------------------------------------------------------------
# remaining reference-variant spellings (`statement/mod.rs:31-139`): the
# package's combined classes serve both roles; these named aliases make each
# reference variant addressable 1:1.
# ---------------------------------------------------------------------------


@dataclass
class VBAccumulatorMembershipCDHProver(_ProverSideMixin,
                                       VBAccumulatorMembershipCDH):
    """`statement/mod.rs:55` (prover side carries no public key)."""
    public_key: object = None


class VBAccumulatorMembershipCDHVerifier(VBAccumulatorMembershipCDH):
    """`statement/mod.rs:56`."""


@dataclass
class VBAccumulatorNonMembershipCDHProver(_ProverSideMixin,
                                          VBAccumulatorNonMembershipCDH):
    """`statement/mod.rs:57`; construct as `...Prover(value, params, Q=Q)`."""
    public_key: object = None
    Q: object = None


class VBAccumulatorNonMembershipCDHVerifier(VBAccumulatorNonMembershipCDH):
    """`statement/mod.rs:58`."""


@dataclass
class KBUniversalAccumulatorMembershipCDHProver(
        _ProverSideMixin, KBUniversalAccumulatorMembership):
    """`statement/mod.rs:59`."""
    public_key: object = None


class KBUniversalAccumulatorMembershipCDHVerifier(
        KBUniversalAccumulatorMembership):
    """`statement/mod.rs:60`."""


@dataclass
class KBUniversalAccumulatorNonMembershipCDHProver(
        _ProverSideMixin, KBUniversalAccumulatorNonMembership):
    """`statement/mod.rs:61`."""
    public_key: object = None


class KBUniversalAccumulatorNonMembershipCDHVerifier(
        KBUniversalAccumulatorNonMembership):
    """`statement/mod.rs:62`."""


class SaverProver(SaverStatement):
    """`statement/mod.rs:36` — the package's SaverStatement carries both the
    proving and verifying material; this spelling marks prover usage."""


class SaverVerifier(SaverStatement):
    """`statement/mod.rs:37` (verification uses only `snark_pk.vk`)."""


class BoundCheckLegoGroth16Prover(BoundCheckLegoGroth16):
    """`statement/mod.rs:38`."""


class BoundCheckLegoGroth16Verifier(BoundCheckLegoGroth16):
    """`statement/mod.rs:39`."""


class R1CSCircomProver(R1CSCircomStatement):
    """`statement/mod.rs:40`."""


class R1CSCircomVerifier(R1CSCircomStatement):
    """`statement/mod.rs:41`."""


class VeTZ21(VerifiableEncryptionTZ21):
    """`statement/mod.rs:134` (DKGitH)."""


@dataclass
class VeTZ21Robust(VerifiableEncryptionTZ21):
    """`statement/mod.rs:136` (Robust DKGitH: one MPC instance, reveal-
    threshold soundness).  `n_parties`/`reps` become the RDkgith
    (num_parties, revealed-threshold) pair."""
    variant: str = "rdkgith"
    n_parties: int = 16
    reps: int = 12
