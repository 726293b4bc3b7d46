"""Composite proof creation and verification: the port's own copy of
`crypto_tpu/proof_system/proof.py` (reference
`proof_system/src/{prover,verifier}.rs`).

`Proof.new` and `Proof.verify` take `device` (CUDA unless the caller names
the CPU; raises without a card): the statements' SNARK provers and
routed pairings run there, and so does the verifier's shared
`RandomizedPairingChecker`, whose lazy Miller product over every deferred
pair is one batched device call from the checker's `DEVICE_THRESHOLD`
pairs on.  SnarkPack aggregates are made and checked by
`legogroth16/aggregation.py` on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..legogroth16 import aggregation as aggr
from ..serialize import ByteWriter
from ..transcript.transcript import Transcript
from ..utils.checkers import RandomizedPairingChecker
from .base import (COMPOSITE_PROOF_CHALLENGE_LABEL, COMPOSITE_PROOF_LABEL,
                   CONTEXT_LABEL, NONCE_LABEL, ProofSpec, ProofSystemError,
                   WitnessRef)

F = bls.Fr


@dataclass
class VerifierConfig:
    """`verifier.rs:72-76`: enable the shared randomized pairing checker."""
    use_lazy_randomized_pairing_checks: Optional[bool] = None


@dataclass
class OldSaverProof:
    """SAVER randomness, ciphertext and proof from a previous composite
    proof, reusable via rerandomization (`prover.rs:76-83`)."""
    v: Fp                  # total encryption randomness r
    ciphertext: object
    proof: object


@dataclass
class OldLegoGroth16Proof:
    """LegoGroth16 commitment randomness + proof from a previous composite
    proof (`prover.rs:84-88`)."""
    v: Fp
    proof: object


@dataclass
class ProverConfig:
    """Passed to `Proof.new` (`prover.rs:90-120`).  Maps statement index ->
    old proof material to reuse (cheaper than a fresh SNARK proof; the old
    material is rerandomized so proofs stay unlinkable).  After proving,
    `commitment_randomness` holds each reusing-capable statement's fresh
    randomness so THIS proof can seed the next `ProverConfig`."""
    reuse_saver_proofs: Optional[dict] = None
    reuse_legogroth16_proofs: Optional[dict] = None
    commitment_randomness: dict = None

    def __post_init__(self):
        if self.commitment_randomness is None:
            self.commitment_randomness = {}

    def old_proof_for(self, idx: int):
        for m in (self.reuse_saver_proofs, self.reuse_legogroth16_proofs):
            if m and idx in m:
                return m[idx]
        return None


@dataclass
class Proof:
    statement_proofs: list
    nonce: Optional[bytes] = None
    # [(statement indices, AggregateProof)] when the spec aggregates SNARKs
    aggregated_groth16: Optional[list] = None
    aggregated_legogroth16: Optional[list] = None

    # ------------------------------------------------------------------

    @classmethod
    def new(cls, rng, proof_spec: ProofSpec, witnesses: list,
            nonce: Optional[bytes] = None,
            config: Optional["ProverConfig"] = None,
            device="cuda") -> "Proof":
        """`prover.rs:139`: validate -> equivalence classes -> shared
        blindings -> round 1 commits + transcript -> challenge -> round 2."""
        device = resolve_device(device)
        proof_spec.validate()
        if len(witnesses) != len(proof_spec.statements):
            raise ProofSystemError("witness count != statement count")

        classes = proof_spec.meta_statements.disjoint_witness_equalities()
        blindings_by_ref: dict[WitnessRef, Fp] = {}
        for cls_refs in classes:
            shared = F.rand(rng)
            for ref in cls_refs:
                blindings_by_ref[ref] = shared

        transcript = _transcript(proof_spec, nonce)
        resolved = proof_spec.resolved_statements(device)
        subprotocols = []
        for idx, (stmt, wit) in enumerate(zip(resolved, witnesses)):
            stmt_blindings = {
                ref.witness: bl for ref, bl in blindings_by_ref.items()
                if ref.statement == idx
            }
            old = config.old_proof_for(idx) if config is not None else None
            if old is not None:
                sp = stmt.init_subprotocol_with_old(rng, stmt_blindings,
                                                    wit, old)
            else:
                sp = stmt.init_subprotocol(rng, stmt_blindings, wit)
            if config is not None and hasattr(sp, "commitment_randomness"):
                config.commitment_randomness[idx] = sp.commitment_randomness
            w = ByteWriter()
            sp.challenge_contribution(w)
            transcript.append_message(b"", w.bytes())
            subprotocols.append(sp)

        challenge = transcript.challenge_scalar(
            F, COMPOSITE_PROOF_CHALLENGE_LABEL)

        statement_proofs = [sp.gen_proof(challenge) for sp in subprotocols]

        # SnarkPack aggregation (`prover.rs:1040-1105`): fold the SNARKs of
        # the designated statements into one aggregate per group, stripping
        # them from the per-statement proofs.
        aggregated_groth16 = None
        aggregated_legogroth16 = None
        if proof_spec.aggregated_statement_indices():
            srs = proof_spec.snark_aggregation_srs

            def _aggregate(groups, with_d):
                out = []
                for group in groups:
                    snarks = []
                    for i in group:
                        stmt = resolved[i]
                        snark_proof, stripped = stmt.strip_snark_proof(
                            statement_proofs[i])
                        statement_proofs[i] = stripped
                        if not with_d:
                            snark_proof = type(snark_proof)(
                                a=snark_proof.a, b=snark_proof.b,
                                c=snark_proof.c, d=None)
                        snarks.append(snark_proof)
                    out.append((list(group), aggr.aggregate_proofs(
                        srs, transcript, snarks, device)))
                return out

            if proof_spec.aggregate_groth16:
                aggregated_groth16 = _aggregate(
                    proof_spec.aggregate_groth16, with_d=False)
            if proof_spec.aggregate_legogroth16:
                aggregated_legogroth16 = _aggregate(
                    proof_spec.aggregate_legogroth16, with_d=True)

        return cls(
            statement_proofs=statement_proofs, nonce=nonce,
            aggregated_groth16=aggregated_groth16,
            aggregated_legogroth16=aggregated_legogroth16)

    # ------------------------------------------------------------------

    def get_saver_ciphertext_and_proof(self, idx: int):
        """Extract the SAVER material of statement `idx` for reuse in a
        later `ProverConfig` (`proof.rs` helper of the same name); combine
        with the `commitment_randomness` captured at proving time."""
        sp = self.statement_proofs[idx]
        return sp.ciphertext, sp.snark_proof

    def get_legogroth16_proof(self, idx: int):
        return self.statement_proofs[idx].snark_proof

    # ------------------------------------------------------------------

    def verify(self, rng, proof_spec: ProofSpec,
               nonce: Optional[bytes] = None,
               config: Optional[VerifierConfig] = None,
               device="cuda") -> bool:
        """`verifier.rs:128`: rebuild transcript, recompute challenge, verify
        every statement proof, check cross-statement response equality, run
        the accumulated pairing check once."""
        device = resolve_device(device)
        proof_spec.validate()
        if len(self.statement_proofs) != len(proof_spec.statements):
            raise ProofSystemError("proof count != statement count")

        pairing_checker = None
        if config is not None and config.use_lazy_randomized_pairing_checks is not None:
            pairing_checker = RandomizedPairingChecker(
                F.rand(rng), lazy=config.use_lazy_randomized_pairing_checks,
                device=device)

        transcript = _transcript(proof_spec, nonce)
        resolved = proof_spec.resolved_statements(device)
        for stmt, sp in zip(resolved, self.statement_proofs):
            w = ByteWriter()
            stmt.proof_challenge_contribution(sp, w)
            transcript.append_message(b"", w.bytes())

        challenge = transcript.challenge_scalar(
            F, COMPOSITE_PROOF_CHALLENGE_LABEL)

        # cross-statement equality: responses in each class must agree
        for cls_refs in proof_spec.meta_statements.disjoint_witness_equalities():
            resp = None
            for ref in sorted(cls_refs, key=lambda r: (r.statement, r.witness)):
                stmt = resolved[ref.statement]
                r = stmt.response_for_witness(
                    self.statement_proofs[ref.statement], ref.witness)
                if resp is None:
                    resp = r
                elif resp != r:
                    raise ProofSystemError(
                        f"witness equality violated at {ref}")

        aggregated = proof_spec.aggregated_statement_indices()
        for idx, (stmt, sp) in enumerate(zip(resolved,
                                             self.statement_proofs)):
            if idx in aggregated:
                stmt.verify_proof_when_aggregating(sp, challenge,
                                                   pairing_checker)
            else:
                stmt.verify_proof(sp, challenge, pairing_checker)

        if aggregated:
            self._verify_aggregates(rng, proof_spec, resolved, transcript,
                                    device)

        if pairing_checker is not None and not pairing_checker.verify():
            raise ProofSystemError("accumulated pairing check failed")
        return True

    def _verify_aggregates(self, rng, proof_spec, resolved, transcript,
                           device):
        """`verifier.rs:1749-1830`: check each SnarkPack aggregate against
        the per-statement public data (SAVER ciphertexts / bound-check
        public inputs)."""
        srs = proof_spec.snark_aggregation_srs

        def _check_groups(spec_groups, proof_groups, lego):
            spec_groups = spec_groups or []
            proof_groups = proof_groups or []
            if len(spec_groups) != len(proof_groups):
                raise ProofSystemError("aggregate group count mismatch")
            for spec_g, (proof_g, ag_proof) in zip(spec_groups,
                                                   proof_groups):
                if list(spec_g) != list(proof_g):
                    raise ProofSystemError(
                        "aggregate statement indices mismatch")
                stmts = [resolved[i] for i in spec_g]
                sps = [self.statement_proofs[i] for i in spec_g]
                if lego:
                    vk = stmts[0].snark_pk.vk
                    inputs = [st.aggregate_public_inputs(sp)
                              for st, sp in zip(stmts, sps)]
                    ok = aggr.verify_aggregate_proof(
                        srs, vk, inputs, ag_proof, rng, transcript,
                        device=device)
                else:
                    vk = stmts[0].snark_pk.pk.vk
                    prepared = [st.prepared_aggregate_input(sp)
                                for st, sp in zip(stmts, sps)]
                    ok = aggr.verify_aggregate_proof(
                        srs, vk, [[] for _ in prepared], ag_proof, rng,
                        transcript, prepared_inputs=prepared, device=device)
                if not ok:
                    raise ProofSystemError("SNARK aggregate check failed")

        _check_groups(proof_spec.aggregate_groth16,
                      self.aggregated_groth16, lego=False)
        _check_groups(proof_spec.aggregate_legogroth16,
                      self.aggregated_legogroth16, lego=True)


def _transcript(proof_spec: ProofSpec, nonce: Optional[bytes]) -> Transcript:
    """The composite transcript with the nonce and the spec's context."""
    transcript = Transcript(COMPOSITE_PROOF_LABEL)
    if nonce is not None:
        transcript.append_message(NONCE_LABEL, nonce)
    if proof_spec.context is not None:
        transcript.append_message(CONTEXT_LABEL, proof_spec.context)
    return transcript
