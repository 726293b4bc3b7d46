"""Composite proof system core types: the port's own copy of
`crypto_tpu/proof_system/base.py` (reference `proof_system/src/`).

A `ProofSpec` is a list of `Statement`s plus `MetaStatement`s (cross-statement
witness equalities) and optional shared `SetupParams`.  Proof creation runs
every statement's sigma sub-protocol under ONE merlin transcript; equality of
witnesses across statements is enforced by sharing the Schnorr blinding per
equivalence class, making the responses equal (Chaum-Pedersen style,
reference `proof_system/src/lib.rs:25-33`).

`ProofSpec.resolved_statements(device)` hands each statement the device
its pairings, SNARK provers and checkers run on (`Statement.device`: CUDA
unless the caller names the CPU, as every entry point of the port).
"""

from __future__ import annotations

import copy
import dataclasses
from abc import ABC, abstractmethod
from dataclasses import dataclass, field as dc_field
from typing import Optional

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..serialize import ByteWriter

F = bls.Fr

COMPOSITE_PROOF_LABEL = b"composite-proof"
COMPOSITE_PROOF_CHALLENGE_LABEL = b"composite-proof-challenge"
NONCE_LABEL = b"nonce"
CONTEXT_LABEL = b"context"


class ProofSystemError(Exception):
    pass


class Statement(ABC):
    """A single relation; knows how to build its prover-side sub-protocol and
    how to verify its statement proof."""

    @abstractmethod
    def init_subprotocol(self, rng, blindings: dict, witness):
        """-> sub-protocol object with challenge_contribution/gen_proof.
        `blindings`: {witness_index: Fp} for externally-forced blindings
        (shared equivalence classes)."""

    @abstractmethod
    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        """Append the verifier-side challenge contribution of `proof`."""

    @abstractmethod
    def verify_proof(self, proof, challenge: Fp, pairing_checker=None):
        """Raises ProofSystemError on failure."""

    @abstractmethod
    def response_for_witness(self, proof, wit_idx: int) -> Fp:
        """Schnorr response for witness `wit_idx` (for equality checks)."""

    def derived(self, kind: str, obj, derive):
        """Route a params derivation through the spec's
        `DerivedParamsTracker` when attached (reference
        `derived_params.rs:50-108`): statements sharing `obj` get one
        derivation.  Standalone statements just derive directly."""
        tracker = getattr(self, "_derived_tracker", None)
        if tracker is None:
            return derive(obj)
        return tracker.get(kind, obj, derive)

    @property
    def device(self):
        """Where this statement's pairings and provers run: the device
        `ProofSpec.resolved_statements` gave it, else CUDA."""
        return getattr(self, "_device", "cuda")


@dataclass(frozen=True)
class SetupParamsRef:
    """Reference to a shared setup-params entry on the ProofSpec
    (reference `setup_params.rs`: large parameters — signature params,
    keys, SNARK SRSs — are stored once and referenced by index from many
    statements instead of being duplicated)."""
    index: int


def resolve_setup_params(stmt, setup_params: list):
    """Return `stmt` with every SetupParamsRef field replaced by the
    referenced entry (a new instance; the spec stays untouched)."""
    if not dataclasses.is_dataclass(stmt):
        return stmt
    changes = {}
    for f in dataclasses.fields(stmt):
        v = getattr(stmt, f.name)
        if isinstance(v, SetupParamsRef):
            if v.index >= len(setup_params):
                raise ProofSystemError(
                    f"setup params index {v.index} out of bounds")
            changes[f.name] = setup_params[v.index]
    return dataclasses.replace(stmt, **changes) if changes else stmt


@dataclass(frozen=True)
class WitnessRef:
    statement: int
    witness: int


@dataclass
class EqualWitnesses:
    refs: set  # set[WitnessRef]


@dataclass
class MetaStatements:
    equalities: list = dc_field(default_factory=list)

    def add_witness_equality(self, refs) -> None:
        self.equalities.append(EqualWitnesses(
            {r if isinstance(r, WitnessRef) else WitnessRef(*r) for r in refs}))

    def disjoint_witness_equalities(self) -> list[set]:
        """Union-find merge of overlapping equality sets
        (`meta_statement.rs` disjoint_witness_equalities)."""
        classes: list[set] = []
        for eq in self.equalities:
            merged = set(eq.refs)
            keep = []
            for cls in classes:
                if cls & merged:
                    merged |= cls
                else:
                    keep.append(cls)
            keep.append(merged)
            classes = keep
        return classes


@dataclass
class ProofSpec:
    statements: list = dc_field(default_factory=list)
    meta_statements: MetaStatements = dc_field(default_factory=MetaStatements)
    context: Optional[bytes] = None
    # SnarkPack aggregation (reference `proof_spec.rs` aggregate_groth16/
    # aggregate_legogroth16/snark_aggregation_srs): each entry is a list of
    # statement indices whose SNARK proofs are folded into ONE aggregate;
    # the per-statement proofs then omit their SNARK (smaller proof,
    # cheaper verification).
    aggregate_groth16: Optional[list] = None       # SAVER statements
    aggregate_legogroth16: Optional[list] = None   # bound-check / R1CS
    snark_aggregation_srs: object = None           # ProverSRS or VerifierSRS
    setup_params: list = dc_field(default_factory=list)

    def add_statement(self, stmt: Statement) -> int:
        self.statements.append(stmt)
        return len(self.statements) - 1

    def add_setup_params(self, params) -> SetupParamsRef:
        self.setup_params.append(params)
        return SetupParamsRef(len(self.setup_params) - 1)

    def derive_prepared_parameters(self):
        """The spec's shared `DerivedParamsTracker` (created on first use,
        reused across prove/verify calls on this spec — reference
        `proof_spec.rs:228` derive_commitment_keys/derive_prepared_parameters
        collapsed into one identity-keyed tracker)."""
        from .derived_params import DerivedParamsTracker
        tracker = getattr(self, "_derived", None)
        if tracker is None:
            tracker = DerivedParamsTracker()
            object.__setattr__(self, "_derived", tracker)
        return tracker

    def resolved_statements(self, device="cuda") -> list:
        tracker = self.derive_prepared_parameters()
        out = []
        for s in self.statements:
            r = resolve_setup_params(s, self.setup_params)
            if r is s:
                r = copy.copy(s)    # never mutate the caller's statement
            object.__setattr__(r, "_derived_tracker", tracker)
            object.__setattr__(r, "_device", device)
            out.append(r)
        return out

    def add_witness_equality(self, refs) -> None:
        self.meta_statements.add_witness_equality(refs)

    def aggregated_statement_indices(self) -> set:
        out = set()
        for group in (self.aggregate_groth16 or []):
            out.update(group)
        for group in (self.aggregate_legogroth16 or []):
            out.update(group)
        return out

    def validate(self) -> None:
        n = len(self.statements)
        for eq in self.meta_statements.equalities:
            if len(eq.refs) < 2:
                raise ProofSystemError("equality needs at least 2 references")
            for r in eq.refs:
                if r.statement >= n:
                    raise ProofSystemError("statement index out of bounds")
        seen = set()
        for group in (self.aggregate_groth16 or []) + \
                (self.aggregate_legogroth16 or []):
            for i in group:
                if i in seen:
                    raise ProofSystemError(
                        f"statement {i} in multiple aggregate groups")
                seen.add(i)
                if i >= n:
                    raise ProofSystemError("aggregate index out of bounds")
        if seen and self.snark_aggregation_srs is None:
            raise ProofSystemError("snark aggregation SRS not provided")
