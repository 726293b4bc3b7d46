"""Derived-parameter dedupe across statements: the port's own copy of
`crypto_tpu/proof_system/derived_params.py` (reference
`proof_system/src/derived_params.rs:50-108`, used from
`proof_spec.rs:228`).

The reference's `DerivedParamsTracker` derives each distinct parameter
object's derived material (prepared verifying keys, chunked/derived
commitment keys) ONCE per proof spec and hands every statement that shares
the underlying params the same derived value.  Here the tracker keys by
object identity: `ProofSpec.derive_prepared_parameters()` creates it, the
spec's `resolved_statements()` attaches it to each statement, and statement
code routes derivations through `Statement.derived(...)`.
"""

from __future__ import annotations


class DerivedParamsTracker:
    """Identity-keyed once-per-spec derivation cache.

    Holding a strong reference to the keyed object keeps its `id` stable for
    the tracker's lifetime (a ProofSpec), so identity keying is sound.
    `derivations` counts actual derive() calls — the dedupe observable the
    tests assert on.
    """

    def __init__(self):
        self._store: dict = {}
        self.derivations = 0

    def get(self, kind: str, obj, derive):
        key = (kind, id(obj))
        ent = self._store.get(key)
        if ent is None:
            self.derivations += 1
            ent = (obj, derive(obj))
            self._store[key] = ent
        return ent[1]
