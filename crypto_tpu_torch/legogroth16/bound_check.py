"""Bound check via LegoGroth16 (reference
`legogroth16/src/circuit.rs:303-340` + `proof_system/src/sub_protocols/bound_check_legogroth16.rs`):
the port's copy of `crypto_tpu/legogroth16/bound_check.py`.

Circuit: public inputs (min, max), committed witness w; enforce
min <= w < max by 64-bit decompositions of (w - min) and (max - 1 - w)
(attribute values are assumed < 2^64, as in credential practice).
commit_witness_count = 1 so w lands in the proof's D commitment, enabling
Schnorr linkage of w with other statements.  The CRS and the proofs come
from the port's prover on `device` (CUDA unless the caller names the
CPU); the verifier is its host `verify_proof`.
"""

from __future__ import annotations

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..r1cs.cs import ConstraintSystem, LinearCombination, ONE
from . import snark

F = bls.Fr
BOUND_BITS = 64


def bound_check_circuit(min_val=None, max_val=None, value=None):
    """min <= value < max with 64-bit range decompositions."""
    def circuit(cs: ConstraintSystem):
        mn = cs.new_input(None if min_val is None else F(int(min_val)))
        mx = cs.new_input(None if max_val is None else F(int(max_val)))
        w = cs.new_witness(None if value is None else F(int(value)))

        def enforce_64bit(lc, val_int):
            """allocate bits summing to the given linear combination."""
            terms = []
            for j in range(BOUND_BITS):
                bv = None
                if val_int is not None:
                    bv = F((val_int >> j) & 1)
                b_var = cs.new_witness(bv)
                one_minus = LinearCombination.from_var(ONE) - b_var.lc()
                cs.enforce(b_var.lc(), one_minus, LinearCombination.zero())
                terms.append((F(1 << j), b_var))
            cs.enforce(LinearCombination(terms),
                       LinearCombination.from_var(ONE), lc)

        d1 = None if value is None else int(value) - int(min_val)
        d2 = None if value is None else int(max_val) - 1 - int(value)
        if d1 is not None and (d1 < 0 or d2 < 0):
            raise snark.LegoGroth16Error("value out of bounds")
        enforce_64bit(w.lc() - mn.lc(), d1)
        # (max - 1 - w) = max - w - 1
        lc2 = mx.lc() - w.lc() - LinearCombination.constant(F, 1)
        enforce_64bit(lc2, d2)
    return circuit


def generate_snark_srs_bound_check(rng, device="cuda") -> snark.ProvingKey:
    """(`bound_check_legogroth16.rs` generate_snark_srs_bound_check)."""
    return snark.generate_random_parameters(bound_check_circuit(), 1, rng,
                                            device=device)


def prove_bound_check(pk: snark.ProvingKey, value: int, min_val: int,
                      max_val: int, rng, v: Fp | None = None,
                      device="cuda"):
    proof, v_out, committed = snark.create_proof(
        bound_check_circuit(min_val, max_val, value), pk, rng, v=v,
        device=device)
    return proof, v_out


def verify_bound_check(pvk: snark.PreparedVerifyingKey, proof: snark.Proof,
                       min_val: int, max_val: int) -> bool:
    return snark.verify_proof(pvk, proof, [F(int(min_val)), F(int(max_val))])
