"""R1CS constraint system: the port's own host copy of
`crypto_tpu/r1cs/cs.py` (the `ark-relations` `ConstraintSystem` surface
the SNARK layer builds on).

Variables are global indices: 0 is the constant ONE (first instance
variable), then public inputs, then witnesses: arkworks' full assignment
layout `[instance | witness]`.  Constraints are rows of sparse linear
combinations (A, B, C) with `<A,z> * <B,z> = <C,z>`.

Circuits are callables `circuit(cs)` (the `ConstraintSynthesizer` idiom)
that reach the system only through its methods and the variables it
hands out, so a circuit written against this API runs on either copy;
`cs.mode` distinguishes setup (no assignments) from proving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..fields.host import Field, Fp


class SynthesisError(Exception):
    pass


@dataclass(frozen=True)
class Variable:
    index: int  # global index into the full assignment

    def lc(self, coeff=None):
        return LinearCombination([(coeff, self)]) if coeff is not None else \
            LinearCombination([(None, self)])


ONE = Variable(0)


class LinearCombination:
    """Sparse sum of coeff * variable; coeff None means 1."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = list(terms or [])

    @classmethod
    def zero(cls):
        return cls([])

    @classmethod
    def from_var(cls, v: Variable):
        return cls([(None, v)])

    @classmethod
    def constant(cls, F: Field, c):
        return cls([(F(int(c)), ONE)])

    def __add__(self, other):
        if isinstance(other, Variable):
            other = LinearCombination.from_var(other)
        return LinearCombination(self.terms + other.terms)

    def __sub__(self, other):
        if isinstance(other, Variable):
            other = LinearCombination.from_var(other)
        return self + other.scale_int(-1)

    def scale(self, c: Fp):
        return LinearCombination(
            [((c if co is None else co * c), v) for co, v in self.terms])

    def scale_int(self, k: int):
        out = []
        for co, v in self.terms:
            F = bls.Fr if co is None else co.f
            co = F(1) if co is None else co
            out.append((co * k, v))
        return LinearCombination(out)

    def rows(self, F: Field):
        """Normalized sparse row [(coeff_int, index)] with coeffs combined."""
        acc = {}
        for co, v in self.terms:
            c = 1 if co is None else int(co)
            acc[v.index] = (acc.get(v.index, 0) + c) % F.p
        return [(c, i) for i, c in sorted(acc.items()) if c != 0]


class ConstraintSystem:
    def __init__(self, F: Field = None, mode: str = "prove"):
        self.F = F or bls.Fr
        self.mode = mode          # "setup" | "prove"
        self.instance_assignment = [self.F(1)]
        self.witness_assignment = []
        self.num_instance = 1
        self.num_witness = 0
        self.a_rows = []
        self.b_rows = []
        self.c_rows = []
        self._witness_offset_known = False

    # -- allocation --

    def new_input(self, value: Optional[Fp] = None) -> Variable:
        if self.num_witness:
            raise SynthesisError("allocate all public inputs before witnesses")
        idx = self.num_instance
        self.num_instance += 1
        if self.mode == "prove":
            if value is None:
                raise SynthesisError("missing input assignment")
            self.instance_assignment.append(value)
        return Variable(idx)

    def new_witness(self, value: Optional[Fp] = None) -> Variable:
        if self.num_witness == 0:
            self._first_witness = self.num_instance
        idx = self._first_witness + self.num_witness
        self.num_witness += 1
        if self.mode == "prove":
            if value is None:
                raise SynthesisError("missing witness assignment")
            self.witness_assignment.append(value)
        return Variable(idx)

    # -- constraints --

    def enforce(self, a: LinearCombination, b: LinearCombination,
                c: LinearCombination) -> None:
        F = self.F
        self.a_rows.append(a.rows(F))
        self.b_rows.append(b.rows(F))
        self.c_rows.append(c.rows(F))

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    # -- assignment access --

    def full_assignment(self):
        return self.instance_assignment + self.witness_assignment

    def is_satisfied(self) -> bool:
        z = [int(v) for v in self.full_assignment()]
        p = self.F.p
        for ar, br, cr in zip(self.a_rows, self.b_rows, self.c_rows):
            a = sum(c * z[i] for c, i in ar) % p
            bb = sum(c * z[i] for c, i in br) % p
            cc = sum(c * z[i] for c, i in cr) % p
            if a * bb % p != cc:
                return False
        return True


def evaluate_row(row, assignment_ints, p) -> int:
    """<row, z> (reference `r1cs_to_qap.rs:15-44` evaluate_constraint)."""
    return sum(c * assignment_ints[i] for c, i in row) % p
