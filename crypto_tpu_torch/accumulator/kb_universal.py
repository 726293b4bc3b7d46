"""KB universal accumulator: the port's own copy of
`crypto_tpu/accumulator/kb_universal.py` (reference
`vb_accumulator/src/kb_universal_accumulator/`, paper 2021/638): a
universal accumulator built from TWO positive VB accumulators, one
accumulating the members, one accumulating the non-members of a fixed
domain.

Adding an element moves it from the non-membership accumulator to the
membership accumulator; removing does the reverse.  (Non)membership
witnesses are plain positive-accumulator membership witnesses in the
respective accumulator, so all the existing witness-update machinery and
the weak-BB-style CDH proofs apply unchanged.

The batch witness methods take `device=` (CUDA unless the caller names
the CPU; raises without a card) and go through the half's own
`PositiveAccumulator.get_membership_witnesses_for_batch`: one host batch
inverse and the device fixed-base table from 512 elements
(`utils/msm.py`).  The reference's loop over single host witnesses (one
host scalar multiplication an element) gives the same points.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from .core import AccumulatorError, MembershipWitness, PositiveAccumulator
from .persistence import InMemoryState
from .setup import AccumPublicKey, AccumSecretKey, AccumSetupParams

F = bls.Fr


@dataclass
class KBUniversalAccumulator:
    mem: PositiveAccumulator
    non_mem: PositiveAccumulator

    @classmethod
    def initialize(cls, params: AccumSetupParams, sk: AccumSecretKey,
                   domain, mem_state: InMemoryState,
                   non_mem_state: InMemoryState) -> "KBUniversalAccumulator":
        mem = PositiveAccumulator.initialize(params)
        non_mem = PositiveAccumulator.initialize(params)
        non_mem = non_mem.add_batch(list(domain), sk, non_mem_state)
        return cls(mem=mem, non_mem=non_mem)

    def extend_domain(self, new_elements, sk, non_mem_state):
        return KBUniversalAccumulator(
            mem=self.mem,
            non_mem=self.non_mem.add_batch(list(new_elements), sk,
                                           non_mem_state))

    def add(self, element: Fp, sk, mem_state, non_mem_state):
        if not non_mem_state.has(element):
            raise AccumulatorError("element not in domain or already added")
        return KBUniversalAccumulator(
            mem=self.mem.add(element, sk, mem_state),
            non_mem=self.non_mem.remove(element, sk, non_mem_state))

    def remove(self, element: Fp, sk, mem_state, non_mem_state):
        return KBUniversalAccumulator(
            mem=self.mem.remove(element, sk, mem_state),
            non_mem=self.non_mem.add(element, sk, non_mem_state))

    def add_batch(self, elements, sk, mem_state, non_mem_state):
        return KBUniversalAccumulator(
            mem=self.mem.add_batch(elements, sk, mem_state),
            non_mem=self.non_mem.remove_batch(elements, sk, non_mem_state))

    def remove_batch(self, elements, sk, mem_state, non_mem_state):
        """`accumulator.rs:127-148`."""
        return KBUniversalAccumulator(
            mem=self.mem.remove_batch(elements, sk, mem_state),
            non_mem=self.non_mem.add_batch(elements, sk, non_mem_state))

    def batch_updates(self, additions, removals, sk, mem_state,
                      non_mem_state):
        """Simultaneous additions+removals (`accumulator.rs:149-182`): the
        non-member half takes the removals as additions and the additions
        as removals."""
        return KBUniversalAccumulator(
            mem=self.mem.batch_updates(additions, removals, sk, mem_state),
            non_mem=self.non_mem.batch_updates(removals, additions, sk,
                                               non_mem_state))

    # -- value accessors (`accumulator.rs:248-266`) --

    def mem_value(self):
        return self.mem.value()

    def non_mem_value(self):
        return self.non_mem.value()

    def value(self):
        return (self.mem.value(), self.non_mem.value())

    # -- witnesses --

    def get_membership_witness(self, element, sk,
                               mem_state) -> MembershipWitness:
        return self.mem.get_membership_witness(element, sk, mem_state)

    def get_non_membership_witness(self, element, sk,
                                   non_mem_state) -> MembershipWitness:
        return self.non_mem.get_membership_witness(element, sk,
                                                   non_mem_state)

    def get_membership_witnesses_for_batch(self, elements, sk, mem_state,
                                           device="cuda"):
        """`accumulator.rs:194-204`, on the member half's batch path."""
        return self.mem.get_membership_witnesses_for_batch(
            list(elements), sk, mem_state, device)

    def get_non_membership_witnesses_for_batch(self, elements, sk,
                                               non_mem_state,
                                               device="cuda"):
        """`accumulator.rs:216-226`, on the non-member half's batch
        path."""
        return self.non_mem.get_membership_witnesses_for_batch(
            list(elements), sk, non_mem_state, device)

    def verify_membership(self, element, witness, pk: AccumPublicKey,
                          params: AccumSetupParams) -> bool:
        return self.mem.verify_membership(element, witness, pk, params)

    def verify_non_membership(self, element, witness, pk, params) -> bool:
        return self.non_mem.verify_membership(element, witness, pk, params)
