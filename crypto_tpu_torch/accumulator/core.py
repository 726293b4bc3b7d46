"""Positive & universal VB accumulators: the port's own copy of
`crypto_tpu/accumulator/core.py` (reference
`vb_accumulator/src/{positive,universal}.rs`, paper 2020/777).

Positive: V' = (y + alpha) * V on add; witness C = 1/(y+alpha) * V;
membership check e(C, y*P_tilde + Q_tilde) == e(V, P_tilde).

Universal: additionally tracks f_V (product of (y_i+alpha) over members and
initial elements); non-membership witness (C, d): d = f_V(-y) != 0,
C = (f_V - d)/(y + alpha) * P; check
e(C, y*P_tilde + Q_tilde) * e(d*P, P_tilde) == e(V, P_tilde).

Batch witness generation takes `device=` (CUDA unless the caller names
the CPU; raises without a card) and runs on the device fixed-base table
from 512 members (`utils/msm.py`); the checks pair on the host
(`curves/bls12_381.py` `multi_pairing`), as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..utils.msm import multiply_field_elems_with_same_group_elem
from .setup import AccumSecretKey, AccumPublicKey, AccumSetupParams
from .persistence import InMemoryState, State
from .batch_utils import poly_d_eval, _batch_inverse

F = bls.Fr


class AccumulatorError(Exception):
    pass


@dataclass
class MembershipWitness:
    C: Point


@dataclass
class NonMembershipWitness:
    C: Point
    d: Fp


class _AccumBase:
    """Shared add/remove logic (`positive.rs:143-345`)."""

    V: Point

    def value(self) -> Point:
        return self.V

    # -- compute-only variants (no state) --

    def _new_post_add(self, element: Fp, sk: AccumSecretKey):
        y_plus_alpha = element + sk.alpha
        return y_plus_alpha, (self.V * int(y_plus_alpha)).normalize()

    def _new_post_remove(self, element: Fp, sk: AccumSecretKey):
        inv = (element + sk.alpha).inverse()
        return inv, (self.V * int(inv)).normalize()

    def _new_post_add_batch(self, elements, sk: AccumSecretKey):
        d_alpha = poly_d_eval(elements, -sk.alpha)
        return d_alpha, (self.V * int(d_alpha)).normalize()

    def _new_post_remove_batch(self, elements, sk: AccumSecretKey):
        inv = poly_d_eval(elements, -sk.alpha).inverse()
        return inv, (self.V * int(inv)).normalize()

    def _new_post_batch_updates(self, additions, removals, sk: AccumSecretKey):
        d = poly_d_eval(additions, -sk.alpha)
        if removals:
            d = d * poly_d_eval(removals, -sk.alpha).inverse()
        return d, (self.V * int(d)).normalize()

    # -- witness computation --

    def compute_membership_witness(self, member: Fp,
                                   sk: AccumSecretKey) -> MembershipWitness:
        inv = (member + sk.alpha).inverse()
        return MembershipWitness((self.V * int(inv)).normalize())

    def compute_membership_witnesses_for_batch(self, members,
                                               sk: AccumSecretKey,
                                               device="cuda"):
        invs = _batch_inverse([m + sk.alpha for m in members])
        pts = multiply_field_elems_with_same_group_elem(self.V, invs,
                                                        device=device)
        return [MembershipWitness(p.normalize()) for p in pts]

    # -- verification (static) --

    @staticmethod
    def verify_membership_given_accumulated(V: Point, member: Fp,
                                            witness: MembershipWitness,
                                            pk: AccumPublicKey,
                                            params: AccumSetupParams) -> bool:
        rhs = (params.P_tilde * int(member) + pk.Q_tilde).normalize()
        out = bls.multi_pairing([(witness.C, rhs), (-V, params.P_tilde)])
        return out.is_one()

    def verify_membership(self, member: Fp, witness: MembershipWitness,
                          pk: AccumPublicKey, params: AccumSetupParams) -> bool:
        return self.verify_membership_given_accumulated(
            self.V, member, witness, pk, params)


@dataclass
class PositiveAccumulator(_AccumBase):
    V: Point

    @classmethod
    def initialize(cls, params: AccumSetupParams) -> "PositiveAccumulator":
        return cls(V=params.P)

    # stateful API mirroring the reference (`positive.rs:122-595`)

    def add(self, element: Fp, sk: AccumSecretKey,
            state: State) -> "PositiveAccumulator":
        if state.has(element):
            raise AccumulatorError("element present")
        _, V = self._new_post_add(element, sk)
        state.add(element)
        return PositiveAccumulator(V)

    def add_batch(self, elements, sk: AccumSecretKey,
                  state: State) -> "PositiveAccumulator":
        for e in elements:
            if state.has(e):
                raise AccumulatorError("element present")
        _, V = self._new_post_add_batch(elements, sk)
        for e in elements:
            state.add(e)
        return PositiveAccumulator(V)

    def remove(self, element: Fp, sk: AccumSecretKey,
               state: State) -> "PositiveAccumulator":
        if not state.has(element):
            raise AccumulatorError("element absent")
        _, V = self._new_post_remove(element, sk)
        state.remove(element)
        return PositiveAccumulator(V)

    def remove_batch(self, elements, sk: AccumSecretKey,
                     state: State) -> "PositiveAccumulator":
        for e in elements:
            if not state.has(e):
                raise AccumulatorError("element absent")
        _, V = self._new_post_remove_batch(elements, sk)
        for e in elements:
            state.remove(e)
        return PositiveAccumulator(V)

    def batch_updates(self, additions, removals, sk: AccumSecretKey,
                      state: State) -> "PositiveAccumulator":
        for e in additions:
            if state.has(e):
                raise AccumulatorError("element present")
        for e in removals:
            if not state.has(e):
                raise AccumulatorError("element absent")
        _, V = self._new_post_batch_updates(additions, removals, sk)
        for e in additions:
            state.add(e)
        for e in removals:
            state.remove(e)
        return PositiveAccumulator(V)

    def get_membership_witness(self, member: Fp, sk: AccumSecretKey,
                               state: State) -> MembershipWitness:
        if not state.has(member):
            raise AccumulatorError("element absent")
        return self.compute_membership_witness(member, sk)

    def get_membership_witnesses_for_batch(self, members, sk, state,
                                           device="cuda"):
        for m in members:
            if not state.has(m):
                raise AccumulatorError("element absent")
        return self.compute_membership_witnesses_for_batch(members, sk,
                                                           device)


@dataclass
class UniversalAccumulator(_AccumBase):
    V: Point
    f_V: Fp
    max_size: int

    @classmethod
    def initialize(cls, rng, params: AccumSetupParams, max_size: int,
                   sk: AccumSecretKey,
                   initial_elements_store) -> "UniversalAccumulator":
        """Generates max_size+1 random initial elements (legacy-style
        `initialize_with_all_random`, `universal.rs:163-177`)."""
        f_V = F.one()
        for _ in range(max_size + 1):
            e = F.rand(rng)
            initial_elements_store.add(e)
            f_V = f_V * (e + sk.alpha)
        return cls(V=(params.P * int(f_V)).normalize(), f_V=f_V,
                   max_size=max_size)

    def _updated(self, f_V_factor: Fp, V: Point) -> "UniversalAccumulator":
        return UniversalAccumulator(V=V, f_V=self.f_V * f_V_factor,
                                    max_size=self.max_size)

    def add(self, element: Fp, sk: AccumSecretKey, state: State,
            size: int | None = None) -> "UniversalAccumulator":
        if state.has(element):
            raise AccumulatorError("element present")
        if (size if size is not None else state.size()) >= self.max_size:
            raise AccumulatorError("accumulator full")
        f, V = self._new_post_add(element, sk)
        state.add(element)
        return self._updated(f, V)

    def add_batch(self, elements, sk, state) -> "UniversalAccumulator":
        if state.size() + len(elements) > self.max_size:
            raise AccumulatorError("accumulator full")
        for e in elements:
            if state.has(e):
                raise AccumulatorError("element present")
        f, V = self._new_post_add_batch(elements, sk)
        for e in elements:
            state.add(e)
        return self._updated(f, V)

    def remove(self, element: Fp, sk, state) -> "UniversalAccumulator":
        if not state.has(element):
            raise AccumulatorError("element absent")
        f, V = self._new_post_remove(element, sk)
        state.remove(element)
        return self._updated(f, V)

    def remove_batch(self, elements, sk, state) -> "UniversalAccumulator":
        for e in elements:
            if not state.has(e):
                raise AccumulatorError("element absent")
        f, V = self._new_post_remove_batch(elements, sk)
        for e in elements:
            state.remove(e)
        return self._updated(f, V)

    def batch_updates(self, additions, removals, sk, state) -> "UniversalAccumulator":
        for e in additions:
            if state.has(e):
                raise AccumulatorError("element present")
        for e in removals:
            if not state.has(e):
                raise AccumulatorError("element absent")
        if state.size() + len(additions) - len(removals) > self.max_size:
            raise AccumulatorError("accumulator full")
        f, V = self._new_post_batch_updates(additions, removals, sk)
        for e in additions:
            state.add(e)
        for e in removals:
            state.remove(e)
        return self._updated(f, V)

    def get_membership_witness(self, member, sk, state) -> MembershipWitness:
        if not state.has(member):
            raise AccumulatorError("element absent")
        return self.compute_membership_witness(member, sk)

    # -- non-membership --

    @staticmethod
    def compute_d_given_members(non_member: Fp, members) -> Fp:
        d = F.one()
        for m in members:
            d = d * (m - non_member)
        return d

    def compute_non_membership_witness_given_d(
            self, d: Fp, non_member: Fp, sk: AccumSecretKey,
            params: AccumSetupParams) -> NonMembershipWitness:
        if d.is_zero():
            raise AccumulatorError("d cannot be zero")
        inv = (non_member + sk.alpha).inverse()
        C = params.P * int((self.f_V - d) * inv)
        return NonMembershipWitness(C=C.normalize(), d=d)

    def get_non_membership_witness(self, non_member: Fp, sk: AccumSecretKey,
                                   state: InMemoryState,
                                   params: AccumSetupParams) -> NonMembershipWitness:
        if state.has(non_member):
            raise AccumulatorError("element present")
        d = self.compute_d_given_members(
            non_member, [F(m) for m in state.elements()])
        return self.compute_non_membership_witness_given_d(
            d, non_member, sk, params)

    @staticmethod
    def verify_non_membership_given_accumulated(
            V: Point, non_member: Fp, witness: NonMembershipWitness,
            pk: AccumPublicKey, params: AccumSetupParams) -> bool:
        if witness.d.is_zero():
            return False
        rhs = (params.P_tilde * int(non_member) + pk.Q_tilde).normalize()
        dP = (params.P * int(witness.d)).normalize()
        out = bls.multi_pairing([
            (witness.C, rhs), (dP, params.P_tilde), (-V, params.P_tilde)])
        return out.is_one()

    def verify_non_membership(self, non_member, witness, pk, params) -> bool:
        return self.verify_non_membership_given_accumulated(
            self.V, non_member, witness, pk, params)
