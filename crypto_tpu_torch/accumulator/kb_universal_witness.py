"""KB universal accumulator witness updates: the port's own copy of
`crypto_tpu/accumulator/kb_universal_witness.py` (reference
`vb_accumulator/src/kb_universal_accumulator/witness.rs`, paper 2021/638).

The KB universal accumulator is two positive VB accumulators (members /
non-members of the domain), so every update law is the positive-accumulator
law applied to the right half with the roles of additions and removals
mapped:

    KB op                    member accum         non-member accum
    add(batch) E             additions E          removals E
    remove(batch) E          removals E           additions E
    batch_updates(A, D)      (A, D)               (D, A)
    extend_domain E          —                    additions E

Membership witnesses live in the member accumulator, non-membership
witnesses (plain `MembershipWitness` values) in the non-member accumulator.
`Omega` public update data is generated per half with the same role map
(reference `witness.rs:259-331`, `generate_omega_for_*`).

The batch updates with the secret key and the `Omega` generation take
`device=` (CUDA unless the caller names the CPU; raises without a card):
each half's update runs on the card from `device_update.DEVICE_THRESHOLD`
members (`witness.update_membership_batch_with_sk`), and `Omega`'s
coefficients and points on the device from the same sizes as
`batch_utils.Omega.new`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.sw import Point
from ..fields.host import Fp
from .batch_utils import Omega
from .core import MembershipWitness
from .setup import AccumSecretKey
from .witness import (update_membership_after_addition,
                      update_membership_after_removal,
                      update_membership_batch_with_sk,
                      update_membership_with_public_info)


# ---------------------------------------------------------------------------
# single-update (no secret key), holder-side
# ---------------------------------------------------------------------------

def update_mem_wit_on_addition(wit: MembershipWitness, member: Fp,
                               added: Fp, old_mem_value: Point):
    """`witness.rs:65-76`; takes the PRE-addition member-accumulator value."""
    return update_membership_after_addition(wit, member, added, old_mem_value)


def update_mem_wit_on_removal(wit: MembershipWitness, member: Fp,
                              removed: Fp, new_mem_value: Point):
    """`witness.rs:77-89`; takes the POST-removal value."""
    return update_membership_after_removal(wit, member, removed, new_mem_value)


def update_non_mem_wit_on_addition(wit: MembershipWitness, non_member: Fp,
                                   added: Fp, new_non_mem_value: Point):
    """KB add = removal from the non-member accumulator; takes the
    POST-update non-member-accumulator value (`witness.rs:157-169`)."""
    return update_membership_after_removal(wit, non_member, added,
                                           new_non_mem_value)


def update_non_mem_wit_on_removal(wit: MembershipWitness, non_member: Fp,
                                  removed: Fp, old_non_mem_value: Point):
    """KB remove = addition to the non-member accumulator; takes the
    PRE-update non-member-accumulator value (`witness.rs:170-181`)."""
    return update_membership_after_addition(wit, non_member, removed,
                                            old_non_mem_value)


def update_non_mem_wit_on_domain_extension(wit: MembershipWitness,
                                           non_member: Fp, new_element: Fp,
                                           old_non_mem_value: Point):
    """Domain extension adds to the non-member accumulator; takes the
    PRE-extension value (`witness.rs:242-258` single form)."""
    return update_membership_after_addition(wit, non_member, new_element,
                                            old_non_mem_value)


# ---------------------------------------------------------------------------
# batch updates with the secret key (manager-side)
# ---------------------------------------------------------------------------

def update_mem_wits_on_batch_updates(additions, removals, members, witnesses,
                                     old_mem_value: Point,
                                     sk: AccumSecretKey, device="cuda"):
    """`witness.rs:90-156` (additions / removals / combined)."""
    return update_membership_batch_with_sk(
        list(additions), list(removals), members, witnesses, old_mem_value,
        sk, device)


def update_non_mem_wits_on_batch_updates(additions, removals, non_members,
                                         witnesses, old_non_mem_value: Point,
                                         sk: AccumSecretKey, device="cuda"):
    """Role-swapped batch update (`witness.rs:182-241`)."""
    return update_membership_batch_with_sk(
        list(removals), list(additions), non_members, witnesses,
        old_non_mem_value, sk, device)


def update_non_mem_wits_on_domain_extension(new_elements, non_members,
                                            witnesses,
                                            old_non_mem_value: Point,
                                            sk: AccumSecretKey,
                                            device="cuda"):
    """`witness.rs:242-258`."""
    return update_membership_batch_with_sk(
        list(new_elements), [], non_members, witnesses, old_non_mem_value,
        sk, device)


# ---------------------------------------------------------------------------
# Omega generation (manager publishes; holders update without the key)
# ---------------------------------------------------------------------------

def generate_omega_for_membership_witnesses(additions, removals,
                                            old_mem_value: Point,
                                            sk: AccumSecretKey,
                                            device="cuda") -> Omega:
    """`witness.rs:259-268`."""
    return Omega.new(list(additions), list(removals), old_mem_value, sk,
                     device)


def generate_omega_for_non_membership_witnesses(additions, removals,
                                                old_non_mem_value: Point,
                                                sk: AccumSecretKey,
                                                device="cuda") -> Omega:
    """`witness.rs:269-280` (roles swapped)."""
    return Omega.new(list(removals), list(additions), old_non_mem_value, sk,
                     device)


def generate_omega_for_domain_extension(new_elements,
                                        old_non_mem_value: Point,
                                        sk: AccumSecretKey,
                                        device="cuda") -> Omega:
    """`witness.rs:281-289`."""
    return Omega.new(list(new_elements), [], old_non_mem_value, sk, device)


@dataclass
class KBUniversalOmega:
    """Combined public update data for one KB batch update
    (`witness.rs:290-531` `generate_omega_for_both_witnesses`)."""
    mem: Omega
    non_mem: Omega

    @classmethod
    def new(cls, additions, removals, old_mem_value: Point,
            old_non_mem_value: Point, sk: AccumSecretKey, device="cuda"):
        return cls(
            mem=generate_omega_for_membership_witnesses(
                additions, removals, old_mem_value, sk, device),
            non_mem=generate_omega_for_non_membership_witnesses(
                additions, removals, old_non_mem_value, sk, device))


# ---------------------------------------------------------------------------
# holder-side public-info updates
# ---------------------------------------------------------------------------

def update_mem_wit_using_public_info(wit: MembershipWitness, member: Fp,
                                     additions, removals, omega: Omega):
    """`witness.rs:532-544`."""
    return update_membership_with_public_info(
        wit, member, list(additions), list(removals), omega)


def update_non_mem_wit_using_public_info(wit: MembershipWitness,
                                         non_member: Fp, additions, removals,
                                         omega: Omega):
    """`witness.rs:561-573` (roles swapped)."""
    return update_membership_with_public_info(
        wit, non_member, list(removals), list(additions), omega)


def update_non_mem_wit_on_domain_extension_public(wit: MembershipWitness,
                                                  non_member: Fp,
                                                  new_elements,
                                                  omega: Omega):
    """`witness.rs:590-605`."""
    return update_membership_with_public_info(
        wit, non_member, list(new_elements), [], omega)


def update_mem_wit_after_multiple_batches(wit: MembershipWitness, member: Fp,
                                          batches):
    """[(additions, removals, omega)] applied in order
    (`witness.rs:545-560`)."""
    for (adds, rems, omega) in batches:
        wit = update_mem_wit_using_public_info(wit, member, adds, rems, omega)
    return wit


def update_non_mem_wit_after_multiple_batches(wit: MembershipWitness,
                                              non_member: Fp, batches):
    """`witness.rs:574-589`."""
    for (adds, rems, omega) in batches:
        wit = update_non_mem_wit_using_public_info(wit, non_member, adds,
                                                   rems, omega)
    return wit


def update_non_mem_wit_after_multiple_domain_extensions(
        wit: MembershipWitness, non_member: Fp, batches):
    """[(new_elements, omega)] (`witness.rs:606-622`)."""
    for (elems, omega) in batches:
        wit = update_non_mem_wit_on_domain_extension_public(
            wit, non_member, elems, omega)
    return wit
