"""Threshold accumulator operations (reference
`vb_accumulator/src/threshold/mod.rs`).  The port of
`crypto_tpu/accumulator/threshold.py`.

The accumulator's secret key alpha is Shamir-shared among managers;
removals and witness generation need V * 1/(y + alpha), computed by the
shared-inverse trick (each manager contributes R_i = r_i V and an
additive share of u = r (y + alpha); the user aggregates sum(R_i) / u),
so no manager learns alpha."""

from __future__ import annotations

from ..curves.sw import Point
from ..fields.host import Fp
from ..short_group_sig.threshold_weak_bb import (ThresholdWeakBBSigner,
                                                 shared_inverse_times_base)
from .core import MembershipWitness


def make_threshold_managers(rng, alpha_shares: dict) -> dict:
    """alpha_shares: {participant_id: Shamir share of alpha}."""
    ids = sorted(alpha_shares)
    return {i: ThresholdWeakBBSigner.init(rng, i, alpha_shares[i], ids)
            for i in ids}


def threshold_remove(rng, managers: dict, element: Fp,
                     accumulator_value: Point) -> Point:
    """The accumulator value after deleting `element`:
    V' = V * 1/(element + alpha) (threshold/mod.rs step 1).  V' is also the
    membership witness of the deleted element against V."""
    return shared_inverse_times_base(rng, managers, element,
                                     accumulator_value)


def threshold_membership_witness(rng, managers: dict, element: Fp,
                                 accumulator_value: Point
                                 ) -> MembershipWitness:
    """Witness C = V * 1/(element + alpha) without reconstructing alpha
    (threshold/mod.rs step 2)."""
    return MembershipWitness(C=shared_inverse_times_base(
        rng, managers, element, accumulator_value))
