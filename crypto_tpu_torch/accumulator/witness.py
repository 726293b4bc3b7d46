"""Witness update algorithms: the port's own copy of
`crypto_tpu/accumulator/witness.py` (reference `vb_accumulator/src/witness.rs`,
paper 2020/777 sections 2-4).

With secret key (manager-side, batched over many witnesses):
  after batch additions: C' = d_A(y)*C + v_A(y)*V_old
  after batch removals:  C' = 1/d_D(y)*C - v_D(y)/d_D(y)*V_new_base(V_old)
  after both:            C' = d_A(y)/d_D(y)*C + v_AD(y)/d_D(y)*V_old

Without secret key (holder-side, using published Omega):
  C' = d_A(y)/d_D(y)*C + 1/d_D(y) * <powers of y, Omega>

Single-update (no secret info needed):
  after addition y':  C' = (y' - y)*C + V_old
  after removal y':   C' = 1/(y' - y) * (C - V_new)

Non-membership witnesses additionally track d:
  d' = d * d_A(y)/d_D(y)  (same linear-combination form for C).

The batched updates with the secret key take `device=` (CUDA unless the
caller names the CPU; raises without a card): from
`device_update.DEVICE_THRESHOLD` members on a CUDA device they run on the
card (`device_update.py`), below it, and on the CPU, on the host.
"""

from __future__ import annotations

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..utils.msm import WindowTable
from . import device_update
from .batch_utils import (Omega, _batch_inverse, poly_d_eval, poly_v_A_eval,
                          poly_v_AD_eval, poly_v_D_eval)
from .core import AccumulatorError, MembershipWitness, NonMembershipWitness
from .setup import AccumSecretKey

F = bls.Fr


# ---------------------------------------------------------------------------
# single update (public info)
# ---------------------------------------------------------------------------

def update_membership_after_addition(wit: MembershipWitness, member: Fp,
                                     addition: Fp,
                                     old_accumulator: Point) -> MembershipWitness:
    # (addition - member)*C + V_old
    C = wit.C * int(addition - member) + old_accumulator
    return MembershipWitness(C.normalize())


def update_membership_after_removal(wit: MembershipWitness, member: Fp,
                                    removal: Fp,
                                    new_accumulator: Point) -> MembershipWitness:
    if (removal - member).is_zero():
        raise AccumulatorError("cannot update witness for removed member")
    inv = (removal - member).inverse()
    C = (wit.C - new_accumulator) * int(inv)
    return MembershipWitness(C.normalize())


def update_non_membership_after_addition(wit: NonMembershipWitness,
                                         non_member: Fp, addition: Fp,
                                         old_accumulator: Point) -> NonMembershipWitness:
    factor = addition - non_member
    C = wit.C * int(factor) + old_accumulator
    return NonMembershipWitness(C.normalize(), wit.d * factor)


def update_non_membership_after_removal(wit: NonMembershipWitness,
                                        non_member: Fp, removal: Fp,
                                        new_accumulator: Point) -> NonMembershipWitness:
    factor = removal - non_member
    if factor.is_zero():
        raise AccumulatorError("removal equals non-member")
    inv = factor.inverse()
    C = (wit.C - new_accumulator) * int(inv)
    return NonMembershipWitness(C.normalize(), wit.d * inv)


# ---------------------------------------------------------------------------
# batched updates with secret key (manager)
# ---------------------------------------------------------------------------

def _batch_update_with_sk(additions, removals, elements, old_Cs,
                          old_accumulator: Point, sk: AccumSecretKey,
                          device="cuda"):
    """Returns (d_factors, new_Cs) — shared for membership/non-membership.

    From `device_update.DEVICE_THRESHOLD` members on a CUDA device the
    polynomial evaluations and the per-member scalar muls run batched on
    the card (`device_update.py`); the host path below mirrors the
    reference (`vb_accumulator/src/batch_utils.rs`)."""
    dev = resolve_device(device)
    if elements and device_update.enabled(len(elements), dev):
        return device_update.batch_update_with_sk_device(
            additions, removals, elements, old_Cs, old_accumulator, sk,
            device=dev)
    table = WindowTable(max(len(elements), 1), old_accumulator)
    d_factors, new_Cs = [], []
    if additions and not removals:
        for y, C in zip(elements, old_Cs):
            dA = poly_d_eval(additions, y)
            vA = poly_v_A_eval(additions, sk.alpha, y)
            d_factors.append(dA)
            new_Cs.append((C * int(dA) + table.mul(vA)).normalize())
    elif removals and not additions:
        dDs = [poly_d_eval(removals, y) for y in elements]
        dD_invs = _batch_inverse(dDs)
        for y, C, dinv in zip(elements, old_Cs, dD_invs):
            vD = poly_v_D_eval(removals, sk.alpha, y)
            d_factors.append(dinv)
            new_Cs.append((C * int(dinv) - table.mul(vD * dinv)).normalize())
    else:
        dAs = [poly_d_eval(additions, y) for y in elements]
        dDs = [poly_d_eval(removals, y) for y in elements]
        dD_invs = _batch_inverse(dDs)
        for y, C, dA, dinv in zip(elements, old_Cs, dAs, dD_invs):
            vAD = poly_v_AD_eval(additions, removals, sk.alpha, y)
            f = dA * dinv
            d_factors.append(f)
            new_Cs.append((C * int(f) + table.mul(vAD * dinv)).normalize())
    return d_factors, new_Cs


def update_membership_batch_with_sk(additions, removals, members, witnesses,
                                    old_accumulator: Point,
                                    sk: AccumSecretKey,
                                    device="cuda") -> list:
    _, Cs = _batch_update_with_sk(additions, removals, members,
                                  [w.C for w in witnesses], old_accumulator,
                                  sk, device)
    return [MembershipWitness(C) for C in Cs]


def update_non_membership_batch_with_sk(additions, removals, non_members,
                                        witnesses, old_accumulator: Point,
                                        sk: AccumSecretKey,
                                        device="cuda") -> list:
    fs, Cs = _batch_update_with_sk(additions, removals, non_members,
                                   [w.C for w in witnesses], old_accumulator,
                                   sk, device)
    return [NonMembershipWitness(C, w.d * f)
            for C, f, w in zip(Cs, fs, witnesses)]


# ---------------------------------------------------------------------------
# updates with public info (holder, using Omega)
# ---------------------------------------------------------------------------

def _public_update(additions, removals, omega: Omega, element: Fp, old_C: Point):
    dA = poly_d_eval(additions, element)
    dD = poly_d_eval(removals, element)
    if dD.is_zero():
        raise AccumulatorError("element was removed")
    dD_inv = dD.inverse()
    f = dA * dD_inv
    y_omega = omega.evaluate(element, dD_inv)
    return f, (old_C * int(f) + y_omega).normalize()


def update_membership_with_public_info(wit: MembershipWitness, element: Fp,
                                       additions, removals,
                                       omega: Omega) -> MembershipWitness:
    _, C = _public_update(additions, removals, omega, element, wit.C)
    return MembershipWitness(C)


def update_non_membership_with_public_info(wit: NonMembershipWitness,
                                           element: Fp, additions, removals,
                                           omega: Omega) -> NonMembershipWitness:
    f, C = _public_update(additions, removals, omega, element, wit.C)
    return NonMembershipWitness(C, wit.d * f)


def update_with_public_info_multiple_batches(wit, element: Fp, batches):
    """Sequentially apply [(additions, removals, omega)] batches."""
    is_non_mem = isinstance(wit, NonMembershipWitness)
    for (adds, rems, omega) in batches:
        if is_non_mem:
            wit = update_non_membership_with_public_info(
                wit, element, adds, rems, omega)
        else:
            wit = update_membership_with_public_info(
                wit, element, adds, rems, omega)
    return wit
