"""Threshold weak-BB signature issuance (reference
`short_group_sig/src/threshold_weak_bb_sig.rs`).  The port of
`crypto_tpu/short_group_sig/threshold_weak_bb.py`: the same draws from
`rng` in the same order, so the same seed gives the same signature.

Signers hold Shamir shares x_i of the key x and jointly produce
A = g * 1/(e + x) for a public message e without reconstructing x, by
the shared-inverse trick:

  1. each signer i samples r_i (an additive sharing of a random r) and
     turns its Shamir share into an additive share lx_i = lambda_i x_i;
  2. pairwise two-party multiplications (Gilboa over OT extension, the
     machinery of threshold BBS+) give additive shares u_i of
     u = r (e + x); the u_i are opened and summed, u a uniformly random
     mask of the secret denominator;
  3. signer i outputs R_i = g r_i; the aggregator computes
     A = (sum R_i) / u = g r / (r (e + x)) = g / (e + x).

Host work: each ordered pair of signers runs its own base OTs (128
scalar multiplications a side, on the host's integers through
`Point.__mul__`) and an OT extension of 255 OTs.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.sw import Point
from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..ot import gilboa
from ..ot.ot_extension import setup_ote_pair
from ..secret_sharing.common import lagrange_basis_at_0
from .weak_bb import WeakBBSig

F = bls.Fr


@dataclass
class ThresholdWeakBBSigner:
    id: int
    r: Fp            # additive share of the mask
    lx: Fp           # additive share (lambda_i * x_i) of the key
    u_share: Fp = None

    @classmethod
    def init(cls, rng, id: int, x_share: Fp, all_ids: list):
        lam = lagrange_basis_at_0(all_ids, id)
        return cls(id=id, r=F.rand_nonzero(rng), lx=lam * x_share)


def run_threshold_weak_bb(rng, signers: dict, message: Fp, g1: Point):
    """In-process execution (a deployment carries the pairwise OT messages
    between the signers).  Returns the standard WeakBBSig."""
    return WeakBBSig(A=shared_inverse_times_base(rng, signers, message, g1))


def shared_inverse_times_base(rng, signers: dict, message: Fp,
                              g1: Point) -> Point:
    """base * 1/(message + x) for Shamir-shared x: the common core of
    threshold weak-BB signing, threshold accumulator updates
    (`vb_accumulator/src/threshold/mod.rs`) and SyRA threshold issuance
    (`syra/src/threshold_issuance.rs`)."""
    ids = sorted(signers)
    # u = r (e + x) = sum_i r_i (e + lx_i) + sum_{i != j} r_i lx_j
    u_shares = {i: signers[i].r * (message + signers[i].lx) for i in ids}
    for i in ids:
        for j in ids:
            if i == j:
                continue
            # shares of r_i * lx_j between parties i and j
            ote_sender, ote_receiver = setup_ote_pair(rng, g1)
            U, keys, choices = gilboa.batch_mul_party2_round1(
                ote_receiver, [signers[i].r])
            msgs, sh_j = gilboa.batch_mul_party1(
                ote_sender, [signers[j].lx], U)
            sh_i = gilboa.batch_mul_party2_round2(keys, choices, msgs, 1)
            u_shares[i] = u_shares[i] + sh_i[0]
            u_shares[j] = u_shares[j] + sh_j[0]
    u = F(sum(int(u_shares[i]) for i in ids) % F.p)
    if u.is_zero():
        raise ValueError("degenerate mask; retry with fresh randomness")
    R = g1.curve.infinity()
    for i in ids:
        R = R + g1 * int(signers[i].r)
    return (R * int(u.inverse())).normalize()
