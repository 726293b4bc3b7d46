"""Shamir SS, Feldman VSS, Pedersen VSS, Feldman DVSS/DKG: the port's own
copy of `crypto_tpu/secret_sharing/schemes.py` (reference
`secret_sharing_and_dkg/src/{shamir_ss,feldman_vss,pedersen_vss,
feldman_dvss_dkg}.rs`).  Host code.

All protocols are transport-agnostic state machines: every round returns
plain message objects the caller transports; tests run all participants
in-process.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..utils.msm import msm
from .common import (SSError, Share, Shares, CommitmentToCoefficients,
                     lagrange_basis_at_0_for_all, poly_eval_int,
                     commit_to_poly, verify_share_against_commitments)

F = bls.Fr


# ---------------------------------------------------------------------------
# Shamir
# ---------------------------------------------------------------------------

def shamir_deal_secret(rng, secret: Fp, threshold: int, total: int):
    """Returns (Shares, polynomial coefficients, low-first)."""
    if not (2 <= total and 1 <= threshold <= total):
        raise SSError("invalid threshold/total")
    coeffs = [secret] + [F.rand(rng) for _ in range(threshold - 1)]
    shares = Shares([
        Share(i, threshold, poly_eval_int(coeffs, i))
        for i in range(1, total + 1)
    ])
    return shares, coeffs


def shamir_deal_random_secret(rng, threshold: int, total: int):
    secret = F.rand(rng)
    shares, coeffs = shamir_deal_secret(rng, secret, threshold, total)
    return secret, shares, coeffs


def reconstruct_secret(shares: Shares) -> Fp:
    ids = shares.ids()
    basis = lagrange_basis_at_0_for_all(ids)
    acc = F(0)
    for b, s in zip(basis, shares.shares):
        acc = acc + b * s.share
    return acc


# ---------------------------------------------------------------------------
# Feldman VSS
# ---------------------------------------------------------------------------

def feldman_deal_secret(rng, secret: Fp, threshold: int, total: int, g: Point):
    """Returns (Shares, CommitmentToCoefficients)."""
    shares, coeffs = shamir_deal_secret(rng, secret, threshold, total)
    return shares, commit_to_poly(g, coeffs)


def feldman_verify_share(share: Share, comms: CommitmentToCoefficients,
                         g: Point) -> bool:
    return verify_share_against_commitments(share, comms, g)


# ---------------------------------------------------------------------------
# Pedersen VSS (hiding: two polynomials, commitments g^a_j h^b_j)
# ---------------------------------------------------------------------------

@dataclass
class PedersenVSSShare:
    id: int
    threshold: int
    share: Fp           # f(i)
    blinding_share: Fp  # f'(i)


def pedersen_deal_secret(rng, secret: Fp, threshold: int, total: int,
                         g: Point, h: Point):
    blinding = F.rand(rng)
    _, coeffs = shamir_deal_secret(rng, secret, threshold, total)
    _, bcoeffs = shamir_deal_secret(rng, blinding, threshold, total)
    comms = CommitmentToCoefficients([
        (g * int(a) + h * int(b)).normalize()
        for a, b in zip(coeffs, bcoeffs)
    ])
    shares = [
        PedersenVSSShare(i, threshold, poly_eval_int(coeffs, i),
                         poly_eval_int(bcoeffs, i))
        for i in range(1, total + 1)
    ]
    return shares, comms, blinding


def pedersen_verify_share(share: PedersenVSSShare,
                          comms: CommitmentToCoefficients,
                          g: Point, h: Point) -> bool:
    if len(comms.points) != share.threshold:
        return False
    powers = []
    acc = F(1)
    for _ in comms.points:
        powers.append(acc)
        acc = acc * F(share.id)
    lhs = (g * int(share.share) + h * int(share.blinding_share)).normalize()
    return lhs == msm(comms.points, powers).normalize()


# ---------------------------------------------------------------------------
# Feldman DVSS / DKG (no dealer: every participant deals, shares are summed)
# ---------------------------------------------------------------------------

@dataclass
class FeldmanDKGParticipant:
    """One participant of the Feldman-style DKG
    (`feldman_dvss_dkg.rs`): deals a random secret to everyone; the final
    key share is the sum of received (verified) shares; the threshold public
    key is the sum of the secret-commitments."""
    id: int
    threshold: int
    total: int
    my_shares_for_others: Shares = None
    my_commitments: CommitmentToCoefficients = None
    received: dict = field(default_factory=dict)   # dealer_id -> Share
    commitments: dict = field(default_factory=dict)

    def deal(self, rng, g: Point):
        secret = F.rand(rng)
        shares, comms = feldman_deal_secret(
            rng, secret, self.threshold, self.total, g)
        self.my_shares_for_others = shares
        self.my_commitments = comms
        self.receive(self.id, shares.shares[self.id - 1], comms, g)
        return shares, comms

    def receive(self, dealer_id: int, share: Share,
                comms: CommitmentToCoefficients, g: Point):
        if dealer_id in self.received:
            raise SSError("duplicate dealer")
        if share.id != self.id:
            raise SSError("share not addressed to me")
        if not feldman_verify_share(share, comms, g):
            raise SSError(f"invalid share from dealer {dealer_id}")
        self.received[dealer_id] = share
        self.commitments[dealer_id] = comms

    def finish(self):
        """Returns (secret key share, threshold public key, my public key share)."""
        if len(self.received) != self.total:
            raise SSError("missing dealers")
        sk_share = F(0)
        for s in self.received.values():
            sk_share = sk_share + s.share
        tpk = None
        for comms in self.commitments.values():
            c0 = comms.commitment_to_secret()
            tpk = c0 if tpk is None else (tpk + c0)
        return sk_share, tpk.normalize()
