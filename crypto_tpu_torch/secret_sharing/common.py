"""Secret sharing common types: the port's own copy of
`crypto_tpu/secret_sharing/common.py` (reference
`secret_sharing_and_dkg/src/common.rs`).  Host code.

Share ids are 1-based u16s (id 0 forbidden: basis evaluated at 0).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..utils.msm import msm

F = bls.Fr


class SSError(Exception):
    pass


@dataclass
class Share:
    id: int
    threshold: int
    share: Fp


@dataclass
class Shares:
    shares: list  # list[Share]

    def ids(self):
        return [s.id for s in self.shares]


@dataclass
class CommitmentToCoefficients:
    points: list  # [g*a_0, g*a_1, ...] (or Pedersen commitments)

    def commitment_to_secret(self) -> Point:
        return self.points[0]


def lagrange_basis_at_0(x_coords, i: int) -> Fp:
    """l_i(0) over the given x-coordinates (`common.rs:420-445`)."""
    num, den = F(1), F(1)
    i_f = F(i)
    for x in x_coords:
        if x == 0:
            raise SSError("x-coordinate cannot be 0")
        if x == i:
            continue
        xf = F(x)
        num = num * xf
        den = den * (xf - i_f)
    return num * den.inverse()


def lagrange_basis_at_0_for_all(x_coords) -> list:
    return [lagrange_basis_at_0(x_coords, i) for i in x_coords]


def poly_eval_int(coeffs, x: int) -> Fp:
    acc = F(0)
    for c in reversed(coeffs):
        acc = acc * F(x) + c
    return acc


def commit_to_poly(g: Point, coeffs) -> CommitmentToCoefficients:
    return CommitmentToCoefficients([(g * int(c)).normalize() for c in coeffs])


def verify_share_against_commitments(share: Share,
                                     comms: CommitmentToCoefficients,
                                     g: Point) -> bool:
    """g*share == sum_j C_j * id^j (Feldman check, `common.rs` Share::verify)."""
    if len(comms.points) != share.threshold:
        return False
    powers = []
    acc = F(1)
    for _ in comms.points:
        powers.append(acc)
        acc = acc * F(share.id)
    lhs = (g * int(share.share)).normalize()
    rhs = msm(comms.points, powers).normalize()
    return lhs == rhs


@dataclass
class SharesAccumulator:
    """Accumulates verified shares from many dealers in a DVSS/DKG
    (reference `common.rs:240-330`): each dealer Feldman- or Pedersen-deals
    a secret; receivers verify each share against that dealer's coefficient
    commitments and finally sum everything into one share of the joint
    secret (with the joint public key = sum of the dealers' commitment-to-
    secret terms)."""
    participant_id: int
    threshold: int
    shares: dict = None            # {dealer_id: Share}
    coeff_comms: dict = None       # {dealer_id: CommitmentToCoefficients}

    def __post_init__(self):
        if self.shares is None:
            self.shares = {}
        if self.coeff_comms is None:
            self.coeff_comms = {}

    def add_received_share(self, sender_id: int, share: "Share",
                           commitments: "CommitmentToCoefficients",
                           ck) -> None:
        """ck: the Feldman generator Point, or a (g, h) PedersenCommitmentKey
        for Pedersen-VSS shares."""
        if sender_id in self.shares:
            raise SSError("already received from this sender")
        if share.id != self.participant_id:
            raise SSError("share id != participant id")
        if share.threshold != self.threshold:
            raise SSError("threshold mismatch")
        if len(commitments.points) != self.threshold:
            raise SSError("commitment count != threshold")
        from .schemes import (feldman_verify_share, pedersen_verify_share,
                              PedersenVSSShare)
        if isinstance(share, PedersenVSSShare):
            if not pedersen_verify_share(share, commitments, ck):
                raise SSError("invalid Pedersen share")
        else:
            if not feldman_verify_share(share, commitments, ck):
                raise SSError("invalid Feldman share")
        self.shares[sender_id] = share
        self.coeff_comms[sender_id] = commitments

    def add_self_share(self, share: "Share",
                       commitments: "CommitmentToCoefficients") -> None:
        self.shares[self.participant_id] = share
        self.coeff_comms[self.participant_id] = commitments

    def finalize(self):
        """Returns (final Share, threshold public key) — the sum of all
        dealers' contributions."""
        if not self.shares:
            raise SSError("no shares accumulated")
        total = None
        pk = None
        for dealer, s in sorted(self.shares.items()):
            total = s.share if total is None else total + s.share
            c0 = self.coeff_comms[dealer].commitment_to_secret()
            pk = c0 if pk is None else (pk + c0)
        return (Share(id=self.participant_id, threshold=self.threshold,
                      share=total), pk.normalize())


def reconstruct_threshold_public_key(public_keys: list,
                                     threshold: int) -> "Point":
    """Lagrange-combine (id, pk_i) pairs into the threshold public key
    (reference `feldman_dvss_dkg.rs:4-17`)."""
    if threshold > len(public_keys):
        raise SSError("below threshold")
    sub = public_keys[:threshold]
    basis = lagrange_basis_at_0_for_all([i for i, _ in sub])
    acc = None
    for (i, pk), l in zip(sub, basis):
        term = pk * int(l)
        acc = term if acc is None else acc + term
    return acc.normalize()
