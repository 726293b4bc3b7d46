"""Coconut threshold anonymous credentials over modified Pointcheval-Sanders
signatures: the port's own copy of `crypto_tpu/coconut/core.py`
(reference `coconut/` crate, paper 2022/011).

* params (g in G1, g_tilde in G2, h_i in G1) hashed from a label
* sk = (x, y_1..y_n); pk = (alpha_tilde = g_tilde*x, beta_i = g*y_i,
  beta_tilde_i = g_tilde*y_i)
* signature (sigma_1 = h, sigma_2 = h*(x + sum y_i m_i))
  (`signature/ps_signature.rs:44-95`)
* verify: e(sigma_1, alpha_tilde + sum beta_tilde_i*m_i) == e(sigma_2, g_tilde)
* blind issuance: commitments com_j = g*o_j + h*m_j; signer computes
  sigma_2 = h*(x + sum_revealed y_i m_i) + sum_blind com_j*y_j; unblinding
  subtracts sum beta_j*o_j  (`signature/blind_signature.rs`)
* threshold: x and each y_i Shamir-dealt; signers sign with shares over the
  SAME h (deterministic from messages/commitment); shares aggregate by
  Lagrange interpolation of sigma_2 (`signature/aggregated_signature.rs`)
* PoK of signature: randomize (h_bar = h*r_bar, s_bar = s*r_bar + h_bar*r),
  publish K = sum_{hidden j} beta_tilde_j*m_j + g_tilde*r with a Schnorr
  proof of opening; verify e(h_bar, K + alpha_tilde +
  sum_revealed beta_tilde_i*m_i) == e(s_bar, g_tilde)
  (`proof/signature_pok/`)

Signing, blind issuance, threshold keygen and aggregation are host code.
A signature's and a PoK's pairing product goes through
`curves.tpairing.multi_pairings_routed` on `device` (CUDA unless the
caller names the CPU; raises without a card), which sends it to the
batched device pairing or to the host by its size; where a caller hands
the PoK a `RandomizedPairingChecker`, its two pairs defer into it (the
reference pairs them eagerly on the host whatever the caller passes: the
same verdict).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, group_elem_from_try_and_incr,
                       n_group_elements)
from ..serialize import ByteWriter
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..secret_sharing.schemes import shamir_deal_secret
from ..secret_sharing.common import lagrange_basis_at_0_for_all
from ..utils.msm import msm

F = bls.Fr


class PSError(Exception):
    pass


@dataclass
class PSSignatureParams:
    g: Point
    g_tilde: Point
    h: list

    @classmethod
    def new(cls, label: bytes, message_count: int, digest=blake2b512):
        g = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g"), digest).normalize()
        g_tilde = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : g_tilde"), digest).normalize()
        h = [p.normalize() for p in n_group_elements(
            bls.G1, 0, message_count, concat_slices(label, b" : h"), digest)]
        return cls(g=g, g_tilde=g_tilde, h=h)

    @property
    def supported_message_count(self):
        return len(self.h)


@dataclass
class PSSecretKey:
    x: Fp
    y: list

    @classmethod
    def generate(cls, rng, message_count: int):
        return cls(x=F.rand_nonzero(rng),
                   y=[F.rand_nonzero(rng) for _ in range(message_count)])


@dataclass
class PSPublicKey:
    alpha_tilde: Point
    beta: list        # g * y_i   (G1)
    beta_tilde: list  # g_tilde * y_i

    @classmethod
    def generate(cls, sk: PSSecretKey, params: PSSignatureParams):
        return cls(
            alpha_tilde=(params.g_tilde * int(sk.x)).normalize(),
            beta=[(params.g * int(y)).normalize() for y in sk.y],
            beta_tilde=[(params.g_tilde * int(y)).normalize() for y in sk.y],
        )


@dataclass
class PSSignature:
    sigma_1: Point
    sigma_2: Point

    @classmethod
    def new(cls, rng, messages, sk: PSSecretKey,
            params: PSSignatureParams) -> "PSSignature":
        if not messages:
            raise PSError("no messages")
        if len(messages) != len(sk.y):
            raise PSError("message count mismatch")
        h = (params.g * int(F.rand_nonzero(rng))).normalize()
        return cls.from_sigma_1(h, messages, sk)

    @classmethod
    def new_deterministic(cls, messages, sk: PSSecretKey,
                          digest=blake2b512) -> "PSSignature":
        """sigma_1 derived by hashing the messages (big-endian bytes
        concatenated) — required for threshold signing so all signers share h
        (`ps_signature.rs:70-95`)."""
        data = b"".join(int(m).to_bytes(F.nbytes, "big") for m in messages)
        h = group_elem_from_try_and_incr(bls.G1, digest(data), digest).normalize()
        return cls.from_sigma_1(h, messages, sk)

    @classmethod
    def from_sigma_1(cls, h: Point, messages, sk: PSSecretKey) -> "PSSignature":
        e = sk.x
        for m, y in zip(messages, sk.y):
            e = e + y * m
        return cls(sigma_1=h, sigma_2=(h * int(e)).normalize())

    def is_zero(self):
        return self.sigma_1.is_infinity() or self.sigma_2.is_infinity()

    def verify(self, messages, pk: PSPublicKey, params: PSSignatureParams,
               device="cuda") -> bool:
        if self.is_zero() or not messages:
            return False
        if len(messages) != len(pk.beta_tilde):
            return False
        p1 = msm(pk.beta_tilde, messages) + pk.alpha_tilde
        return multi_pairings_routed([[
            (self.sigma_1, p1.normalize()),
            (-self.sigma_2, params.g_tilde)]], device)[0].is_one()


# ---------------------------------------------------------------------------
# blind issuance
# ---------------------------------------------------------------------------

@dataclass
class MessageCommitment:
    """com = g*o + h*m (`signature/message_commitment.rs:38-46`)."""
    com: Point

    @classmethod
    def new(cls, g: Point, o: Fp, h: Point, m: Fp):
        return cls(msm([g, h], [o, m]).normalize())


def blind_sign(commitments_and_messages, sk: PSSecretKey, h: Point) -> PSSignature:
    """`commitments_and_messages`: list of MessageCommitment (hidden) or Fp
    (revealed), in message order.  (`blind_signature.rs:66-112`)."""
    if len(commitments_and_messages) != len(sk.y):
        raise PSError("count mismatch")
    scalar_part = sk.x
    com_part = bls.G1.infinity()
    for item, y in zip(commitments_and_messages, sk.y):
        if isinstance(item, MessageCommitment):
            com_part = com_part + item.com * int(y)
        else:
            scalar_part = scalar_part + y * item
    sigma_2 = h * int(scalar_part) + com_part
    return PSSignature(sigma_1=h, sigma_2=sigma_2.normalize())


def unblind(sig: PSSignature, indexed_blindings, pk: PSPublicKey,
            h: Point) -> PSSignature:
    """Subtract sum beta_j * o_j (`blind_signature.rs:118-160`)."""
    if sig.sigma_1 != h:
        raise PSError("invalid h")
    acc = bls.G1.infinity()
    for j, o in indexed_blindings:
        acc = acc + pk.beta[j] * int(o)
    return PSSignature(sigma_1=sig.sigma_1,
                       sigma_2=(sig.sigma_2 - acc).normalize())


# ---------------------------------------------------------------------------
# threshold keygen + aggregation
# ---------------------------------------------------------------------------

def threshold_keygen(rng, threshold: int, total: int, message_count: int,
                     params: PSSignatureParams):
    """Trusted-dealer Shamir keygen (`setup/keygen/shamir_ss.rs:14`).
    Returns (secret key shares per signer, threshold public key)."""
    x = F.rand_nonzero(rng)
    ys = [F.rand_nonzero(rng) for _ in range(message_count)]
    x_shares, _ = shamir_deal_secret(rng, x, threshold, total)
    y_shares = [shamir_deal_secret(rng, y, threshold, total)[0] for y in ys]
    sks = []
    for i in range(total):
        sks.append(PSSecretKey(
            x=x_shares.shares[i].share,
            y=[ysh.shares[i].share for ysh in y_shares]))
    tsk = PSSecretKey(x=x, y=ys)
    tpk = PSPublicKey.generate(tsk, params)
    return sks, tsk, tpk


def aggregate_signatures(indexed_sigs) -> PSSignature:
    """Lagrange-combine threshold signature shares [(id, PSSignature)];
    all shares must carry the same sigma_1 (`aggregated_signature.rs`)."""
    ids = [i for i, _ in indexed_sigs]
    basis = lagrange_basis_at_0_for_all(ids)
    h = indexed_sigs[0][1].sigma_1
    acc = bls.G1.infinity()
    for l, (_, s) in zip(basis, indexed_sigs):
        if s.sigma_1 != h:
            raise PSError("mismatched sigma_1 across shares")
        acc = acc + s.sigma_2 * int(l)
    return PSSignature(sigma_1=h, sigma_2=acc.normalize())


# ---------------------------------------------------------------------------
# PoK of signature (credential show)
# ---------------------------------------------------------------------------

@dataclass
class PSSignaturePoKProtocol:
    randomized: PSSignature
    K: Point
    sc: SchnorrCommitment
    sc_wits: list
    hidden_indices: list

    @classmethod
    def init(cls, rng, sig: PSSignature, messages, revealed_indices: set,
             pk: PSPublicKey, params: PSSignatureParams,
             blindings: Optional[dict] = None):
        blindings = blindings or {}
        r = F.rand(rng)
        r_bar = F.rand_nonzero(rng)
        h_bar = sig.sigma_1 * int(r_bar)
        s_bar = sig.sigma_2 * int(r_bar) + h_bar * int(r)
        randomized = PSSignature(h_bar.normalize(), s_bar.normalize())
        hidden = [i for i in range(len(messages)) if i not in revealed_indices]
        bases = [pk.beta_tilde[j] for j in hidden] + [params.g_tilde]
        wits = [messages[j] for j in hidden] + [r]
        K = msm(bases, wits).normalize()
        rand_blind = [blindings.get(j, F.rand(rng)) for j in hidden] + [F.rand(rng)]
        sc = SchnorrCommitment.new(bases, rand_blind)
        return cls(randomized=randomized, K=K, sc=sc, sc_wits=wits,
                   hidden_indices=hidden)

    def challenge_contribution(self, pk, params, writer: ByteWriter):
        _pok_contribution(self.randomized, self.K, self.sc.t, pk, params,
                          self.hidden_indices, writer)

    def gen_proof(self, challenge: Fp) -> "PSSignaturePoK":
        return PSSignaturePoK(
            randomized=self.randomized, K=self.K, t=self.sc.t,
            response=self.sc.response(self.sc_wits, challenge),
            hidden_indices=self.hidden_indices)


def _pok_contribution(randomized, K, t, pk, params, hidden, writer):
    writer.point(randomized.sigma_1)
    writer.point(randomized.sigma_2)
    writer.point(K)
    writer.point(t)
    writer.point(params.g_tilde)
    for j in hidden:
        writer.point(pk.beta_tilde[j])


@dataclass
class PSSignaturePoK:
    randomized: PSSignature
    K: Point
    t: Point
    response: SchnorrResponse
    hidden_indices: list

    def challenge_contribution(self, pk, params, writer: ByteWriter):
        _pok_contribution(self.randomized, self.K, self.t, pk, params,
                          self.hidden_indices, writer)

    def verify(self, challenge: Fp, revealed_messages: dict, pk: PSPublicKey,
               params: PSSignatureParams, pairing_checker=None,
               device="cuda") -> bool:
        """The Schnorr check, then e(h_bar, K + alpha_tilde + sum_revealed
        beta_tilde_i m_i) == e(s_bar, g_tilde): deferred into
        `pairing_checker` when one is given, else one routed product on
        `device`."""
        if self.randomized.is_zero():
            return False
        bases = [pk.beta_tilde[j] for j in self.hidden_indices] + [params.g_tilde]
        if not self.response.is_valid(bases, self.K, self.t, challenge):
            return False
        p1 = self.K + pk.alpha_tilde
        for i, m in revealed_messages.items():
            p1 = p1 + pk.beta_tilde[i] * int(m)
        p1 = p1.normalize()
        if pairing_checker is not None:
            pairing_checker.add_sources(self.randomized.sigma_1, p1,
                                        self.randomized.sigma_2,
                                        params.g_tilde)
            return True
        return multi_pairings_routed([[
            (self.randomized.sigma_1, p1),
            (-self.randomized.sigma_2, params.g_tilde)]], device)[0].is_one()

    def response_for_message(self, msg_idx: int) -> Fp:
        return self.response.get_response(self.hidden_indices.index(msg_idx))
