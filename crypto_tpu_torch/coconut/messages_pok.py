"""Proof of knowledge for Coconut blind-signature requests: the port's own
copy of `crypto_tpu/coconut/messages_pok.py` (reference
`coconut/src/proof/messages_pok/`).  Host code.

The requester sends per-message commitments com_j = g*o_j + h*m_j (for
hidden messages) plus an aggregate Pedersen commitment
com = g*o + sum h_j*m_j binding all hidden messages together, and proves
consistency: knowledge of (o, o_j, m_j) with the SAME m_j in com_j and com
(shared blindings -> shared responses).  The signer verifies before blind
signing; h is derived by hashing com so the requester cannot grind it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, group_elem_from_try_and_incr
from ..serialize import ByteWriter, serialize_point
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..utils.msm import msm
from .core import PSSignatureParams, MessageCommitment

F = bls.Fr


def derive_h(com: Point, digest=blake2b512) -> Point:
    """h = HashToG1(com) (`blind signature h derivation`)."""
    return group_elem_from_try_and_incr(
        bls.G1, b"coconut-h" + serialize_point(com), digest).normalize()


@dataclass
class MessagesPoKProtocol:
    com: Point                 # aggregate commitment
    h: Point
    com_j: dict                # {msg_idx: MessageCommitment}
    sc_agg: SchnorrCommitment
    agg_wits: list
    sc_j: dict                 # {msg_idx: PokPedersenCommitmentProtocol}
    o_j: dict                  # blindings of per-message commitments

    @classmethod
    def init(cls, rng, messages: dict, params: PSSignatureParams,
             blindings: dict | None = None):
        """messages: {idx: m} for the HIDDEN messages."""
        blindings = blindings or {}
        o = F.rand(rng)
        idxs = sorted(messages)
        bases = [params.g] + [params.h[j] for j in idxs]
        wits = [o] + [messages[j] for j in idxs]
        com = msm(bases, wits).normalize()
        h = derive_h(com)

        msg_blind = {j: blindings.get(j, F.rand(rng)) for j in idxs}
        sc_agg = SchnorrCommitment.new(
            bases, [F.rand(rng)] + [msg_blind[j] for j in idxs])

        o_j, com_j, sc_j = {}, {}, {}
        for j in idxs:
            o_j[j] = F.rand(rng)
            com_j[j] = MessageCommitment.new(params.g, o_j[j], h, messages[j])
            sc_j[j] = PokPedersenCommitmentProtocol.init(
                o_j[j], F.rand(rng), params.g,
                messages[j], msg_blind[j], h)
        return cls(com=com, h=h, com_j=com_j, sc_agg=sc_agg, agg_wits=wits,
                   sc_j=sc_j, o_j=o_j)

    def challenge_contribution(self, params: PSSignatureParams,
                               writer: ByteWriter):
        writer.point(self.com)
        writer.point(self.h)
        writer.point(self.sc_agg.t)
        for j in sorted(self.com_j):
            writer.point(self.com_j[j].com)
            writer.point(self.sc_j[j].t)

    def gen_proof(self, challenge: Fp) -> "MessagesPoK":
        return MessagesPoK(
            com=self.com, h=self.h,
            com_j={j: c for j, c in self.com_j.items()},
            t_agg=self.sc_agg.t,
            resp_agg=self.sc_agg.response(self.agg_wits, challenge),
            sc_j={j: p.gen_proof(challenge) for j, p in self.sc_j.items()})

    def commitments_for_signing(self):
        """(com_j dict for blind_sign, h, per-message blindings for unblind)."""
        return self.com_j, self.h, dict(self.o_j)


@dataclass
class MessagesPoK:
    com: Point
    h: Point
    com_j: dict
    t_agg: Point
    resp_agg: SchnorrResponse
    sc_j: dict

    def challenge_contribution(self, params: PSSignatureParams,
                               writer: ByteWriter):
        writer.point(self.com)
        writer.point(self.h)
        writer.point(self.t_agg)
        for j in sorted(self.com_j):
            writer.point(self.com_j[j].com)
            writer.point(self.sc_j[j].t)

    def verify(self, challenge: Fp, params: PSSignatureParams) -> bool:
        if derive_h(self.com) != self.h:
            return False
        idxs = sorted(self.com_j)
        bases = [params.g] + [params.h[j] for j in idxs]
        if not self.resp_agg.is_valid(bases, self.com, self.t_agg, challenge):
            return False
        for pos, j in enumerate(idxs):
            pok = self.sc_j[j]
            if not pok.verify(self.com_j[j].com, params.g, self.h, challenge):
                return False
            # message response shared between com_j and the aggregate
            if pok.response2 != self.resp_agg.get_response(1 + pos):
                return False
        return True
