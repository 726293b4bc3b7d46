"""BBS signatures (2023/275, "BBS" without s) and their PoKs: the port's
own copy of `crypto_tpu/bbs_plus/bbs23.py` (reference
`bbs_plus/src/{signature_23,proof_23}.rs`).

Signature (A, e):  C(m) = g1 + sum h_i*m_i ;  A = C(m) * 1/(e+x)
Verify: e(A, pk + g2*e) == e(C(m), g2).

PoK (section 5.2 of the paper, with the externally-suppliable signature
randomizer `r` so equal messages across signatures keep equal Schnorr
witnesses `m_i * r`, see `proof_23.rs:1-22`):

  A_bar = A*r ;  B_bar = r*C(m) - e*A_bar
  Schnorr over  B_bar = c_m_J * r + sum_{i hidden} h_i*(m_i*r) + A_bar*(-e)
  where c_m_J = g1 + sum_{j revealed} h_j*m_j.
  Pairing: e(A_bar, pk) * e(-B_bar, g2) == 1, on the host, or deferred
  into a `pairing_checker` (a RandomizedPairingChecker, whose lazy Miller
  product runs on the device).

Params `SignatureParams23G1` have no h_0 (no `s`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, group_elem_from_try_and_incr,
                       n_group_elements)
from ..serialize import ByteWriter
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..utils.msm import msm
from .setup import SecretKey
from .signature import BBSPlusError

F = bls.Fr


@dataclass
class SignatureParams23G1:
    g1: Point
    g2: Point
    h: list

    @classmethod
    def new(cls, label: bytes, message_count: int, digest=blake2b512):
        g1 = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g1"), digest).normalize()
        g2 = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : g2"), digest).normalize()
        h = [p.normalize() for p in n_group_elements(
            bls.G1, 0, message_count, concat_slices(label, b" : h_"), digest)]
        return cls(g1=g1, g2=g2, h=h)

    @property
    def supported_message_count(self):
        return len(self.h)

    def commitment_to_messages(self, indexed_messages) -> Point:
        """g1 + sum h_i*m_i over given (idx, msg) pairs."""
        bases = [self.h[i] for i, _ in indexed_messages]
        scalars = [m for _, m in indexed_messages]
        acc = msm(bases, scalars) if bases else bls.G1.infinity()
        return acc + self.g1


@dataclass
class PublicKey23G2:
    w: Point

    @classmethod
    def generate(cls, sk: SecretKey, params: SignatureParams23G1):
        return cls((params.g2 * int(sk.x)).normalize())


@dataclass
class Signature23G1:
    A: Point
    e: Fp

    @classmethod
    def new(cls, rng, messages, sk: SecretKey,
            params: SignatureParams23G1) -> "Signature23G1":
        if not messages:
            raise BBSPlusError("no messages")
        if len(messages) != params.supported_message_count:
            raise BBSPlusError("message count mismatch")
        e = F.rand(rng)
        while (e + sk.x).is_zero():
            e = F.rand(rng)
        cm = params.commitment_to_messages(list(enumerate(messages)))
        A = cm * int((e + sk.x).inverse())
        return cls(A=A.normalize(), e=e)

    def verify(self, messages, pk: PublicKey23G2,
               params: SignatureParams23G1) -> bool:
        if self.A.is_infinity():
            return False
        cm = params.commitment_to_messages(list(enumerate(messages)))
        Aeb = self.A * int(self.e) - cm
        return bls.multi_pairing([(self.A, pk.w),
                                  (Aeb.normalize(), params.g2)]).is_one()


@dataclass
class PoKOfSignature23G1Protocol:
    A_bar: Point
    B_bar: Point
    sc: SchnorrCommitment
    sc_wits: list
    hidden_indices: list

    @classmethod
    def init(cls, rng, signature: Signature23G1, params: SignatureParams23G1,
             messages, revealed_indices: set,
             sig_randomizer: Optional[Fp] = None,
             blindings: Optional[dict] = None):
        blindings = blindings or {}
        r = sig_randomizer if sig_randomizer is not None else F.rand_nonzero(rng)
        hidden = [i for i in range(len(messages))
                  if i not in revealed_indices]
        cm = params.commitment_to_messages(list(enumerate(messages)))
        A_bar = signature.A * int(r)
        B_bar = cm * int(r) - A_bar * int(signature.e)
        A_bar, B_bar = A_bar.normalize(), B_bar.normalize()

        c_m_j = params.commitment_to_messages(
            [(j, messages[j]) for j in sorted(revealed_indices)])
        bases = [c_m_j.normalize()] + [params.h[i] for i in hidden] + [A_bar]
        wits = [r] + [messages[i] * r for i in hidden] + [-signature.e]
        randomness = [F.rand(rng)] + \
            [blindings.get(i, F.rand(rng)) for i in hidden] + [F.rand(rng)]
        return cls(A_bar=A_bar, B_bar=B_bar,
                   sc=SchnorrCommitment.new(bases, randomness),
                   sc_wits=wits, hidden_indices=hidden)

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1, writer: ByteWriter):
        _pok23_contribution(self.A_bar, self.B_bar, self.sc.t, revealed_msgs,
                            params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfSignature23G1":
        return PoKOfSignature23G1(
            A_bar=self.A_bar, B_bar=self.B_bar, t=self.sc.t,
            response=self.sc.response(self.sc_wits, challenge),
            hidden_indices=self.hidden_indices)


def _pok23_contribution(A_bar, B_bar, t, revealed_msgs, params, writer):
    writer.point(A_bar)
    writer.point(B_bar)
    writer.point(t)
    writer.point(params.g1)
    for i in range(len(params.h)):
        writer.point(params.h[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])


@dataclass
class PoKOfSignature23G1:
    A_bar: Point
    B_bar: Point
    t: Point
    response: SchnorrResponse
    hidden_indices: list

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1, writer: ByteWriter):
        _pok23_contribution(self.A_bar, self.B_bar, self.t, revealed_msgs,
                            params, writer)

    def verify(self, revealed_msgs: dict, challenge: Fp, pk: PublicKey23G2,
               params: SignatureParams23G1, pairing_checker=None) -> bool:
        if self.A_bar.is_infinity():
            return False
        c_m_j = params.commitment_to_messages(
            [(j, m) for j, m in sorted(revealed_msgs.items())])
        bases = [c_m_j.normalize()] + \
            [params.h[i] for i in self.hidden_indices] + [self.A_bar]
        if not self.response.is_valid(bases, self.B_bar, self.t, challenge):
            return False
        if pairing_checker is not None:
            pairing_checker.add_sources(self.A_bar, pk.w, self.B_bar, params.g2)
            return True
        return bls.multi_pairing([(self.A_bar, pk.w),
                                  (-self.B_bar, params.g2)]).is_one()


# ---------------------------------------------------------------------------
# IETF-draft-compatible PoK structure (reference `proof_23_ietf.rs`): one
# Schnorr relation over (hidden h_i, A_bar, B_bar) with witnesses
# (m_i, -e/r, -1/r) against the target -(sum revealed h_i*m_i) - g1, since
# A_bar*(-e/r) + B_bar*(-1/r) = -b.
# ---------------------------------------------------------------------------

@dataclass
class PoKOfSignature23IETFProtocol:
    A_bar: Point
    B_bar: Point
    sc: SchnorrCommitment
    sc_wits: list
    hidden_indices: list

    @classmethod
    def init(cls, rng, signature: Signature23G1,
             params: SignatureParams23G1, messages, revealed_indices: set,
             blindings: Optional[dict] = None):
        blindings = blindings or {}
        r = F.rand_nonzero(rng)
        minus_r_inv = -r.inverse()
        minus_r_inv_e = minus_r_inv * signature.e
        hidden = [i for i in range(len(messages))
                  if i not in revealed_indices]
        b_pt = params.commitment_to_messages(list(enumerate(messages)))
        A_bar = (signature.A * int(r)).normalize()
        B_bar = (b_pt * int(r) - A_bar * int(signature.e)).normalize()
        bases = [params.h[i] for i in hidden] + [A_bar, B_bar]
        wits = [messages[i] for i in hidden] + [minus_r_inv_e, minus_r_inv]
        randomness = [blindings.get(i, F.rand(rng)) for i in hidden] + \
            [F.rand(rng), F.rand(rng)]
        return cls(A_bar=A_bar, B_bar=B_bar,
                   sc=SchnorrCommitment.new(bases, randomness),
                   sc_wits=wits, hidden_indices=hidden)

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1,
                               writer: ByteWriter):
        _pok23_contribution(self.A_bar, self.B_bar, self.sc.t,
                            revealed_msgs, params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfSignature23IETF":
        return PoKOfSignature23IETF(
            A_bar=self.A_bar, B_bar=self.B_bar, t=self.sc.t,
            response=self.sc.response(self.sc_wits, challenge),
            hidden_indices=self.hidden_indices)


@dataclass
class PoKOfSignature23IETF:
    A_bar: Point
    B_bar: Point
    t: Point
    response: SchnorrResponse
    hidden_indices: list

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1,
                               writer: ByteWriter):
        _pok23_contribution(self.A_bar, self.B_bar, self.t, revealed_msgs,
                            params, writer)

    def verify(self, revealed_msgs: dict, challenge: Fp,
               pk: PublicKey23G2, params: SignatureParams23G1,
               pairing_checker=None) -> bool:
        if self.A_bar.is_infinity():
            return False
        bases = [params.h[i] for i in self.hidden_indices] + \
            [self.A_bar, self.B_bar]
        pr = -params.g1
        for j, m in sorted(revealed_msgs.items()):
            pr = pr - params.h[j] * int(m)
        if not self.response.is_valid(bases, pr.normalize(), self.t,
                                      challenge):
            return False
        if pairing_checker is not None:
            pairing_checker.add_sources(self.A_bar, pk.w, self.B_bar,
                                        params.g2)
            return True
        return bls.multi_pairing([
            (self.A_bar, pk.w),
            ((-self.B_bar).normalize(), params.g2)]).is_one()

    def get_resp_for_message(self, idx_in_hidden: int) -> Fp:
        return self.response.get_response(idx_in_hidden)


# ---------------------------------------------------------------------------
# CDL-style PoK (reference `proof_23_cdl.rs`): randomize to (A_bar, B_bar, d)
# with d = b*r2, A_bar = A*r1*r2, B_bar = d*r1 - A_bar*e; two Schnorr legs —
# (−e, r1) opening B_bar over (A_bar, d), and hidden messages + (−r3) over
# (h_i..., d) against −(sum revealed h_i m_i) − g1.  Pairing:
# e(A_bar, pk) == e(B_bar, g2).
# ---------------------------------------------------------------------------

@dataclass
class PoKOfSignature23CDLProtocol:
    A_bar: Point
    B_bar: Point
    d: Point
    sc1: PokPedersenCommitmentProtocol
    sc2: SchnorrCommitment
    sc2_wits: list
    hidden_indices: list

    @classmethod
    def init(cls, rng, signature: Signature23G1,
             params: SignatureParams23G1, messages, revealed_indices: set,
             blindings: Optional[dict] = None):
        blindings = blindings or {}
        r1 = F.rand(rng)
        r2 = F.rand_nonzero(rng)
        r3 = r2.inverse()
        hidden = [i for i in range(len(messages))
                  if i not in revealed_indices]
        b_pt = params.commitment_to_messages(list(enumerate(messages)))
        d = (b_pt * int(r2)).normalize()
        A_bar = (signature.A * int(r1 * r2)).normalize()
        B_bar = (d * int(r1) - A_bar * int(signature.e)).normalize()
        sc1 = PokPedersenCommitmentProtocol.init(
            -signature.e, F.rand(rng), A_bar, r1, F.rand(rng), d)
        bases2 = [params.h[i] for i in hidden] + [d]
        wits2 = [messages[i] for i in hidden] + [-r3]
        rand2 = [blindings.get(i, F.rand(rng)) for i in hidden] + \
            [F.rand(rng)]
        return cls(A_bar=A_bar, B_bar=B_bar, d=d, sc1=sc1,
                   sc2=SchnorrCommitment.new(bases2, rand2),
                   sc2_wits=wits2, hidden_indices=hidden)

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1,
                               writer: ByteWriter):
        _pok23_cdl_contribution(self.A_bar, self.B_bar, self.d, self.sc1.t,
                                self.sc2.t, revealed_msgs, params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfSignature23CDL":
        return PoKOfSignature23CDL(
            A_bar=self.A_bar, B_bar=self.B_bar, d=self.d,
            sc_resp_1=self.sc1.gen_proof(challenge), t2=self.sc2.t,
            sc_resp_2=self.sc2.response(self.sc2_wits, challenge),
            hidden_indices=self.hidden_indices)


def _pok23_cdl_contribution(A_bar, B_bar, d, t1, t2, revealed_msgs, params,
                            writer):
    for p in (A_bar, B_bar, d, t1, t2, params.g1):
        writer.point(p)
    for i in range(len(params.h)):
        writer.point(params.h[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])


@dataclass
class PoKOfSignature23CDL:
    A_bar: Point
    B_bar: Point
    d: Point
    sc_resp_1: PokPedersenCommitment
    t2: Point
    sc_resp_2: SchnorrResponse
    hidden_indices: list

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParams23G1,
                               writer: ByteWriter):
        _pok23_cdl_contribution(self.A_bar, self.B_bar, self.d,
                                self.sc_resp_1.t, self.t2, revealed_msgs,
                                params, writer)

    def verify(self, revealed_msgs: dict, challenge: Fp,
               pk: PublicKey23G2, params: SignatureParams23G1,
               pairing_checker=None) -> bool:
        if self.A_bar.is_infinity():
            return False
        if not self.sc_resp_1.verify(self.B_bar, self.A_bar, self.d,
                                     challenge):
            return False
        bases2 = [params.h[i] for i in self.hidden_indices] + [self.d]
        pr = -params.g1
        for j, m in sorted(revealed_msgs.items()):
            pr = pr - params.h[j] * int(m)
        if not self.sc_resp_2.is_valid(bases2, pr.normalize(), self.t2,
                                       challenge):
            return False
        if pairing_checker is not None:
            pairing_checker.add_sources(self.A_bar, pk.w, self.B_bar,
                                        params.g2)
            return True
        return bls.multi_pairing([
            (self.A_bar, pk.w),
            ((-self.B_bar).normalize(), params.g2)]).is_one()
