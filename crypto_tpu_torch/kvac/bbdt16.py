"""BBDT16 KVAC: keyed-verification anonymous credentials via MAC_BB: the
port's own copy of `crypto_tpu/kvac/bbdt16.py` (reference
`kvac/src/bbdt_2016/`, paper section 3.2 of BBDT16).  Host code.

Everything lives in G1 — no pairings anywhere:

* params (g_0, g, h, g_1..g_n) hash-derived;  b = h + g*s + sum g_i*m_i
* MAC (A, e, s): A = b * 1/(e+x);  verification requires the secret key x:
  check A == b * 1/(e+x)
* optional public key pk = g_0*x enables a proof-of-validity (designated
  verifier doesn't need x): two Schnorr PoKs of x with a SHARED response
  for B = A*x and pk = g_0*x  (`mac.rs:160-230`)
* PoK of MAC (`proof_cdh.rs`): r1!=0, r2, r3=1/r1; B_0 = A*r1;
  C = b*r1 - B_0*e (= B_0 * x);  d = b*r1 - g*r2;  s' = s - r2*r3
  Schnorr 1: C - d == B_0*(-e) + g*r2
  Schnorr 2: d*(-r3) + g*s' + sum_{j hidden} g_j*m_j
               == -(h + sum_{i revealed} g_i*m_i)
  Verifier with key x additionally checks C == B_0 * x.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, group_elem_from_try_and_incr,
                       n_group_elements, compute_random_oracle_challenge)
from ..serialize import ByteWriter
from ..schnorr.discrete_log import (PokDiscreteLog, PokDiscreteLogProtocol,
                                    PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..utils.msm import msm

F = bls.Fr


class KVACError(Exception):
    pass


@dataclass
class MACParams:
    g_0: Point
    g: Point
    h: Point
    g_vec: list

    @classmethod
    def new(cls, label: bytes, message_count: int, digest=blake2b512):
        g_0 = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g_0"), digest).normalize()
        g = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g"), digest).normalize()
        h = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : h"), digest).normalize()
        g_vec = [p.normalize() for p in n_group_elements(
            bls.G1, 1, message_count + 1, concat_slices(label, b" : g_"), digest)]
        return cls(g_0=g_0, g=g, h=h, g_vec=g_vec)

    @property
    def supported_message_count(self):
        return len(self.g_vec)

    def b(self, indexed_messages, s: Fp) -> Point:
        bases = [self.g] + [self.g_vec[i] for i, _ in indexed_messages]
        scalars = [s] + [m for _, m in indexed_messages]
        return msm(bases, scalars) + self.h


@dataclass
class KVACSecretKey:
    x: Fp

    @classmethod
    def generate(cls, rng):
        return cls(F.rand_nonzero(rng))


@dataclass
class KVACPublicKey:
    pk: Point  # g_0 * x

    @classmethod
    def generate(cls, sk: KVACSecretKey, params: MACParams):
        return cls((params.g_0 * int(sk.x)).normalize())


@dataclass
class MAC:
    A: Point
    e: Fp
    s: Fp

    @classmethod
    def new(cls, rng, messages, sk: KVACSecretKey, params: MACParams) -> "MAC":
        if not messages:
            raise KVACError("no messages")
        if len(messages) != params.supported_message_count:
            raise KVACError("message count mismatch")
        s = F.rand(rng)
        e = F.rand(rng)
        while (e + sk.x).is_zero():
            e = F.rand(rng)
        b = params.b(list(enumerate(messages)), s)
        A = b * int((e + sk.x).inverse())
        return cls(A=A.normalize(), e=e, s=s)

    @classmethod
    def new_with_committed_messages(cls, rng, commitment: Point,
                                    uncommitted: dict, sk: KVACSecretKey,
                                    params: MACParams) -> "MAC":
        """Blind issuance: commitment = g*blinding + sum g_i*m_i over hidden
        messages (`mac.rs:90-125`)."""
        s = F.rand(rng)
        e = F.rand(rng)
        while (e + sk.x).is_zero():
            e = F.rand(rng)
        b = params.b(sorted(uncommitted.items()), s)
        A = (b + commitment) * int((e + sk.x).inverse())
        return cls(A=A.normalize(), e=e, s=s)

    def unblind(self, blinding: Fp) -> "MAC":
        return MAC(A=self.A, e=self.e, s=self.s + blinding)

    def verify(self, messages, sk: KVACSecretKey, params: MACParams) -> bool:
        if len(messages) != params.supported_message_count:
            raise KVACError("message count mismatch")
        b = params.b(list(enumerate(messages)), self.s)
        return (b * int((self.e + sk.x).inverse())) == self.A


@dataclass
class ProofOfValidityOfMAC:
    """Designated-verifier proof that the MAC was correctly issued
    (shared-response double Schnorr; `mac.rs:160-230`)."""
    sc_B: PokDiscreteLog
    sc_pk_t: Point  # commitment of the pk-side protocol (response shared)

    @classmethod
    def new(cls, rng, mac: MAC, sk: KVACSecretKey, pk: KVACPublicKey,
            params: MACParams) -> "ProofOfValidityOfMAC":
        blinding = F.rand(rng)
        B = (mac.A * int(sk.x)).normalize()
        p1 = PokDiscreteLogProtocol.init(sk.x, blinding, mac.A)
        p2 = PokDiscreteLogProtocol.init(sk.x, blinding, params.g_0)
        w = ByteWriter()
        p1.challenge_contribution(mac.A, B, w)
        p2.challenge_contribution(params.g_0, pk.pk, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        return cls(sc_B=p1.gen_proof(c), sc_pk_t=p2.t)

    def verify(self, mac: MAC, messages, pk: KVACPublicKey,
               params: MACParams) -> bool:
        B = (params.b(list(enumerate(messages)), mac.s)
             - mac.A * int(mac.e)).normalize()
        w = ByteWriter()
        self.sc_B.challenge_contribution(mac.A, B, w)
        from ..schnorr.discrete_log import compute_challenge_contribution
        compute_challenge_contribution(params.g_0, pk.pk, self.sc_pk_t, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        if not self.sc_B.verify(B, mac.A, c):
            return False
        # pk-side check reuses the SAME response (proves same x)
        shared = PokDiscreteLog(t=self.sc_pk_t, response=self.sc_B.response)
        return shared.verify(pk.pk, params.g_0, c)


@dataclass
class PoKOfMACProtocol:
    B_0: Point
    C: Point
    d: Point
    sc_C: PokPedersenCommitmentProtocol
    sc_comm_msgs: SchnorrCommitment
    sc_wits_msgs: list

    @classmethod
    def init(cls, rng, mac: MAC, params: MACParams, messages_and_blindings):
        messages = [mb.message for mb in messages_and_blindings]
        indexed_blindings = [
            (i, mb.blinding if mb.blinding is not None else F.rand(rng))
            for i, mb in enumerate(messages_and_blindings) if not mb.reveal
        ]
        r1 = F.rand_nonzero(rng)
        r2 = F.rand(rng)
        r3 = r1.inverse()
        s_prime = mac.s - r2 * r3
        B_0 = mac.A * int(r1)
        b = params.b(list(enumerate(messages)), mac.s)
        b_r1 = b * int(r1)
        C = (b_r1 - B_0 * int(mac.e)).normalize()
        d = (b_r1 - params.g * int(r2)).normalize()
        B_0 = B_0.normalize()

        sc_C = PokPedersenCommitmentProtocol.init(
            -mac.e, F.rand(rng), B_0, r2, F.rand(rng), params.g)
        bases = [params.g_vec[i] for i, _ in indexed_blindings] + [d, params.g]
        randomness = [bl for _, bl in indexed_blindings] + \
            [F.rand(rng), F.rand(rng)]
        wits = [messages[i] for i, _ in indexed_blindings] + [-r3, s_prime]
        return cls(B_0=B_0, C=C, d=d, sc_C=sc_C,
                   sc_comm_msgs=SchnorrCommitment.new(bases, randomness),
                   sc_wits_msgs=wits)

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               writer: ByteWriter):
        _pok_contribution(self.B_0, self.C, self.d, self.sc_C.t,
                          self.sc_comm_msgs.t, revealed_msgs, params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfMAC":
        return PoKOfMAC(
            B_0=self.B_0, C=self.C, d=self.d,
            sc_C=self.sc_C.gen_proof(challenge),
            t_msgs=self.sc_comm_msgs.t,
            sc_resp_msgs=self.sc_comm_msgs.response(self.sc_wits_msgs, challenge))


def _pok_contribution(B_0, C, d, t_C, t_msgs, revealed_msgs, params,
                      writer: ByteWriter):
    writer.point(B_0)
    writer.point(C)
    writer.point(d)
    writer.point(params.g)
    writer.point(params.h)
    writer.point(t_C)
    writer.point(t_msgs)
    for i in range(len(params.g_vec)):
        writer.point(params.g_vec[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])


@dataclass
class PoKOfMAC:
    B_0: Point
    C: Point
    d: Point
    sc_C: PokPedersenCommitment
    t_msgs: Point
    sc_resp_msgs: SchnorrResponse

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               writer: ByteWriter):
        _pok_contribution(self.B_0, self.C, self.d, self.sc_C.t, self.t_msgs,
                          revealed_msgs, params, writer)

    def verify_schnorr(self, revealed_msgs: dict, challenge: Fp,
                       params: MACParams) -> bool:
        if self.B_0.is_infinity():
            return False
        C_minus_d = (self.C - self.d).normalize()
        if not self.sc_C.verify(C_minus_d, self.B_0, params.g, challenge):
            return False
        hidden = [i for i in range(len(params.g_vec)) if i not in revealed_msgs]
        bases = [params.g_vec[i] for i in hidden] + [self.d, params.g]
        pts = [params.h] + [params.g_vec[i] for i in revealed_msgs]
        sc = [F(1)] + [revealed_msgs[i] for i in revealed_msgs]
        y = (-msm(pts, sc)).normalize()
        return self.sc_resp_msgs.is_valid(bases, y, self.t_msgs, challenge)

    def verify(self, revealed_msgs: dict, challenge: Fp, sk: KVACSecretKey,
               params: MACParams) -> bool:
        if not self.verify_schnorr(revealed_msgs, challenge, params):
            return False
        # keyed check: C == B_0 * x
        return (self.B_0 * int(sk.x)) == self.C

    def get_resp_for_message(self, msg_idx: int, revealed_ids=None) -> Fp:
        revealed_ids = revealed_ids or set()
        if msg_idx in revealed_ids:
            raise KVACError("message is revealed")
        adjusted = sum(1 for j in range(msg_idx) if j not in revealed_ids)
        return self.sc_resp_msgs.get_response(adjusted)

    def to_keyed_proof(self):
        """Extract the secret-key-dependent part for the issuer to check
        (reference `proof.rs` `to_keyed_proof`)."""
        from .keyed_proof import KeyedProof
        return KeyedProof(B_0=self.B_0, C=self.C)


# ---------------------------------------------------------------------------
# Original show protocol (reference `bbdt_2016/proof.rs`, Fig.2(2) of the
# paper): adds the E = C*(1/l) + f*t commitment over an extra public base f
# so the C-relation proof stays zero-knowledge even toward the key holder.
# ---------------------------------------------------------------------------

@dataclass
class PoKOfMACOriginalProtocol:
    B_0: Point
    C: Point
    E: Point
    sc_E: PokPedersenCommitmentProtocol
    sc_C: PokPedersenCommitmentProtocol
    sc_comm_msgs: SchnorrCommitment
    sc_wits_msgs: list

    @classmethod
    def init(cls, rng, mac: MAC, params: MACParams,
             messages_and_blindings, f: Point):
        messages = [mb.message for mb in messages_and_blindings]
        indexed_blindings = [
            (i, mb.blinding if mb.blinding is not None else F.rand(rng))
            for i, mb in enumerate(messages_and_blindings) if not mb.reveal
        ]
        minus_e = -mac.e
        l = F.rand_nonzero(rng)
        t = F.rand(rng)
        alpha = l.inverse()
        lam = minus_e * alpha
        gamma = -(l * t)

        B_0 = (mac.A * int(l)).normalize()
        b = params.b(list(enumerate(messages)), mac.s)
        C = (b * int(l) + B_0 * int(minus_e)).normalize()
        E = (C * int(alpha) + f * int(t)).normalize()
        t_blinding = F.rand(rng)
        sc_E = PokPedersenCommitmentProtocol.init(
            alpha, F.rand(rng), C, t, t_blinding, f)
        sc_C = PokPedersenCommitmentProtocol.init(
            l, F.rand(rng), E, gamma, F.rand(rng), f)

        bases = [params.g_vec[i] for i, _ in indexed_blindings] + \
            [params.g, B_0, f]
        randomness = [bl for _, bl in indexed_blindings] + \
            [F.rand(rng), F.rand(rng), t_blinding]
        wits = [messages[i] for i, _ in indexed_blindings] + \
            [mac.s, lam, t]
        return cls(B_0=B_0, C=C, E=E, sc_E=sc_E, sc_C=sc_C,
                   sc_comm_msgs=SchnorrCommitment.new(bases, randomness),
                   sc_wits_msgs=wits)

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               f: Point, writer: ByteWriter):
        _pok_orig_contribution(self.B_0, self.C, self.E, self.sc_C.t,
                               self.sc_E.t, revealed_msgs, params, f, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfMACOriginal":
        return PoKOfMACOriginal(
            B_0=self.B_0, C=self.C, E=self.E,
            sc_E=self.sc_E.gen_proof(challenge),
            sc_C=self.sc_C.gen_proof(challenge),
            t_msgs=self.sc_comm_msgs.t,
            sc_resp_msgs=self.sc_comm_msgs.response(self.sc_wits_msgs,
                                                    challenge))


def _pok_orig_contribution(B_0, C, E, t_C, t_E, revealed_msgs, params, f,
                           writer: ByteWriter):
    writer.point(B_0)
    writer.point(E)
    writer.point(C)
    writer.point(f)
    writer.point(params.h)
    writer.point(params.g)
    writer.point(t_C)
    writer.point(t_E)
    for i in range(len(params.g_vec)):
        writer.point(params.g_vec[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])


@dataclass
class PoKOfMACOriginal:
    B_0: Point
    C: Point
    E: Point
    sc_E: PokPedersenCommitment
    sc_C: PokPedersenCommitment
    t_msgs: Point
    sc_resp_msgs: SchnorrResponse

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               f: Point, writer: ByteWriter):
        _pok_orig_contribution(self.B_0, self.C, self.E, self.sc_C.t,
                               self.sc_E.t, revealed_msgs, params, f, writer)

    def verify_schnorr(self, revealed_msgs: dict, challenge: Fp,
                       params: MACParams, f: Point) -> bool:
        if self.B_0.is_infinity():
            return False
        # t-response shared between sc_E and the message commitment
        if self.sc_E.response2 != self.sc_resp_msgs.get_response(
                len(self.sc_resp_msgs.responses) - 1):
            return False
        if not self.sc_E.verify(self.E, self.C, f, challenge):
            return False
        if not self.sc_C.verify(self.C, self.E, f, challenge):
            return False
        hidden = [i for i in range(len(params.g_vec))
                  if i not in revealed_msgs]
        bases = [params.g_vec[i] for i in hidden] + \
            [params.g, self.B_0, f]
        pts = [params.h] + [params.g_vec[i] for i in revealed_msgs]
        sc = [F(1)] + [revealed_msgs[i] for i in revealed_msgs]
        y = (self.E - msm(pts, sc)).normalize()
        return self.sc_resp_msgs.is_valid(bases, y, self.t_msgs, challenge)

    def verify(self, revealed_msgs: dict, challenge: Fp, sk: KVACSecretKey,
               params: MACParams, f: Point) -> bool:
        if (self.B_0 * int(sk.x)) != self.C:
            return False
        return self.verify_schnorr(revealed_msgs, challenge, params, f)

    def get_resp_for_message(self, msg_idx: int, revealed_ids=None) -> Fp:
        revealed_ids = revealed_ids or set()
        if msg_idx in revealed_ids:
            raise KVACError("message is revealed")
        adjusted = sum(1 for j in range(msg_idx) if j not in revealed_ids)
        return self.sc_resp_msgs.get_response(adjusted)

    def to_keyed_proof(self):
        from .keyed_proof import KeyedProof
        return KeyedProof(B_0=self.B_0, C=self.C)
