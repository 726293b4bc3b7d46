"""Weak Boneh-Boyen signatures and their proofs of knowledge: the port's
own copy of `crypto_tpu/short_group_sig/weak_bb.py` (reference
`short_group_sig/src/{weak_bb_sig,weak_bb_sig_pok_cdh,
weak_bb_sig_pok_kv}.rs`).

Signature on message m: A = g1 * 1/(m + x).  Verify: e(A, g2*m + pk) ==
e(g1, g2).

PoK (CDH variant, pairing-free prover):
  r random; A' = A*r; A_bar = g1*r - A'*m
  Schnorr: knowledge of (r, m) in A_bar = g1*r + (-A')*m
  Verifier: Schnorr check + e(A_bar, g2) == e(A', pk), i.e.
  e(A', pk) * e(-A_bar, g2) == 1: on the host (`verify`), or deferred
  into a `utils.checkers.RandomizedPairingChecker`
  (`verify_with_pairing_checker`), whose lazy Miller product runs on the
  device.

This PoK is also the membership proof of the VB accumulator (g1 -> V,
m -> member; `accumulator/proofs_cdh.py`).  The keyed-verification PoK
needs no pairing anywhere: the verifier holds x.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..serialize import ByteWriter

F = bls.Fr


@dataclass
class WeakBBSecretKey:
    x: Fp

    @classmethod
    def generate(cls, rng):
        return cls(F.rand_nonzero(rng))


@dataclass
class WeakBBPublicKeyG2:
    w: Point  # g2 * x

    @classmethod
    def generate(cls, sk: WeakBBSecretKey, g2: Point):
        return cls((g2 * int(sk.x)).normalize())


@dataclass
class WeakBBSig:
    A: Point

    @classmethod
    def new(cls, message: Fp, sk: WeakBBSecretKey, g1: Point) -> "WeakBBSig":
        return cls((g1 * int((message + sk.x).inverse())).normalize())

    def verify(self, message: Fp, pk: WeakBBPublicKeyG2, g1: Point,
               g2: Point) -> bool:
        # e(A, g2*m + pk) == e(g1, g2)
        rhs = (g2 * int(message) + pk.w).normalize()
        return bls.multi_pairing([(self.A, rhs), (-g1, g2)]).is_one()


def compute_challenge_contribution(A_bar, A_prime, g1, t, writer: ByteWriter):
    writer.points((A_bar, A_prime, g1, t))


@dataclass
class PoKWeakBBSigProtocol:
    """CDH-style PoK: the prover needs no pairings."""
    A_prime: Point
    A_bar: Point
    sc: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, signature: WeakBBSig | Point, message: Fp, g1: Point,
             blinding: Optional[Fp] = None) -> "PoKWeakBBSigProtocol":
        return cls.init_with_given_randomness(
            F.rand(rng), blinding if blinding is not None else F.rand(rng),
            F.rand(rng), signature, message, g1)

    @classmethod
    def init_with_given_randomness(cls, r: Fp, m_blinding: Fp,
                                   r_blinding: Fp,
                                   signature: WeakBBSig | Point,
                                   message: Fp,
                                   g1: Point) -> "PoKWeakBBSigProtocol":
        A = signature.A if isinstance(signature, WeakBBSig) else signature
        A_prime = A * int(r)
        A_prime_neg = (-A_prime).normalize()
        A_bar = (g1 * int(r) + A_prime_neg * int(message)).normalize()
        sc = PokPedersenCommitmentProtocol.init(
            r, r_blinding, g1, message, m_blinding, A_prime_neg)
        return cls(A_prime=A_prime.normalize(), A_bar=A_bar, sc=sc)

    def challenge_contribution(self, g1: Point, writer: ByteWriter) -> None:
        compute_challenge_contribution(self.A_bar, self.A_prime, g1,
                                       self.sc.t, writer)

    def gen_proof(self, challenge: Fp) -> "PoKWeakBBSig":
        return PoKWeakBBSig(A_prime=self.A_prime, A_bar=self.A_bar,
                            sc=self.sc.gen_proof(challenge))


@dataclass
class PoKWeakBBSig:
    A_prime: Point
    A_bar: Point
    sc: PokPedersenCommitment

    def challenge_contribution(self, g1: Point, writer: ByteWriter) -> None:
        compute_challenge_contribution(self.A_bar, self.A_prime, g1,
                                       self.sc.t, writer)

    def verify_schnorr(self, challenge: Fp, g1: Point) -> bool:
        if self.A_prime.is_infinity():
            return False
        return self.sc.verify(self.A_bar, g1, (-self.A_prime).normalize(),
                              challenge)

    def verify(self, challenge: Fp, pk: WeakBBPublicKeyG2, g1: Point,
               g2: Point) -> bool:
        if not self.verify_schnorr(challenge, g1):
            return False
        return bls.multi_pairing([(self.A_prime, pk.w),
                                  (-self.A_bar, g2)]).is_one()

    def verify_with_pairing_checker(self, challenge: Fp,
                                    pk: WeakBBPublicKeyG2, g1: Point,
                                    g2: Point, checker) -> bool:
        if not self.verify_schnorr(challenge, g1):
            return False
        checker.add_sources(self.A_prime, pk.w, self.A_bar, g2)
        return True

    def get_resp_for_message(self) -> Fp:
        return self.sc.response2


@dataclass
class PoKWeakBBSigKVProtocol:
    """Keyed-verification PoK of a weak-BB signature: A' = A*r, A_bar =
    g1*r - A'*m; the verifier holds the secret key and checks A_bar ==
    A'*x plus one Pedersen-style Schnorr over bases (g1, -A')."""
    A_prime: Point
    A_bar: Point
    sc: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, signature: WeakBBSig, message: Fp, g1: Point,
             blinding: Fp = None):
        sig_randomizer = F.rand_nonzero(rng)
        msg_blinding = blinding if blinding is not None else F.rand(rng)
        A_prime = (signature.A * int(sig_randomizer)).normalize()
        A_prime_neg = (-A_prime).normalize()
        A_bar = (g1 * int(sig_randomizer)
                 + A_prime_neg * int(message)).normalize()
        sc = PokPedersenCommitmentProtocol.init(
            sig_randomizer, F.rand(rng), g1, message, msg_blinding,
            A_prime_neg)
        return cls(A_prime=A_prime, A_bar=A_bar, sc=sc)

    def challenge_contribution(self, g1: Point, writer: ByteWriter):
        compute_challenge_contribution(self.A_bar, self.A_prime, g1,
                                       self.sc.t, writer)

    def gen_proof(self, challenge: Fp) -> "PoKWeakBBSigKV":
        return PoKWeakBBSigKV(A_prime=self.A_prime, A_bar=self.A_bar,
                              sc=self.sc.gen_proof(challenge))


@dataclass
class PoKWeakBBSigKV:
    A_prime: Point
    A_bar: Point
    sc: PokPedersenCommitment

    def challenge_contribution(self, g1: Point, writer: ByteWriter):
        compute_challenge_contribution(self.A_bar, self.A_prime, g1,
                                       self.sc.t, writer)

    def verify(self, challenge: Fp, secret_key: WeakBBSecretKey,
               g1: Point) -> bool:
        if self.A_bar != (self.A_prime * int(secret_key.x)).normalize():
            return False
        return self.sc.verify(self.A_bar, g1, (-self.A_prime).normalize(),
                              challenge)

    def response_for_message(self) -> Fp:
        return self.sc.response2
