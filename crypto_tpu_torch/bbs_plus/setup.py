"""BBS+ setup, signature params and keys: the port's own copy of
`crypto_tpu/bbs_plus/setup.py` (reference `bbs_plus/src/setup.rs`).

Params for signing `n` messages (G1 signatures):
  g1, h_0, h_1..h_n in G1 derived by try-and-increment hashing of a label
  (`setup.rs:236-266`: g1 from `label || " : g1"`, h_i from
  `label || " : h_" || LE32(i)` for i in 0..=n), g2 in G2 from
  `label || " : g2"`.  Secret key x; public key = g2 * x.  Host code only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, field_elem_from_try_and_incr,
                       group_elem_from_try_and_incr, n_group_elements)
from ..utils.msm import msm
from ..utils.zeroize import ZeroizeMixin


@dataclass
class SecretKey(ZeroizeMixin):
    x: Fp

    @classmethod
    def generate(cls, rng) -> "SecretKey":
        return cls(bls.Fr.rand_nonzero(rng))

    @classmethod
    def from_seed(cls, seed: bytes) -> "SecretKey":
        """Deterministic keygen by hashing seed (reference
        `generate_using_seed` with an HKDF-style map; this uses the
        try-and-increment field hash, as the reference package does)."""
        return cls(field_elem_from_try_and_incr(bls.Fr, seed))


@dataclass
class SignatureParamsG1:
    g1: Point
    g2: Point
    h_0: Point
    h: list  # h_1..h_n (list of Point, length = message count)

    @classmethod
    def new(cls, label: bytes, message_count: int,
            digest=blake2b512) -> "SignatureParamsG1":
        if message_count <= 0:
            raise ValueError("message_count must be positive")
        g1 = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g1"), digest).normalize()
        hs = n_group_elements(
            bls.G1, 0, message_count + 1, concat_slices(label, b" : h_"),
            digest)
        hs = [h.normalize() for h in hs]
        g2 = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : g2"), digest).normalize()
        return cls(g1=g1, g2=g2, h_0=hs[0], h=hs[1:])

    @classmethod
    def generate_using_rng(cls, rng,
                           message_count: int) -> "SignatureParamsG1":
        return cls(
            g1=bls.G1.rand(rng).normalize(),
            g2=bls.G2.rand(rng).normalize(),
            h_0=bls.G1.rand(rng).normalize(),
            h=[bls.G1.rand(rng).normalize() for _ in range(message_count)],
        )

    @property
    def supported_message_count(self) -> int:
        return len(self.h)

    def is_valid(self) -> bool:
        return not (self.g1.is_infinity() or self.g2.is_infinity()
                    or self.h_0.is_infinity()
                    or any(p.is_infinity() for p in self.h))

    def commit_to_messages(self, indexed_messages, s_randomness=None) -> Point:
        """sum h_i * m_i (+ h_0 * s).  `indexed_messages`: [(idx, msg)]."""
        bases, scalars = [], []
        if s_randomness is not None:
            bases.append(self.h_0)
            scalars.append(s_randomness)
        for i, m in indexed_messages:
            bases.append(self.h[i])
            scalars.append(m)
        if not bases:
            return bls.G1.infinity()
        return msm(bases, scalars)

    def b(self, indexed_messages, s: Fp) -> Point:
        """b = g1 + h_0*s + sum h_i*m_i (`setup.rs:153-220`)."""
        return self.commit_to_messages(indexed_messages, s) + self.g1


@dataclass
class PublicKeyG2:
    w: Point  # g2 * x

    @classmethod
    def generate(cls, sk: SecretKey,
                 params: SignatureParamsG1) -> "PublicKeyG2":
        return cls((params.g2 * int(sk.x)).normalize())

    def is_valid(self) -> bool:
        return not self.w.is_infinity()


@dataclass
class KeypairG2:
    secret_key: SecretKey
    public_key: PublicKeyG2

    @classmethod
    def generate(cls, rng, params: SignatureParamsG1) -> "KeypairG2":
        sk = SecretKey.generate(rng)
        return cls(sk, PublicKeyG2.generate(sk, params))
