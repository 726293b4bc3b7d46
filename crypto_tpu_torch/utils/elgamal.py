"""ElGamal encryption family (reference `utils/src/elgamal.rs`), the
port's own copy of `crypto_tpu/utils/elgamal.py`, host code:
plain (group element), hashed (field element via hashed shared secret),
batched-hashed (OTP per message with a counter).  Plus BSGS discrete-log
solving for exponent-ElGamal decryption (`utils/src/solve_discrete_log.rs`)
used by SAVER.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, field_from_random_bytes_wide
from ..serialize import serialize_point

F = bls.Fr


@dataclass
class ElgamalSecretKey:
    x: Fp

    @classmethod
    def generate(cls, rng):
        return cls(F.rand_nonzero(rng))


@dataclass
class ElgamalPublicKey:
    y: Point

    @classmethod
    def generate(cls, sk: ElgamalSecretKey, g: Point):
        return cls((g * int(sk.x)).normalize())


def keygen(rng, g: Point):
    sk = ElgamalSecretKey.generate(rng)
    return sk, ElgamalPublicKey.generate(sk, g)


@dataclass
class Ciphertext:
    """encrypted = m + r*pk ; eph_pk = r*g"""
    encrypted: Point
    eph_pk: Point

    @classmethod
    def new(cls, rng, msg: Point, pk: ElgamalPublicKey, g: Point):
        r = F.rand(rng)
        return cls.new_given_randomness(msg, r, pk, g), r

    @classmethod
    def new_given_randomness(cls, msg: Point, r: Fp, pk: ElgamalPublicKey,
                             g: Point):
        return cls(encrypted=(pk.y * int(r) + msg).normalize(),
                   eph_pk=(g * int(r)).normalize())

    def decrypt(self, sk: ElgamalSecretKey) -> Point:
        return (self.encrypted - self.eph_pk * int(sk.x)).normalize()

    def rerandomize(self, rng, pk: ElgamalPublicKey, g: Point):
        r2 = F.rand(rng)
        return Ciphertext(
            encrypted=(self.encrypted + pk.y * int(r2)).normalize(),
            eph_pk=(self.eph_pk + g * int(r2)).normalize()), r2


def _hash_shared_secret(shared: Point, extra: bytes = b"") -> Fp:
    return field_from_random_bytes_wide(
        F, blake2b512(serialize_point(shared) + extra))[0]


@dataclass
class HashedElgamalCiphertext:
    """encrypted = m + H(r*pk) in the scalar field; eph_pk = r*g."""
    encrypted: Fp
    eph_pk: Point

    @classmethod
    def new(cls, rng, msg: Fp, pk: ElgamalPublicKey, g: Point):
        r = F.rand(rng)
        shared = pk.y * int(r)
        return cls(encrypted=msg + _hash_shared_secret(shared),
                   eph_pk=(g * int(r)).normalize()), r

    def decrypt(self, sk: ElgamalSecretKey) -> Fp:
        shared = self.eph_pk * int(sk.x)
        return self.encrypted - _hash_shared_secret(shared)


@dataclass
class BatchedHashedElgamalCiphertext:
    """OTP per message: c_i = m_i + H(shared || LE32(i)); one ephemeral key
    (`elgamal.rs:200-270`)."""
    encrypted: list
    eph_pk: Point

    @classmethod
    def new(cls, rng, msgs, pk: ElgamalPublicKey, g: Point):
        r = F.rand(rng)
        shared = pk.y * int(r)
        enc = [m + _hash_shared_secret(shared, i.to_bytes(4, "little"))
               for i, m in enumerate(msgs)]
        return cls(encrypted=enc, eph_pk=(g * int(r)).normalize()), r

    def decrypt(self, sk: ElgamalSecretKey) -> list:
        shared = self.eph_pk * int(sk.x)
        return [c - _hash_shared_secret(shared, i.to_bytes(4, "little"))
                for i, c in enumerate(self.encrypted)]


# ---------------------------------------------------------------------------
# discrete log solving (for exponent ElGamal / SAVER chunk decryption)
# ---------------------------------------------------------------------------

def solve_discrete_log_bsgs(max_value: int, base, target) -> int | None:
    """Baby-step giant-step for target = base^x (multiplicative, e.g. GT) or
    target = x*base (additive curve group), with 0 <= x <= max_value
    (`utils/src/solve_discrete_log.rs:8-50`)."""
    is_point = isinstance(base, Point)

    def op(a, b):
        return (a + b) if is_point else (a * b)

    def inv(a):
        return (-a) if is_point else a.inverse()

    def identity():
        return base.curve.infinity() if is_point else base.f.one()

    def key(x):
        if is_point:
            if x.is_infinity():
                return b"inf"
            ax, ay = x.to_affine()
            return ax.to_bytes_le() + ay.to_bytes_le()
        return x.to_bytes_le()

    m = int(math.isqrt(max_value)) + 1
    # baby steps: key(j * base) -> j
    table = {}
    acc = identity()
    for j in range(m):
        table.setdefault(key(acc), j)
        acc = op(acc, base)
    # giant steps: gamma = target - i*m*base
    giant = inv(acc)  # acc == m * base
    gamma = target
    for i in range(m + 1):
        j = table.get(key(gamma))
        if j is not None:
            x = i * m + j
            if x <= max_value:
                return x
        gamma = op(gamma, giant)
    return None


def solve_discrete_log_brute_force(max_value: int, base, target) -> int | None:
    is_point = isinstance(base, Point)
    acc = base.curve.infinity() if is_point else base.f.one()
    for x in range(max_value + 1):
        if acc == target:
            return x
        acc = (acc + base) if is_point else (acc * base)
    return None
