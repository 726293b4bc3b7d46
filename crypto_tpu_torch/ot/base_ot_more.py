"""More base OTs: Naor-Pinkas 1-of-n and Masny-Rindal Endemic OT
(reference `oblivious_transfer/src/base_ot/{naor_pinkas_ot,endemic_ot}.rs`).
The port of `crypto_tpu/ot/base_ot_more.py`: the same draws from `rng`
and the same keys; the scalar multiplications run on the host's integers
(`Point.__mul__` on G1).

Naor-Pinkas: the sender publishes g^r and random points C_1..C_{n-1}; the
receiver with choice sigma sends pk_0 (g^k if sigma = 0, else C_sigma -
g^k) so that pk_sigma = g^k; the sender derives per-index keys from
(C_i - pk_0)^r = pk_i^r and the receiver knows only (g^r)^k = pk_sigma^r.

Endemic OT: the receiver sends (B_0, B_1) with B_c = g^k and B_{1-c}
hashed from a random seed (so it provably does not know that point's
discrete log); the sender replies with A = g^a and derives both keys
(B_i)^a; the receiver recovers only A^k."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import group_elem_from_try_and_incr
from ..serialize import serialize_point

F = bls.Fr


def _key_from_point(p: Point, idx: int, tag: bytes) -> bytes:
    return hashlib.shake_256(
        tag + idx.to_bytes(4, "little") + serialize_point(p)).digest(16)


# ---------------------------------------------------------------------------
# Naor-Pinkas 1-of-n
# ---------------------------------------------------------------------------

@dataclass
class NPSender:
    r: Fp
    g_r: Point
    C: list                # n-1 random points
    C_r: list

    @classmethod
    def setup(cls, rng, g: Point, n: int):
        """The sender, with its public (g^r, C), reusable across OTs."""
        r = F.rand_nonzero(rng)
        C = [g * int(F.rand_nonzero(rng)) for _ in range(n - 1)]
        return cls(r=r, g_r=g * int(r), C=C,
                   C_r=[c * int(r) for c in C])

    def keys_for(self, pk_0: Point, n: int, ot_idx: int = 0) -> list:
        """Per-index symmetric keys: key_i = H(pk_i^r), pk_i = C_i - pk_0
        (C_0 the identity, so key_0 hashes pk_0^r)."""
        pk0_r = pk_0 * int(self.r)
        keys = [_key_from_point(pk0_r, ot_idx * 1000, b"np-ot")]
        for i in range(1, n):
            pk_i_r = (self.C_r[i - 1] - pk0_r).normalize()
            keys.append(_key_from_point(pk_i_r, ot_idx * 1000 + i,
                                        b"np-ot"))
        return keys


@dataclass
class NPReceiver:
    choice: int
    k: Fp
    pk_0: Point

    @classmethod
    def new(cls, rng, g: Point, sender_pub_C: list, choice: int):
        k = F.rand_nonzero(rng)
        g_k = g * int(k)
        pk_0 = g_k if choice == 0 else \
            (sender_pub_C[choice - 1] - g_k).normalize()
        return cls(choice=choice, k=k, pk_0=pk_0)

    def key(self, g_r: Point, ot_idx: int = 0) -> bytes:
        return _key_from_point(g_r * int(self.k),
                               ot_idx * 1000 + self.choice, b"np-ot")


# ---------------------------------------------------------------------------
# Endemic OT (1-of-2)
# ---------------------------------------------------------------------------

@dataclass
class EndemicReceiver:
    choice: int
    k: Fp
    B: tuple               # (B_0, B_1) sent to the sender

    @classmethod
    def new(cls, rng, g: Point, choice: int):
        k = F.rand_nonzero(rng)
        B_c = g * int(k)
        seed = bytes(rng.getrandbits(8) for _ in range(32))
        B_other = group_elem_from_try_and_incr(
            bls.G1, b"endemic-ot" + seed).normalize()
        B = (B_c, B_other) if choice == 0 else (B_other, B_c)
        return cls(choice=choice, k=k, B=B)

    def key(self, A: Point) -> bytes:
        return _key_from_point(A * int(self.k), self.choice, b"endemic")


@dataclass
class EndemicSender:
    a: Fp
    A: Point

    @classmethod
    def new(cls, rng, g: Point):
        a = F.rand_nonzero(rng)
        return cls(a=a, A=g * int(a))

    def keys(self, B: tuple) -> tuple:
        return tuple(_key_from_point(B[i] * int(self.a), i,
                                     b"endemic") for i in range(2))
