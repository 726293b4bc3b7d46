"""Simplest OT (Chou-Orlandi, 2015/267): batched 1-of-2 random OT
(reference `oblivious_transfer/src/base_ot/simplest_ot.rs`).  The port
of `crypto_tpu/ot/base_ot.py`.

Sender: a random, A = g*a (one per batch), with a Schnorr PoK of a.
Receiver, choice c_i: b_i random, B_i = c_i*A + g*b_i; key_i = H(i, b_i*A).
Sender: k_i^0 = H(i, a*B_i), k_i^1 = H(i, a*B_i - a*A).
Then k_i^{c_i} is the receiver's key.

The same draws from `rng` as the reference, so the same seed gives the
same keys.  Two differences of cost only: the scalar multiplications run
on the host's integers (`Point.__mul__` on G1), and the sender
computes a*A once a batch, where the reference computes it for every OT.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import compute_random_oracle_challenge
from ..schnorr.discrete_log import PokDiscreteLog, PokDiscreteLogProtocol
from ..serialize import ByteWriter, serialize_point

F = bls.Fr
KEY_SIZE = 16  # bytes, matches the AES-PRG seed size


def _derive(index: int, pt: Point) -> bytes:
    return hashlib.shake_256(
        index.to_bytes(4, "little") + serialize_point(pt)).digest(KEY_SIZE)


@dataclass
class BaseOTSenderSetup:
    a: Fp
    A: Point
    pok: PokDiscreteLog

    @classmethod
    def new(cls, rng, g: Point) -> "BaseOTSenderSetup":
        a = F.rand_nonzero(rng)
        A = g * int(a)
        prot = PokDiscreteLogProtocol.init(a, F.rand(rng), g)
        w = ByteWriter()
        prot.challenge_contribution(g, A, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        return cls(a=a, A=A, pok=prot.gen_proof(c))

    def message(self):
        return (self.A, self.pok)

    def derive_keys(self, receiver_pks: list) -> list:
        """[(k0, k1)] per OT instance."""
        aA = self.A * int(self.a)
        out = []
        for i, B in enumerate(receiver_pks):
            aB = B * int(self.a)
            out.append((_derive(i, aB), _derive(i, (aB - aA).normalize())))
        return out


@dataclass
class BaseOTReceiver:
    keys: list          # receiver's derived keys
    choices: list       # bits
    pks: list           # B_i to send

    @classmethod
    def new(cls, rng, g: Point, sender_msg, choices: list) -> "BaseOTReceiver":
        A, pok = sender_msg
        w = ByteWriter()
        pok.challenge_contribution(g, A, w)
        c = compute_random_oracle_challenge(F, w.bytes())
        if not pok.verify(A, g, c):
            raise ValueError("base OT: invalid sender PoK")
        keys, pks = [], []
        for i, ci in enumerate(choices):
            b = int(F.rand_nonzero(rng))
            gb = g * b
            pks.append((gb + A).normalize() if ci else gb)
            keys.append(_derive(i, A * b))
        return cls(keys=keys, choices=list(choices), pks=pks)


def do_base_ots(rng, g: Point, choices: list):
    """In-process convenience: returns (sender key pairs, receiver keys)."""
    sender = BaseOTSenderSetup.new(rng, g)
    receiver = BaseOTReceiver.new(rng, g, sender.message(), choices)
    return sender.derive_keys(receiver.pks), receiver.keys
