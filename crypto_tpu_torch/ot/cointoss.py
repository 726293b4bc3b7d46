"""Commit-and-release coin tossing, F_com of 2023/602 (reference
`oblivious_transfer/src/cointoss.rs`).  The port of
`crypto_tpu/ot/cointoss.py`.

One difference: the reference's `CointossParty.commit` draws its salts
from `os.urandom` and ignores `rng`; here they come from the caller's
`rng` (`rng.randbytes`, after the shares), so the same bytes give the
reference's commitments and joint values."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..curves import bls12_381 as bls
from ..fields.host import Fp

F = bls.Fr
SALT_SIZE = 16


def _commit(share: Fp, salt: bytes, protocol_id: bytes) -> bytes:
    return hashlib.sha256(protocol_id + salt + share.to_bytes_le()).digest()


@dataclass
class CointossParty:
    id: int
    protocol_id: bytes
    own_shares: list
    own_salts: list
    commitments: dict = field(default_factory=dict)   # other_id -> [bytes]
    revealed: dict = field(default_factory=dict)      # other_id -> [Fp]

    @classmethod
    def commit(cls, rng, id: int, batch_size: int, protocol_id: bytes):
        shares = [F.rand(rng) for _ in range(batch_size)]
        salts = [rng.randbytes(SALT_SIZE) for _ in range(batch_size)]
        party = cls(id=id, protocol_id=protocol_id, own_shares=shares,
                    own_salts=salts)
        return party, [_commit(s, salt, protocol_id)
                       for s, salt in zip(shares, salts)]

    def receive_commitments(self, other_id: int, comms: list):
        if other_id in self.commitments:
            raise ValueError("duplicate commitments")
        self.commitments[other_id] = comms

    def reveal(self):
        return list(zip(self.own_shares, self.own_salts))

    def receive_reveals(self, other_id: int, reveals: list):
        comms = self.commitments.get(other_id)
        if comms is None:
            raise ValueError("reveal before commitment")
        if len(reveals) != len(comms):
            raise ValueError("length mismatch")
        for (share, salt), c in zip(reveals, comms):
            if _commit(share, salt, self.protocol_id) != c:
                raise ValueError(f"commitment mismatch from {other_id}")
        self.revealed[other_id] = [s for s, _ in reveals]

    def compute_joint(self) -> list:
        """Joint randomness: the sum of everyone's shares, per batch item."""
        out = list(self.own_shares)
        for shares in self.revealed.values():
            for i, s in enumerate(shares):
                out[i] = out[i] + s
        return out

    def own(self) -> list:
        return list(self.own_shares)
