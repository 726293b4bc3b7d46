"""Pairwise zero sharing, F_zero of 2023/602 (reference
`oblivious_transfer/src/zero_sharing.rs`).  The port of
`crypto_tpu/ot/zero_sharing.py`.

Each unordered pair (i, j) agrees on a seed by coin tossing; party i's
share of 0 is sum_{j != i} sign(i, j) PRF(seed_ij, tag), the sign +1 if
i < j else -1, so all shares sum to zero."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from .cointoss import CointossParty

F = bls.Fr


def _prf(seed: Fp, tag: bytes) -> Fp:
    d = hashlib.shake_256(b"zero-share-prf" + seed.to_bytes_le()
                          + tag).digest(64)
    return F(int.from_bytes(d, "little") % F.p)


@dataclass
class ZeroSharingParty:
    id: int
    batch_size: int
    protocol_id: bytes
    cointoss: dict = field(default_factory=dict)   # other_id -> CointossParty

    @classmethod
    def init(cls, rng, id: int, batch_size: int, others, protocol_id: bytes):
        """Returns (party, {other_id: commitments to send})."""
        party = cls(id=id, batch_size=batch_size, protocol_id=protocol_id)
        comms = {}
        for j in others:
            ct, c = CointossParty.commit(rng, id, 1,
                                         protocol_id + b"|zs|%d" % min(id, j)
                                         + b"-%d" % max(id, j))
            party.cointoss[j] = ct
            comms[j] = c
        return party, comms

    def receive_commitments(self, other_id: int, comms: list):
        self.cointoss[other_id].receive_commitments(other_id, comms)

    def reveals(self):
        return {j: ct.reveal() for j, ct in self.cointoss.items()}

    def receive_reveals(self, other_id: int, reveals: list):
        self.cointoss[other_id].receive_reveals(other_id, reveals)

    def compute_zero_shares(self) -> list:
        """batch_size shares, each summing to zero across parties."""
        seeds = {j: ct.compute_joint()[0] for j, ct in self.cointoss.items()}
        out = []
        for t in range(self.batch_size):
            tag = t.to_bytes(4, "little")
            acc = F(0)
            for j, seed in seeds.items():
                v = _prf(seed, tag)
                acc = acc + (v if self.id < j else -v)
            out.append(acc)
        return out
