"""ALSZ OT extension (IKNP-style; reference
`oblivious_transfer/src/ot_extensions/alsz_ote.rs`) and the correlated OT
of field elements that Gilboa multiplication runs on.  The port of
`crypto_tpu/ot/ot_extension.py`.

Roles (note the reversal): the extension SENDER was the base-OT RECEIVER
(it knows s in {0,1}^kappa and the seeds k_i^{s_i}); the extension
RECEIVER was the base-OT SENDER (it knows every seed pair).

Receiver (choices x in {0,1}^m):
  t_i = PRG(k_i^0, m),  u_i = t_i XOR PRG(k_i^1, m) XOR x   -> send U
Sender:
  q_i = PRG(k_i^{s_i}, m) XOR s_i * u_i;  rows q_j satisfy
  q_j = t_j XOR (x_j * s).  Keys: sender (H(j, q_j), H(j, q_j XOR s));
  receiver H(j, t_j), the chosen key.

The bit-matrix transpose is numpy's: the reference reaches for its
native C++ transpose when the shapes allow and falls back to the same
numpy transpose, which gives the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..curves import bls12_381 as bls
from .prg import KAPPA, hash_key, key_to_int, prg_bits

F = bls.Fr


def _transpose_bits(M: np.ndarray) -> np.ndarray:
    """Bit-matrix transpose, as a contiguous array."""
    return np.ascontiguousarray(M.T)


def _row_keys(rows: np.ndarray) -> list:
    """H(j, row j as packed bytes) for each bit row of `rows` (m, kappa)."""
    packed = np.packbits(rows, axis=1)
    nb = packed.shape[1]
    buf = packed.tobytes()
    return [hash_key(buf[j * nb:(j + 1) * nb], j) for j in range(len(rows))]


@dataclass
class OTESender:
    """Extension sender; holds base choices s and seeds k_i^{s_i}."""
    s_bits: np.ndarray           # (kappa,) 0/1
    seeds: list                  # kappa seeds (16B each)

    @classmethod
    def from_base(cls, base_choices, base_keys):
        return cls(s_bits=np.asarray(base_choices, dtype=np.uint8),
                   seeds=list(base_keys))

    @property
    def kappa(self) -> int:
        return len(self.seeds)

    def q_matrix(self, m: int, U: np.ndarray) -> np.ndarray:
        """(kappa, m) bits q_i = PRG(k_i^{s_i}, m) XOR s_i * u_i."""
        Q = np.stack([prg_bits(seed, m) for seed in self.seeds])
        return Q ^ (U * self.s_bits[:, None]).astype(np.uint8)

    def process(self, m: int, U: np.ndarray):
        """U: (kappa, m) bit matrix from the receiver.  Returns the row
        keys [(k0_j, k1_j)] for j < m."""
        Qt = _transpose_bits(self.q_matrix(m, U))        # (m, kappa)
        return list(zip(_row_keys(Qt), _row_keys(Qt ^ self.s_bits)))


@dataclass
class OTEReceiver:
    """Extension receiver; holds all base seed pairs."""
    seed_pairs: list             # kappa pairs (k0, k1)

    @property
    def kappa(self) -> int:
        return len(self.seed_pairs)

    def tu_matrices(self, x: np.ndarray) -> tuple:
        """(T, U), (kappa, m) bits: t_i = PRG(k_i^0, m), u_i = t_i XOR
        PRG(k_i^1, m) XOR x."""
        m = len(x)
        T = np.stack([prg_bits(k0, m) for k0, _ in self.seed_pairs])
        U = np.stack([prg_bits(k1, m) for _, k1 in self.seed_pairs]) ^ T ^ x
        return T, U

    def process(self, choices: np.ndarray):
        """choices: (m,) bits.  Returns (U matrix to send, derived keys)."""
        T, U = self.tu_matrices(np.asarray(choices, dtype=np.uint8))
        return U, _row_keys(_transpose_bits(T))


def setup_ote_pair(rng, g, seed_rng=None, kappa: int = KAPPA):
    """In-process base-OT phase for one ordered pair: returns
    (OTESender for party A, OTEReceiver for party B)."""
    from .base_ot import do_base_ots
    r = seed_rng or rng
    base_choices = [r.randrange(2) for _ in range(kappa)]
    pairs, chosen = do_base_ots(rng, g, base_choices)
    # party B was the base-OT sender (it has the pairs) and becomes the
    # extension receiver; party A, the base-OT receiver, the sender
    return OTESender.from_base(base_choices, chosen), OTEReceiver(pairs)


# ---------------------------------------------------------------------------
# correlated OT of field elements (for Gilboa multiplication)
# ---------------------------------------------------------------------------

def cot_sender_messages(row_keys, correlations):
    """Sender: for OT j with correlation c_j, rho_j = OTP(k0_j, "rho") and
    the pads (e0_j, e1_j) = (rho_j + H(k0_j), rho_j + c_j + H(k1_j)).
    Returns (the pairs to send, the rhos)."""
    p = F.p
    msgs, rhos = [], []
    for (k0, k1), corr in zip(row_keys, correlations):
        rho = key_to_int(k0, b"rho")
        msgs.append((F((rho + key_to_int(k0)) % p),
                     F((rho + int(corr) + key_to_int(k1)) % p)))
        rhos.append(F(rho))
    return msgs, rhos


def cot_receiver_decode(keys, choices, msgs):
    """Receiver: decrypt the chosen pad per OT."""
    p = F.p
    return [F((int(e1 if c else e0) - key_to_int(key)) % p)
            for key, c, (e0, e1) in zip(keys, choices, msgs)]
