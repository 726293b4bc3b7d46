"""KOS15 actively secure OT extension (reference
`oblivious_transfer/src/ot_extensions/kos_ote.rs`).  The port of
`crypto_tpu/ot/kos_ote.py`.

ALSZ/IKNP extension hardened with the KOS consistency check: the receiver
extends its choice vector with kappa + s random bits, and after sending U
both sides derive a random challenge matrix chi (an XOF over U).  The
receiver reveals the random linear combinations
    x = XOR_i (choice_i ? chi_i : 0),   t = XOR_i (T_i AND chi_i)
and the sender checks t == (XOR_i Q_i AND chi_i) XOR (x AND s).

Also the correlated field-element transfer of actively secure
multiplication: per OT i the sender holds alpha_i = (a, a') and outputs
t_A_i, sending tau_i = H(q_i XOR s) - H(q_i) + alpha_i; the receiver
outputs t_B_i with t_A_i + t_B_i = choice_i * alpha_i.

The same draws and outputs as the reference; the row XORs and the linear
combinations run as whole-matrix numpy operations.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..curves import bls12_381 as bls
from .ot_extension import OTEReceiver, OTESender, _transpose_bits

F = bls.Fr


class OTError(Exception):
    pass


@dataclass
class RLC:
    x: bytes
    t: bytes


def _gen_randomness(num_base: int, l_prime: int,
                    U_bytes: bytes) -> np.ndarray:
    """chi matrix via SHAKE-256 over U (reference `gen_randomness`)."""
    row_bytes = num_base // 8
    seed = num_base.to_bytes(4, "big") + l_prime.to_bytes(4, "big") + U_bytes
    out = hashlib.shake_256(seed).digest(l_prime * row_bytes)
    return np.frombuffer(out, dtype=np.uint8).reshape(l_prime, row_bytes)


def _rows_to_bytes(M_bits: np.ndarray) -> np.ndarray:
    """(n, kappa) bit rows -> (n, kappa/8) byte rows."""
    return np.packbits(M_bits, axis=1, bitorder="little")


def _xor_rows(M: np.ndarray) -> np.ndarray:
    """XOR of the rows of a (n, k) uint8 matrix."""
    return np.bitwise_xor.reduce(M, axis=0) if len(M) else \
        np.zeros(M.shape[1], dtype=np.uint8)


def _h2i(tag: bytes, seed: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(tag + seed, digest_size=64)
                          .digest(), "little") % F.p


def _hash_pairs(rows: np.ndarray) -> list:
    """hash_to_field_pair(i, rows[i]) as int pairs, for every row."""
    nb = rows.shape[1]
    buf = rows.tobytes()
    return [(_h2i(b"KOS-OTE-0", seed), _h2i(b"KOS-OTE-1", seed))
            for seed in (i.to_bytes(4, "big") + buf[i * nb:(i + 1) * nb]
                         for i in range(len(rows)))]


def hash_to_field_pair(index: int, row: bytes) -> tuple:
    seed = index.to_bytes(4, "big") + row
    return F(_h2i(b"KOS-OTE-0", seed)), F(_h2i(b"KOS-OTE-1", seed))


@dataclass
class KOSReceiverSetup:
    choices: np.ndarray          # extended choices (l')
    T_rows: np.ndarray           # (l', ROW_BYTES) byte rows
    num_ot: int

    @classmethod
    def new(cls, rng, receiver: OTEReceiver, choices,
            statistical_security: int = 64):
        """Returns (setup, U bit-matrix to send, RLC to send)."""
        if statistical_security % 8:
            raise OTError("security parameter must be a multiple of 8")
        KAPPA = receiver.kappa
        base = np.asarray(choices, dtype=np.uint8)
        ext = np.array([rng.randrange(2)
                        for _ in range(KAPPA + statistical_security)],
                       dtype=np.uint8)
        x_all = np.concatenate([base, ext])
        l_prime = len(x_all)
        T, U = receiver.tu_matrices(x_all)
        T_rows = _rows_to_bytes(_transpose_bits(T))
        chi = _gen_randomness(KAPPA, l_prime, _rows_to_bytes(U).tobytes())
        x = _xor_rows(chi[x_all != 0])
        t = _xor_rows(T_rows & chi)
        setup = cls(choices=x_all, T_rows=T_rows, num_ot=len(base))
        return setup, U, RLC(x=x.tobytes(), t=t.tobytes())

    def receive_ints(self, tau: list) -> list:
        """`receive` as int pairs."""
        if len(tau) != self.num_ot:
            raise OTError("wrong number of correlations")
        p = F.p
        out = []
        for c, (tau0, tau1), (h0, h1) in zip(
                self.choices, tau, _hash_pairs(self.T_rows[:self.num_ot])):
            out.append(((int(tau0) - h0) % p, (int(tau1) - h1) % p) if c
                       else (-h0 % p, -h1 % p))
        return out

    def receive(self, tau: list) -> list:
        """Correlated transfer: returns t_B_i with
        t_A_i + t_B_i = choice_i * alpha_i (pairs of field elements)."""
        return [(F(a), F(b)) for a, b in self.receive_ints(tau)]


@dataclass
class KOSSenderSetup:
    Q_rows: np.ndarray           # (l', ROW_BYTES)
    s_row: np.ndarray            # (ROW_BYTES,) base choices as bytes
    num_ot: int

    @classmethod
    def new(cls, sender: OTESender, num_ot: int, U: np.ndarray, rlc: RLC,
            statistical_security: int = 64):
        if statistical_security % 8:
            raise OTError("security parameter must be a multiple of 8")
        KAPPA = sender.kappa
        row_bytes = KAPPA // 8
        l_prime = num_ot + KAPPA + statistical_security
        if U.shape != (KAPPA, l_prime):
            raise OTError("bad U shape")
        if len(rlc.x) != row_bytes or len(rlc.t) != row_bytes:
            raise OTError("bad RLC size")
        Q_rows = _rows_to_bytes(_transpose_bits(sender.q_matrix(l_prime, U)))
        chi = _gen_randomness(KAPPA, l_prime, _rows_to_bytes(U).tobytes())
        q = _xor_rows(Q_rows & chi)
        s_row = np.packbits(sender.s_bits, bitorder="little")
        x = np.frombuffer(rlc.x, dtype=np.uint8)
        if rlc.t != (q ^ (x & s_row)).tobytes():
            raise OTError("KOS consistency check failed")
        return cls(Q_rows=Q_rows, s_row=s_row, num_ot=num_ot)

    def transfer_ints(self, alpha: list):
        """`transfer` as int pairs, with the same correlation (a0, a1) for
        every OT when `alpha` is one pair rather than a list."""
        n = self.num_ot
        if isinstance(alpha, tuple):
            alpha = [alpha] * n
        if len(alpha) != n:
            raise OTError("wrong number of correlations")
        p = F.p
        q = self.Q_rows[:n]
        t_A, tau = [], []
        for (a0, a1), (hq0, hq1), (hs0, hs1) in zip(
                alpha, _hash_pairs(q), _hash_pairs(q ^ self.s_row)):
            t_A.append((hq0, hq1))
            tau.append(((hs0 - hq0 + int(a0)) % p,
                        (hs1 - hq1 + int(a1)) % p))
        return t_A, tau

    def transfer(self, alpha: list):
        """Returns (sender outputs t_A, correlation tags tau to send)."""
        t_A, tau = self.transfer_ints(alpha)
        return ([(F(a), F(b)) for a, b in t_A],
                [(F(a), F(b)) for a, b in tau])
