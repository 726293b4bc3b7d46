"""Gilboa-style two-party batch multiplication over OT extension (the
role of `dkls19_batch_mul_2p.rs` in the reference: additive shares of
a_t * b_t for batches of field-element pairs).  The port of
`crypto_tpu/ot/gilboa.py`.

Party1 (the OT-extension sender) holds a_t; Party2 (the receiver) holds
b_t.  For each multiplication t and bit position p of b_t, a correlated
OT with correlation a_t * 2^p: m0 = rho, m1 = rho + a_t * 2^p, the
receiver selecting by bit p of b_t.  share2_t = sum_p received,
share1_t = -sum_p rho, so share1_t + share2_t = a_t * b_t.
"""

from __future__ import annotations

import numpy as np

from ..curves import bls12_381 as bls
from .ot_extension import (OTEReceiver, OTESender, cot_receiver_decode,
                           cot_sender_messages)

F = bls.Fr
NBITS = F.bits  # 255


def receiver_choices(b_values) -> np.ndarray:
    """Bit matrix of the receiver's inputs, LSB-first per value."""
    out = np.zeros(len(b_values) * NBITS, dtype=np.uint8)
    for t, b_val in enumerate(b_values):
        v = int(b_val)
        for p in range(NBITS):
            out[t * NBITS + p] = (v >> p) & 1
    return out


def batch_mul_party2_round1(ote_receiver: OTEReceiver, b_values):
    """Party2 (holds b): the OT-extension choices and the U matrix."""
    choices = receiver_choices(b_values)
    U, keys = ote_receiver.process(choices)
    return U, keys, choices


def _sums(values: list, n: int) -> list:
    """Per multiplication t, the sum of values[t*NBITS:(t+1)*NBITS]."""
    p = F.p
    return [sum(int(v) for v in values[t * NBITS:(t + 1) * NBITS]) % p
            for t in range(n)]


def batch_mul_party1(ote_sender: OTESender, a_values, U: np.ndarray):
    """Party1 (holds a): returns (messages to send, own shares)."""
    n = len(a_values)
    row_keys = ote_sender.process(n * NBITS, U)
    correlations = [F((int(a_val) << p) % F.p)
                    for a_val in a_values for p in range(NBITS)]
    msgs, rhos = cot_sender_messages(row_keys, correlations)
    return msgs, [F(-s % F.p) for s in _sums(rhos, n)]


def batch_mul_party2_round2(keys, choices, msgs, n: int):
    """Party2: decode and sum its shares."""
    return [F(s) for s in _sums(cot_receiver_decode(keys, choices, msgs), n)]
