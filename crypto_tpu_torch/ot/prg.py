"""AES-128-CTR PRG (reference `oblivious_transfer/src/aes_prng.rs`) and
the key-derivation helpers of the OT stack.  The port's copy of
`crypto_tpu/ot/prg.py`."""

from __future__ import annotations

import hashlib

import numpy as np
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from ..curves import bls12_381 as bls
from ..fields.host import Fp

F = bls.Fr
KAPPA = 128  # security parameter / base-OT count


def aes_ctr_prg(seed: bytes, nbytes: int) -> bytes:
    """Expand a 16-byte seed into a keystream (AES-128-CTR over zeros)."""
    if len(seed) != 16:
        raise ValueError(f"AES-128 seed of {len(seed)} bytes")
    enc = Cipher(algorithms.AES(seed), modes.CTR(b"\x00" * 16)).encryptor()
    return enc.update(b"\x00" * nbytes) + enc.finalize()


def prg_bits(seed: bytes, nbits: int) -> np.ndarray:
    """Pseudorandom bit vector (uint8 0/1) of length nbits."""
    raw = aes_ctr_prg(seed, (nbits + 7) // 8)
    return np.unpackbits(np.frombuffer(raw, dtype=np.uint8))[:nbits]


def hash_key(key: bytes, index: int, tag: bytes = b"") -> bytes:
    """Row key -> OTP key (`simplest_ot.rs:494` shape)."""
    return hashlib.shake_256(
        index.to_bytes(8, "little") + tag + key).digest(32)


def key_to_int(key: bytes, tag: bytes = b"") -> int:
    """`key_to_field`'s value as an int in [0, r)."""
    d = hashlib.shake_256(b"OTP-field" + tag + key).digest(64)
    return int.from_bytes(d, "little") % F.p


def key_to_field(key: bytes, tag: bytes = b"") -> Fp:
    """Derive a field element OTP from a key."""
    return F(key_to_int(key, tag))


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(np.uint8)).tobytes()
