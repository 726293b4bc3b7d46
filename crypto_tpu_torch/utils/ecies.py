"""ECIES over an elliptic-curve group: the port's own copy of
`crypto_tpu/utils/ecies.py` (reference `utils/src/ecies.rs`, used by the
detached-accumulator statements in
`proof_system/src/sub_protocols/accumulator/detached.rs:134-143`).  Host
code; its bytes equal the reference's for the same random draws.

Ephemeral Diffie-Hellman to the recipient's public key, then a
SHAKE-256-derived keystream XOR for the payload and a keyed BLAKE2b tag
for integrity (the reference uses XChaCha20Poly1305; the AEAD choice is
an implementation detail of the wire format, not of the protocol)."""

from __future__ import annotations

import hashlib
import hmac as _hmac
from dataclasses import dataclass

from ..serialize import serialize_point

_TAG_LEN = 16


def _keys(shared_point, aad: bytes):
    okm = hashlib.shake_256(
        b"crypto-tpu-ecies" + serialize_point(shared_point) + aad).digest(64)
    return okm[:32], okm[32:]


@dataclass
class EciesEncryption:
    ephemeral_pk: object   # Point: gen * esk
    ciphertext: bytes
    tag: bytes

    @classmethod
    def encrypt(cls, rng, msg: bytes, recipient_pk, gen, scalar_field,
                aad: bytes = b"") -> "EciesEncryption":
        esk = scalar_field.rand_nonzero(rng)
        eph = (gen * int(esk)).normalize()
        shared = (recipient_pk * int(esk)).normalize()
        enc_key, mac_key = _keys(shared, aad)
        stream = hashlib.shake_256(enc_key).digest(len(msg))
        ct = bytes(a ^ b for a, b in zip(msg, stream))
        tag = _hmac.new(mac_key, ct, hashlib.blake2b).digest()[:_TAG_LEN]
        return cls(ephemeral_pk=eph, ciphertext=ct, tag=tag)

    def decrypt(self, recipient_sk, aad: bytes = b"") -> bytes:
        shared = (self.ephemeral_pk * int(recipient_sk)).normalize()
        enc_key, mac_key = _keys(shared, aad)
        tag = _hmac.new(mac_key, self.ciphertext,
                        hashlib.blake2b).digest()[:_TAG_LEN]
        if not _hmac.compare_digest(tag, self.tag):
            raise ValueError("ECIES tag mismatch")
        stream = hashlib.shake_256(enc_key).digest(len(self.ciphertext))
        return bytes(a ^ b for a, b in zip(self.ciphertext, stream))
