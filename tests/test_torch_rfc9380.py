"""The port's RFC 9380 hashing (`crypto_tpu_torch/hashing_rfc9380.py`)
against the RFC's own vectors (Appendix K.1 `expand_message_xmd`, J.9.1
BLS12381G1_XMD:SHA-256_SSWU_RO_) and against the reference's
`crypto_tpu/hashing_rfc9380.py` on seeded messages and DSTs: both
expanders, `hash_to_field_fq`, the SSWU map, the isogeny and the whole
`hash_to_curve_g1`, equal as integers.
"""

import hashlib
import random

import pytest

from crypto_tpu import hashing_rfc9380 as ref
from crypto_tpu_torch import hashing_rfc9380 as port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()

J91_DST = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"


def test_expand_message_xmd_k1():
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    assert port.expand_message_xmd(b"", dst, 0x20).hex() == \
        "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"
    assert port.expand_message_xmd(b"abc", dst, 0x20).hex() == \
        "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"


@pytest.mark.parametrize("msg, x, y", [
    (b"",
     0x052926add2207b76ca4fa57a8734416c8dc95e24501772c814278700eed6d1e4e8cf62d9c09db0fac349612b759e79a1,
     0x08ba738453bfed09cb546dbb0783dbb3a5f1f566ed67bb6be0e8c67e2e81a4cc68ee29813bb7994998f3eae0c9c6a265),
    (b"abc",
     0x03567bc5ef9c690c2ab2ecdf6a96ef1c139cc0b2f284dca0a9a7943388a49a3aee664ba5379a7655d3c68900be2f6903,
     0x0b9c15f3fe6e5cf4211f346271d7b01c8f3b28be689c8429c85b67af215533311f0b8dfaaa154fa6b88176c229f2885d),
], ids=["empty", "abc"])
def test_hash_to_curve_g1_j91(msg, x, y):
    assert port.hash_to_curve_g1(msg, J91_DST) == (x, y)
    pt = port.hash_to_curve_g1_point(msg, J91_DST)
    assert pt.curve is tb.G1 and (int(pt.X), int(pt.Y)) == (x, y)


def test_parity_on_seeded_inputs():
    rng = random.Random(9380)
    for i in range(4):
        msg = rng.randbytes(rng.randrange(0, 80))
        dst = b"PARITY-DST-" + bytes([i])
        n = rng.choice([1, 32, 48, 255])
        for fn in ("expand_message_xmd", "expand_message_xof"):
            assert getattr(port, fn)(msg, dst, n) == getattr(ref, fn)(
                msg, dst, n)
        assert port.expand_message_xmd(msg, dst, n, hashlib.sha512) == \
            ref.expand_message_xmd(msg, dst, n, hashlib.sha512)
        us = port.hash_to_field_fq(msg, dst, 2)
        assert us == ref.hash_to_field_fq(msg, dst, 2)
        for u in us:
            q = port._sswu_ep(u)
            assert q == ref._sswu_ep(u)
            assert port._iso_map(q) == ref._iso_map(q)
        for expander in ("expand_message_xmd", "expand_message_xof"):
            assert port.hash_to_curve_g1(
                msg, dst, expander=getattr(port, expander)) == \
                ref.hash_to_curve_g1(msg, dst,
                                     expander=getattr(ref, expander))


def test_output_in_subgroup_and_range():
    pt = port.hash_to_curve_g1_point(b"any message", b"TEST-DST")
    assert pt.is_on_curve() and pt.mul_raw(tb.R).is_infinity()
    us = port.hash_to_field_fq(b"x", b"DST", 4)
    assert len(us) == 4 and all(0 <= u < port.P for u in us)
    with pytest.raises(ValueError):
        port.expand_message_xmd(b"", b"d" * 256, 32)
    with pytest.raises(ValueError):
        port.expand_message_xof(b"", b"d", 65536)
