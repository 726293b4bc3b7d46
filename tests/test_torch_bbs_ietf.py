"""The port's IETF BBS ciphersuites (`crypto_tpu_torch/bbs_plus/ietf.py`)
against the draft's fixtures that the reference's `tests/test_bbs_ietf.py`
holds (the SHA-256 secret key, public key and base point P1; the
SHAKE-256 secret key and generators Q_1, H_1, H_2) and against the
reference's `crypto_tpu/bbs_plus/ietf.py`: for both ciphersuites the
signature and proof octets are equal byte for byte on the same inputs and
`random.Random` seeds, each package accepts the other's, and spoiled
signatures, proofs, messages and headers are refused by both.  The port's
pairing checks run with `device="cpu"` (a 2-pair product takes the host
route) and raise when CUDA is asked for without a card.
"""

import random

import pytest
import torch

from crypto_tpu.bbs_plus import ietf as ref
from crypto_tpu_torch.bbs_plus import ietf as port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()

KEY_MATERIAL = bytes.fromhex(
    "746869732d49532d6a7573742d616e2d546573742d494b4d2d746f2d67656e65"
    "726174652d246528724074232d6b6579")
KEY_INFO = bytes.fromhex(
    "746869732d49532d736f6d652d6b65792d6d657461646174612d746f2d62652d"
    "757365642d696e2d746573742d6b65792d67656e")
HEADER = bytes.fromhex("11223344556677889900aabbccddeeff")
MSG_1 = bytes.fromhex(
    "9872ad089e452c7b6e283dfac2a80d58e8d0ff71cc4d5e310a1debdda4a45f02")
MSG_2 = bytes.fromhex(
    "87a8bd656d49ee07b8110e1d8fd4f1dcef6fb9bc368c492d9bc8c4f98a739ac6")
MSGS = [MSG_1, MSG_2, b"third message", b"fourth message"]
PH = b"presentation-header"
SUITES = pytest.mark.parametrize("name", ["BLS12381_SHA256",
                                          "BLS12381_SHAKE256"],
                                 ids=["sha256", "shake256"])


def test_sha256_keygen_pk_p1_kat():
    cs = port.BLS12381_SHA256
    sk = cs.keygen(KEY_MATERIAL, KEY_INFO)
    assert int(sk) == \
        0x60e55110f76883a13d030b2f6bd11883422d5abde717569fc0731f51237169fc
    assert cs.sk_to_pk(sk).hex() == (
        "a820f230f6ae38503b86c70dc50b61c58a77e45c39ab25c0652bbaa8fa136f28"
        "51bd4781c9dcde39fc9d1d52c9e60268061e7d7632171d91aa8d460acee0e96f"
        "1e7c4cfb12d3ff9ab5d5dc91c277db75c845d649ef3c4f63aebc364cd55ded0c")
    assert port.point_to_octets_g1(cs.p1()).hex() == (
        "a8ce256102840821a3e94ea9025e4662b205762f9776b3a766c872b948f1fd22"
        "5e7c59698588e70d11406d161b4e28c9")


def test_shake256_keygen_generators_kat():
    cs = port.BLS12381_SHAKE256
    assert int(cs.keygen(KEY_MATERIAL, KEY_INFO)) == \
        0x2eee0f60a8a3a8bec0ee942bfd46cbdae9a0738ee68f5a64e7238311cf09a079
    q1, h1, h2 = cs.create_generators(3)
    assert [port.point_to_octets_g1(p).hex() for p in (q1, h1, h2)] == [
        "a9d40131066399fd41af51d883f4473b0dcd7d028d3d34ef17f3241d204e2850"
        "7d7ecae032afa1d5490849b7678ec1f8",
        "903c7ca0b7e78a2017d0baf74103bd00ca8ff9bf429f834f071c75ffe6bfdec6"
        "d6dca15417e4ac08ca4ae1e78b7adc0e",
        "84321f5855bfb6b001f0dfcb47ac9b5cc68f1a4edd20f0ec850e0563b27d2acc"
        "ee6edff1a26b357762fb24e8ddbb6fcb"]


@pytest.fixture(scope="module", params=["BLS12381_SHA256",
                                        "BLS12381_SHAKE256"],
                ids=["sha256", "shake256"])
def suite(request):
    """Both packages' ciphersuite, key, signature and a proof disclosing
    messages 0 and 2, from the same seed."""
    out = {}
    for pkg in (ref, port):
        cs = getattr(pkg, request.param)
        sk = cs.keygen(KEY_MATERIAL, KEY_INFO)
        pk = cs.sk_to_pk(sk)
        sig = cs.sign(sk, pk, HEADER, MSGS)
        proof = cs.proof_gen(pk, sig, HEADER, PH, MSGS, [0, 2],
                             random.Random(99))
        out[pkg] = (cs, pk, sig, proof)
    return out


def test_sign_and_proof_bytes_equal(suite):
    (_, pk_r, sig_r, proof_r), (_, pk_t, sig_t, proof_t) = suite[ref], \
        suite[port]
    assert pk_t == pk_r and sig_t == sig_r and proof_t == proof_r
    assert len(proof_t) == 3 * 48 + 3 * 32 + 2 * 32 + 32


def test_cross_verify_and_rejections(suite):
    cs_r, pk, sig, proof = suite[ref]
    cs = suite[port][0]
    dm = {0: MSGS[0], 2: MSGS[2]}
    assert cs.verify(pk, sig, HEADER, MSGS, device="cpu")
    assert cs.proof_verify(pk, proof, HEADER, PH, dm, len(MSGS),
                           device="cpu")
    assert not cs.verify(pk, sig, HEADER, [MSG_2] + MSGS[1:], device="cpu")
    assert not cs.verify(pk, sig, b"other header", MSGS, device="cpu")
    assert not cs.proof_verify(pk, proof, HEADER, b"other", dm, len(MSGS),
                               device="cpu")
    assert not cs.proof_verify(pk, proof, HEADER, PH, {0: MSG_2, 2: MSGS[2]},
                               len(MSGS), device="cpu")
    bad_sig = sig[:50] + bytes([sig[50] ^ 1]) + sig[51:]
    bad_proof = proof[:150] + bytes([proof[150] ^ 1]) + proof[151:]
    for verdict in (
            lambda c, **kw: c.verify(pk, bad_sig, HEADER, MSGS, **kw),
            lambda c, **kw: c.proof_verify(pk, bad_proof, HEADER, PH, dm,
                                           len(MSGS), **kw)):
        outs = []
        for c, kw in ((cs, {"device": "cpu"}), (cs_r, {})):
            try:
                outs.append(verdict(c, **kw))
            except ValueError:
                outs.append("raised")
        assert outs[0] == outs[1] and outs[0] in (False, "raised")


def test_default_device_is_cuda():
    cs = port.BLS12381_SHA256
    sk = cs.keygen(KEY_MATERIAL, KEY_INFO)
    pk = cs.sk_to_pk(sk)
    sig = cs.sign(sk, pk, HEADER, [MSG_1])
    assert sig == ref.BLS12381_SHA256.sign(
        ref.BLS12381_SHA256.keygen(KEY_MATERIAL, KEY_INFO), pk, HEADER,
        [MSG_1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cs.verify(pk, sig, HEADER, [MSG_1])


def test_point_octets_parity():
    rng = random.Random(3)
    for _ in range(3):
        p, q = tb.G1.rand(rng), tb.G2.rand(rng)
        b1, b2 = port.point_to_octets_g1(p), port.point_to_octets_g2(q)
        assert port.octets_to_point_g1(b1) == p.normalize()
        assert port.octets_to_point_g2(b2) == q.normalize()
        p_r = ref.octets_to_point_g1(b1)
        q_r = ref.octets_to_point_g2(b2)
        assert ref.point_to_octets_g1(p_r) == b1
        assert ref.point_to_octets_g2(q_r) == b2
    assert port.point_to_octets_g1(tb.G1.infinity()) == \
        ref.point_to_octets_g1(ref.bls.G1.infinity())
    b = port.point_to_octets_g1(tb.G1.rand(rng))
    for mut in (b[:-1], b"\x00" * 48, bytes([b[0] & 0x7F]) + b[1:]):
        with pytest.raises(ValueError):
            port.octets_to_point_g1(mut)
