"""secp256r1 (NIST P-256) and Tom-256, host curves only: the port's own
copy of `crypto_tpu/curves/extra_curves.py`.

secp256r1 is the curve of the user's hardware key in BBS#
(`kvac/bbs_sharp/`; ECDSA below).  Tom-256 is the curve whose scalar
field is secp256r1's base field (reference `tom256.rs`), which lets a
Pedersen commitment hold P-256 point coordinates.  Both are parameter
instances of the host field and curve classes; no device field is built
for them.
"""

from __future__ import annotations

from ..fields.host import Field
from .sw import Point, SWCurve

# ---------------------------------------------------------------------------
# secp256r1 (NIST P-256)
# ---------------------------------------------------------------------------

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551

secp256r1_Fq = Field("secp256r1.Fq", P256_P)
secp256r1_Fr = Field("secp256r1.Fr", P256_N, generator=7)

secp256r1 = SWCurve(
    "secp256r1", secp256r1_Fq,
    secp256r1_Fq(P256_P - 3),
    secp256r1_Fq(0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B),
    secp256r1_Fr,
    cofactor=1,
    generator_xy=(
        secp256r1_Fq(0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296),
        secp256r1_Fq(0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5),
    ),
)

# ---------------------------------------------------------------------------
# Tom-256 (reference `tom256.rs`): scalar field = secp256r1 base field
# ---------------------------------------------------------------------------

TOM_P = 115792089210356248762697446949407573530594504085698471288169790229257723883799
TOM_N = 115792089210356248762697446949407573530086143415290314195533631308867097853951
assert TOM_N == P256_P  # Tom-256's scalar field IS secp256r1's base field

tom256_Fq = Field("tom256.Fq", TOM_P, generator=6)
tom256_Fr = Field("tom256.Fr", TOM_N, generator=6)

tom256 = SWCurve(
    "tom256", tom256_Fq,
    tom256_Fq(TOM_P - 3),
    tom256_Fq(81531206846337786915455327229510804132577517753388365729879493166393691077718),
    tom256_Fr,
    cofactor=1,
    generator_xy=(
        tom256_Fq(3),
        tom256_Fq(40902200210088653215032584946694356296222563095503428277299570638400093548589),
    ),
)


# ---------------------------------------------------------------------------
# ECDSA over secp256r1 (reference `kvac/src/bbs_sharp/ecdsa.rs`)
# ---------------------------------------------------------------------------

def ecdsa_sign(rng, message_hash: bytes, sk: int):
    """Standard ECDSA; returns (r, s) ints."""
    n = P256_N
    z = int.from_bytes(message_hash[:32], "big") % n
    while True:
        k = 1 + rng.randrange(n - 1)
        R = secp256r1.generator().mul_raw(k)
        rx, _ = R.to_affine()
        r = int(rx) % n
        if r == 0:
            continue
        s = pow(k, -1, n) * (z + r * sk) % n
        if s != 0:
            return r, s


def ecdsa_verify(message_hash: bytes, sig, pk: Point) -> bool:
    n = P256_N
    r, s = sig
    if not (1 <= r < n and 1 <= s < n):
        return False
    z = int.from_bytes(message_hash[:32], "big") % n
    w = pow(s, -1, n)
    u1 = z * w % n
    u2 = r * w % n
    R = secp256r1.generator().mul_raw(u1) + pk.mul_raw(u2)
    if R.is_infinity():
        return False
    rx, _ = R.to_affine()
    return int(rx) % n == r


def ecdsa_keygen(rng):
    sk = 1 + rng.randrange(P256_N - 1)
    return sk, secp256r1.generator().mul_raw(sk).normalize()
