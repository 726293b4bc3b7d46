"""RFC 9380 hash-to-curve for BLS12-381 G1 (ciphersuites
BLS12381G1_XMD:SHA-256_SSWU_RO_ and BLS12381G1_XOF:SHAKE-256_SSWU_RO_):
the port's own copy of `crypto_tpu/hashing_rfc9380.py`, the hashing of
the IETF BBS ciphersuites (`bbs_plus/ietf.py`).

`expand_message_xmd`/`xof`, `hash_to_field_fq`, the simplified SWU map
onto the 11-isogenous curve E' and the isogeny back to E: y^2 = x^3 + 4,
then cofactor clearing.  The isogeny is evaluated by Velu's sums over the
five +/- pairs of the rational order-11 kernel of E' (the kernel's
x-coordinates and the isomorphism's scalings u^2, u^3 are the embedded
constants), not by the RFC's 15x16-coefficient rational maps.  The RFC's
own vectors (K.1, J.9.1) hold it in `tests/test_torch_rfc9380.py`.
Host Python ints only: hashing is short and sequential.
"""

from __future__ import annotations

import hashlib

P = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab

# SSWU target curve E': y^2 = x^3 + A*x + B (RFC 9380 §8.8.1), 11-isogenous
# to E: y^2 = x^3 + 4
ISO_A = 0x00144698a3b8e9433d693a02c96d4982b0ea985383ee66a8d8e8981aefd881ac98936f8da0e0f97f5cf428082d584c1d
ISO_B = 0x12e2908d11688030018b12e8753eee3b2016c1f0f24f4070a0b9c14fcef35ef55a23215a316ceaa5d1cc48e98e172be0
SSWU_Z = 11
H_EFF = 0xd201000000010001     # effective G1 cofactor (RFC 9380 §8.8.1)

# Velu kernel: x-coordinates of the 5 +/- pairs of the rational order-11
# subgroup of E' (derived once; see module docstring)
_KERNEL_XS = (
    0x140d41735b10ce710727cd9356905701a2b866b803baa468948b7f423ddcc560c9a8f1cd5f8ed4297c37464fb8bfe4a7,
    0x0d7f2d0d03ae035321eed4c1479d13251abf0e9a96479623eb5380b575e319851fb5e5a8b43b9c1a46880f54bf2b2f7c,
    0x1665a9c648e78314490a94f654d9b1039ab85847223bfaed9aa54f0f07736d122d1ceca1ac0e9123e753fde16e97c3d7,
    0x010ef325dd1e98bdf0d97a4c6b7f968ed7f31f2fbff088acb39d5319cfc261ea18773405f325612742f0c5d90634bcf4,
    0x105249b4cac630ce5aa18e6c1189a18c82019b4e12e491fbac012c259ca3a67f638560b8bb416af02a4724385ed0fc8e,
)
# isomorphism (Velu image, j=0) -> E: (x, y) |-> (u^2 x, u^3 y)
_ISO_U2 = 0x06e08c248e260e70bd1e962381edee3d31d79d7e22c837bc23c0bf1bc24c6b68c24b1b80b64d391fa9c8ba2e8ba2d229
_ISO_U3 = 0x15e6be4e990f03ce4ea50b3b42df2eb5cb181d8f84965a3957add4fa95af01b2b665027efec01c7704b456be69c8b604

# Velu per-pair constants t_i = 2(3x_i^2 + A), u_i = 4(x_i^3 + A x_i + B)
_KERNEL_TU = tuple(
    ((2 * (3 * x * x + ISO_A)) % P,
     (4 * (x * x * x + ISO_A * x + ISO_B)) % P)
    for x in _KERNEL_XS)


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


def _sqrt(a: int):
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    return pow(a, (P + 1) // 4, P)       # p = 3 mod 4


# ---------------------------------------------------------------------------
# expand_message_xmd (RFC 9380 §5.3.1)
# ---------------------------------------------------------------------------

def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int,
                       hash_fn=hashlib.sha256) -> bytes:
    h = hash_fn()
    b_in_bytes = h.digest_size
    s_in_bytes = h.block_size
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd: parameters out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * s_in_bytes
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hash_fn(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    out = [hash_fn(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bytes(x ^ y for x, y in zip(b0, out[-1]))
        out.append(hash_fn(prev + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


def expand_message_xof(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.2 with SHAKE-256 (suite BLS12381G1_XOF:SHAKE-256)."""
    if len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xof: parameters out of range")
    return hashlib.shake_256(
        msg + len_in_bytes.to_bytes(2, "big") + dst
        + bytes([len(dst)])).digest(len_in_bytes)


def hash_to_field_fq(msg: bytes, dst: bytes, count: int,
                     L: int = 64, expander=expand_message_xmd) -> list[int]:
    """RFC 9380 §5.2 hash_to_field for GF(p), m=1."""
    ub = expander(msg, dst, count * L)
    return [int.from_bytes(ub[i * L:(i + 1) * L], "big") % P
            for i in range(count)]


# ---------------------------------------------------------------------------
# Simplified SWU map to E' + Velu isogeny evaluation (RFC 9380 §6.6.2-6.6.3)
# ---------------------------------------------------------------------------

def _sswu_ep(u: int):
    """map_to_curve_simple_swu onto E' (non-constant-time; hashing inputs
    are public)."""
    A, B, Z = ISO_A, ISO_B, SSWU_Z
    tv1 = (Z * Z * pow(u, 4, P) + Z * u * u) % P
    if tv1 == 0:
        x1 = B * _inv(Z * A) % P
    else:
        x1 = (-B * _inv(A)) % P * (1 + _inv(tv1)) % P
    gx1 = (pow(x1, 3, P) + A * x1 + B) % P
    y = _sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = Z * u * u % P * x1 % P
        gx2 = (pow(x, 3, P) + A * x + B) % P
        y = _sqrt(gx2)
    if (u & 1) != (y & 1):          # sgn0 correction
        y = P - y
    return x, y


def _iso_map(pt):
    """Velu evaluation of the 11-isogeny E' -> E'' composed with the
    isomorphism E'' -> E (y^2 = x^3 + 4)."""
    x, y = pt
    X = x
    S = 0
    for xi, (ti, ui) in zip(_KERNEL_XS, _KERNEL_TU):
        d = _inv((x - xi) % P)
        d2 = d * d % P
        X = (X + ti * d + ui * d2) % P
        S = (S + ti * d2 + 2 * ui * d2 * d) % P
    Y = y * (1 - S) % P
    return (_ISO_U2 * X % P, _ISO_U3 * Y % P)


def _g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 % P * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _g1_mul(k: int, pt):
    acc = None
    q = pt
    while k:
        if k & 1:
            acc = _g1_add(acc, q)
        q = _g1_add(q, q)
        k >>= 1
    return acc


def hash_to_curve_g1(msg: bytes, dst: bytes, expander=expand_message_xmd):
    """Full hash_to_curve (random-oracle suite): returns affine (x, y) ints
    on E: y^2 = x^3 + 4, in the r-torsion.  expander selects the suite:
    `expand_message_xmd` (SHA-256) or `expand_message_xof` (SHAKE-256)."""
    u0, u1 = hash_to_field_fq(msg, dst, 2, expander=expander)
    q0 = _iso_map(_sswu_ep(u0))
    q1 = _iso_map(_sswu_ep(u1))
    return _g1_mul(H_EFF, _g1_add(q0, q1))


def hash_to_curve_g1_point(msg: bytes, dst: bytes):
    """Same, as a host G1 `Point`."""
    from .curves import bls12_381 as bls
    from .curves.sw import Point
    x, y = hash_to_curve_g1(msg, dst)
    return Point(bls.Fq(x), bls.Fq(y), bls.Fq(1), bls.G1)
