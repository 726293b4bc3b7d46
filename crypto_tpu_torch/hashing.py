"""Hash-to-field and hash-to-group by try-and-increment.

The port's own copy of `crypto_tpu/hashing.py` (reference
`utils/src/hashing_utils.rs`, `utils/src/misc.rs:75-110`):

* `field_elem_from_try_and_incr`: digest the input, interpret the digest as
  a little-endian integer with wide modular reduction (arkworks
  `from_random_bytes` semantics for digests longer than the modulus).
* `group_elem_from_try_and_incr`: digest -> candidate x (+ y-sign flag from
  the top bit of the last digest byte), retry with
  `msg || b"-attempt-" || LE64(j)` until on-curve, clear the cofactor.
* `compute_random_oracle_challenge`: a Fiat-Shamir challenge from the
  contribution bytes (`schnorr_pok/src/pok_generalized_pedersen.rs:218`).
* `n_group_elements`: the counter-based generators of every signature's
  params (`utils/src/misc.rs:88-110`); `hash_to_field_many`.

Default digest is Blake2b-512 like the reference.  Host Python ints only.
"""

from __future__ import annotations

import hashlib
from typing import Callable

from .curves.sw import Point, SWCurve
from .fields.host import Field, Fp

DigestFn = Callable[[bytes], bytes]


def blake2b512(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64).digest()


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def shake256(data: bytes, n: int) -> bytes:
    return hashlib.shake_256(data).digest(n)


def concat_slices(*parts: bytes) -> bytes:
    return b"".join(parts)


# ---------------------------------------------------------------------------
# from_random_bytes semantics (arkworks)
# ---------------------------------------------------------------------------

def field_from_random_bytes_wide(F: Field, data: bytes,
                                 flag_bits: int = 0) -> tuple[Fp, int]:
    """Interpret `data` as a little-endian integer (with `flag_bits` top bits
    of the final byte extracted as flags and masked off), reduced mod p.
    Returns (element, flags)."""
    buf = bytearray(data)
    flags = 0
    if flag_bits:
        mask = ((1 << flag_bits) - 1) << (8 - flag_bits)
        flags = buf[-1] & mask
        buf[-1] &= ~mask & 0xFF
    v = int.from_bytes(bytes(buf), "little") % F.p
    return Fp(v, F), flags


def field_elem_from_try_and_incr(F: Field, data: bytes,
                                 digest: DigestFn = blake2b512) -> Fp:
    h = digest(data)
    elem, _ = field_from_random_bytes_wide(F, h)
    return elem


def compute_random_oracle_challenge(F: Field, challenge_bytes: bytes,
                                    digest: DigestFn = blake2b512) -> Fp:
    return field_elem_from_try_and_incr(F, challenge_bytes, digest)


# ---------------------------------------------------------------------------
# hash to group (try-and-increment)
# ---------------------------------------------------------------------------

def _x_candidate_from_bytes(curve: SWCurve, h: bytes):
    """Candidate x coordinate + y-sign from digest bytes.  For Fq2-coefficient
    curves the digest is split per coefficient like arkworks' composite
    deserialization (c0 from the first half, c1+flags from the second)."""
    K = curve.K
    if isinstance(K, Field):
        x, flags = field_from_random_bytes_wide(K, h, flag_bits=2)
        return x, flags
    # QuadExtField: split digest into two halves
    half = len(h) // 2
    c0, _ = field_from_random_bytes_wide(K.base, h[:half])
    c1, flags = field_from_random_bytes_wide(K.base, h[half:], flag_bits=2)
    return K(c0, c1), flags


def group_elem_from_try_and_incr(curve: SWCurve, data: bytes,
                                 digest: DigestFn = blake2b512) -> Point:
    """Hash to a point of the prime-order subgroup (cofactor cleared).
    Timing-variable; for public inputs only (parameter generation), exactly
    like the reference (`utils/src/hashing_utils.rs:19-37`)."""
    h = digest(data)
    j = 1
    while True:
        x, flags = _x_candidate_from_bytes(curve, h)
        ys = curve.y_from_x(x)
        if ys is not None:
            want_neg = bool(flags & (1 << 7))
            y = next(c for c in ys if c.is_gt_half() == want_neg)
            p = Point(x, y, curve.K.one(), curve)
            return p.mul_raw(curve.cofactor)
        h = digest(concat_slices(data, b"-attempt-", j.to_bytes(8, "little")))
        j += 1


def n_group_elements(curve: SWCurve, start: int, end: int, label: bytes,
                     digest: DigestFn = blake2b512) -> list[Point]:
    """Points hashed from `label || LE32(counter)` for counter in [start,end).
    Matches `n_affine_group_elements` (`utils/src/misc.rs:102-110`)."""
    return [
        group_elem_from_try_and_incr(
            curve, concat_slices(label, i.to_bytes(4, "little")), digest)
        for i in range(start, end)
    ]


def hash_to_field_many(F: Field, dst_unused: bytes, seed: bytes, count: int,
                       digest: DigestFn = blake2b512) -> list[Fp]:
    """Prefix-stable many-element hash-to-field: element i derived from
    `seed || LE32(i)` (`utils/src/hashing_utils.rs:63-73` shape, with the
    try-and-increment map rather than the HKDF expander)."""
    return [
        field_elem_from_try_and_incr(
            F, concat_slices(seed, i.to_bytes(4, "little")), digest)
        for i in range(count)
    ]
