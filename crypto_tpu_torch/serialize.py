"""arkworks-compatible canonical serialization: the port's own copy of
`crypto_tpu/serialize.py`.

Byte layouts follow ark-serialize (which every proof and params struct of
the reference derives):

* prime-field element: little-endian, fixed width = ceil(modulus_bits/8)
* quadratic extension: c0 || c1
* short-Weierstrass point, compressed: x bytes with 2 flag bits in the TOP
  bits of the LAST byte: bit7 = y-is-negative (y > -y), bit6 = infinity
* short-Weierstrass point, uncompressed: x || y with flags in last byte of y
* Vec<T>: u64 little-endian length prefix, then elements

"Negative" y follows arkworks' `SWFlags::from_y_coordinate`: y is negative
iff y > -y in the canonical integer ordering (for Fq2: compare (c1, c0)
lexicographically).  Host code only.
"""

from __future__ import annotations

from .curves.sw import Point, SWCurve
from .fields.host import Field, Fp
from .fields.tower import Fp2, QuadExtField

FLAG_INF = 1 << 6
FLAG_Y_NEG = 1 << 7


# ---------------------------------------------------------------------------
# field elements
# ---------------------------------------------------------------------------

def serialize_field(x) -> bytes:
    return x.to_bytes_le()


def deserialize_field(F: Field, data: bytes) -> Fp:
    if len(data) != F.nbytes:
        raise ValueError("bad field element length")
    return F.from_bytes_le(data)


def deserialize_fp2(F2: QuadExtField, data: bytes) -> Fp2:
    return F2.from_bytes_le(data[:2 * F2.base.nbytes])


def _coeff_nbytes(K) -> int:
    """Serialized size of one coefficient-field element (Fq or Fq2)."""
    if isinstance(K, Field):
        return K.nbytes
    return K.base.nbytes * 2  # QuadExtField


def _deserialize_coeff(K, data: bytes):
    if isinstance(K, Field):
        return deserialize_field(K, data)
    return deserialize_fp2(K, data)


# ---------------------------------------------------------------------------
# curve points
# ---------------------------------------------------------------------------

def serialize_point(p: Point, compressed: bool = True) -> bytes:
    nb = _coeff_nbytes(p.curve.K)
    if p.is_infinity():
        out = bytearray(nb if compressed else 2 * nb)
        out[-1] |= FLAG_INF
        return bytes(out)
    x, y = p.to_affine()
    out = bytearray(x.to_bytes_le() if compressed
                    else x.to_bytes_le() + y.to_bytes_le())
    # arkworks writes the YIsNegative flag in the uncompressed form too
    if y.is_gt_half():
        out[-1] |= FLAG_Y_NEG
    return bytes(out)


def deserialize_point(curve: SWCurve, data: bytes, compressed: bool = True,
                      check_subgroup: bool = True) -> Point:
    nb = _coeff_nbytes(curve.K)
    expected = nb if compressed else 2 * nb
    if len(data) != expected:
        raise ValueError("bad point length")
    buf = bytearray(data)
    flags = buf[-1] & 0xC0
    buf[-1] &= 0x3F
    if flags & FLAG_INF:
        if any(buf):
            raise ValueError("infinity with nonzero payload")
        return curve.infinity()
    if compressed:
        x = _deserialize_coeff(curve.K, bytes(buf))
        ys = curve.y_from_x(x)
        if ys is None:
            raise ValueError("x not on curve")
        y = next(c for c in ys if c.is_gt_half() == bool(flags & FLAG_Y_NEG))
        p = Point(x, y, curve.K.one(), curve)
    else:
        x = _deserialize_coeff(curve.K, bytes(buf[:nb]))
        y = _deserialize_coeff(curve.K, bytes(buf[nb:]))
        p = Point(x, y, curve.K.one(), curve)
        if not p.is_on_curve():
            raise ValueError("point not on curve")
    # mul_raw: Point.__mul__ reduces the scalar mod the group order, which
    # would make this check vacuous
    if check_subgroup and not p.mul_raw(curve.scalar_field.p).is_infinity():
        raise ValueError("point not in prime-order subgroup")
    return p


def point_nbytes(curve: SWCurve, compressed: bool = True) -> int:
    nb = _coeff_nbytes(curve.K)
    return nb if compressed else 2 * nb


# ---------------------------------------------------------------------------
# composite helpers
# ---------------------------------------------------------------------------

def serialize_usize(n: int) -> bytes:
    """arkworks serializes lengths as u64 little-endian."""
    return n.to_bytes(8, "little")


def serialize_vec(items, ser=lambda x: x) -> bytes:
    out = serialize_usize(len(items))
    for it in items:
        out += ser(it)
    return out


class ByteWriter:
    """Accumulates challenge-contribution bytes (the `Write` sink idiom the
    reference uses for `challenge_contribution`)."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data

    def point(self, p: Point):
        self.buf += serialize_point(p)

    def field(self, x):
        self.buf += x.to_bytes_le()

    def points(self, ps):
        for p in ps:
            self.point(p)

    def fields(self, xs):
        for x in xs:
            self.field(x)

    def raw_vec_points(self, ps):
        self.buf += serialize_usize(len(ps))
        self.points(ps)

    def bytes(self) -> bytes:
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# parameter persistence: named lists of points as canonical compressed
# bytes inside an npz container
# ---------------------------------------------------------------------------

def save_points(path: str, **named_point_lists) -> None:
    """Persist named lists of points (SRS powers, commitment keys,
    accumulator values...) with canonical compressed encoding."""
    import numpy as np
    arrays = {}
    for name, pts in named_point_lists.items():
        if isinstance(pts, Point):
            pts = [pts]
        blobs = [serialize_point(p) for p in pts]
        arrays[name] = np.frombuffer(b"".join(blobs), dtype=np.uint8)
        arrays[name + "__len"] = np.array([len(blobs[0]) if blobs else 0,
                                           len(blobs)])
    np.savez_compressed(path, **arrays)


def load_points(path: str, curve_by_name: dict) -> dict:
    """Inverse of save_points; curve_by_name maps each saved name to its
    SWCurve for deserialization."""
    import numpy as np
    out = {}
    with np.load(path) as data:
        for name, curve in curve_by_name.items():
            per, count = (int(x) for x in data[name + "__len"])
            raw = data[name].tobytes()
            out[name] = [deserialize_point(curve, raw[i * per:(i + 1) * per])
                         for i in range(count)]
    return out
