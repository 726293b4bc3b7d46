"""Application-level Fiat-Shamir transcript (reference `utils/src/transcript.rs`):
the port's own copy of `crypto_tpu/transcript/transcript.py`.

Wraps the merlin STROBE transcript with field/group challenge derivation:
`challenge_scalar` squeezes 64 bytes, wide-reduces (uniform) and retries until
the scalar is invertible, exactly like the reference (`transcript.rs:101-140`).
"""

from __future__ import annotations

from ..fields.host import Field, Fp
from ..curves.sw import SWCurve, Point
from ..serialize import serialize_point, serialize_usize
from ..hashing import field_from_random_bytes_wide, _x_candidate_from_bytes
from .merlin import MerlinTranscript


class Transcript:
    __slots__ = ("merlin",)

    def __init__(self, label: bytes):
        self.merlin = MerlinTranscript(label)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.merlin = self.merlin.clone()
        return t

    def replace_with(self, other: "Transcript") -> None:
        """Adopt `other`'s state — the abort-and-retry idiom: mutate a clone,
        commit it back only on success (eq_across_groups rejection
        sampling)."""
        self.merlin = other.merlin

    # -- appends --

    def append_message(self, label: bytes, data: bytes) -> None:
        self.merlin.append_message(label, data)

    def append(self, label: bytes, element) -> None:
        """Append a canonically-serialized element (point / field / bytes /
        object with serialize_compressed)."""
        self.merlin.append_message(label, _to_bytes(element))

    # -- challenges --

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        return self.merlin.challenge_bytes(label, n)

    def challenge_scalar(self, F: Field, label: bytes) -> Fp:
        buf = bytearray(self.merlin.challenge_bytes(label, 64))
        counter = 0
        while True:
            c, _ = field_from_random_bytes_wide(F, bytes(buf))
            if not c.is_zero():
                return c
            buf[0] = counter
            counter += 1
            buf = bytearray(self.merlin.challenge_bytes(label, 64))

    def challenge_scalars(self, F: Field, label: bytes, count: int) -> list:
        buf = bytearray(self.merlin.challenge_bytes(label, 64 * count))
        out = []
        for i in range(count):
            chunk = bytearray(buf[i * 64:(i + 1) * 64])
            counter = 0
            while True:
                c, _ = field_from_random_bytes_wide(F, bytes(chunk))
                if not c.is_zero():
                    out.append(c)
                    break
                chunk[0] = counter
                counter += 1
                chunk = bytearray(self.merlin.challenge_bytes(label, 64))
        return out

    def challenge_group_elem(self, curve: SWCurve, label: bytes) -> Point:
        buf = bytearray(self.merlin.challenge_bytes(label, 64))
        counter = 0
        while True:
            x, flags = _x_candidate_from_bytes(curve, bytes(buf))
            ys = curve.y_from_x(x)
            if ys is not None:
                want_neg = bool(flags & (1 << 7))
                y = next(c for c in ys if c.is_gt_half() == want_neg)
                p = Point(x, y, curve.K.one(), curve)
                return p.mul_raw(curve.cofactor)
            buf[0] = counter
            counter += 1
            buf = bytearray(self.merlin.challenge_bytes(label, 64))


def _to_bytes(element) -> bytes:
    if isinstance(element, bytes):
        return element
    if isinstance(element, Point):
        return serialize_point(element)
    if hasattr(element, "to_bytes_le"):
        return element.to_bytes_le()
    if hasattr(element, "serialize_compressed"):
        return element.serialize_compressed()
    if isinstance(element, (list, tuple)):
        return serialize_usize(len(element)) + b"".join(_to_bytes(e) for e in element)
    if isinstance(element, int):
        return element.to_bytes(4, "little")
    raise TypeError(f"cannot serialize {type(element)} for transcript")


def new_merlin_transcript(label: bytes) -> Transcript:
    return Transcript(label)
