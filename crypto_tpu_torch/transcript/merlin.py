"""Merlin transcripts over STROBE-128: the port's own copy of
`crypto_tpu/transcript/merlin.py`.

Bit-compatible with the merlin crate (and the reference's "dock_merlin" fork,
whose only addition is non-static labels — in Python all labels are plain
bytes, so the *_with_non_static_label variants coincide with the base ones;
see reference `merlin/src/transcript.rs:184-190`).
"""

import os

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class MerlinTranscript:
    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "MerlinTranscript":
        t = MerlinTranscript.__new__(MerlinTranscript)
        t.strobe = self.strobe.clone()
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())


class TranscriptRngBuilder:
    """merlin::TranscriptRngBuilder — an RNG bound to the transcript state
    plus witness data plus external entropy."""

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, entropy: bytes | None = None) -> "TranscriptRng":
        if entropy is None:
            entropy = os.urandom(32)
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def random_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_u32le(n), False)
        return self.strobe.prf(n, False)

    # random.Random-compatible subset
    def randrange(self, bound: int) -> int:
        nbytes = (bound.bit_length() + 128) // 8
        return int.from_bytes(self.random_bytes(nbytes), "little") % bound
