"""BBS+ signatures: the port's own copy of `crypto_tpu/bbs_plus/signature.py`
(reference `bbs_plus/src/signature.rs`).

Signature (A, e, s) on messages (m_1..m_n):
  b = g1 + h_0*s + sum h_i*m_i ;  A = b * 1/(e+x)
Verification: e(A, pk + g2*e) == e(b, g2), checked as the pairing-product
`e(A, pk) * e(A*e - b, g2) == 1` (`signature.rs:272-295`).

Blind signing (`new_with_committed_messages`, `signature.rs:172-214`): the
requester commits to hidden messages as `commitment = h_0*blinding +
sum h_i*m_i`; the signer covers the uncommitted rest; `unblind` adds the
blinding into `s`.

`verify` runs the host 2-pairing, as the reference does;
`verify_with_pairing_checker` defers its two pairs into a
`utils.checkers.RandomizedPairingChecker`, whose lazy Miller product runs
on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from .setup import PublicKeyG2, SecretKey, SignatureParamsG1


class BBSPlusError(Exception):
    pass


@dataclass
class SignatureG1:
    A: Point
    e: Fp
    s: Fp

    @classmethod
    def new(cls, rng, messages, sk: SecretKey,
            params: SignatureParamsG1) -> "SignatureG1":
        if not messages:
            raise BBSPlusError("no messages to sign")
        if len(messages) != params.supported_message_count:
            raise BBSPlusError("message count incompatible with params")
        return cls.new_with_committed_messages(
            rng, bls.G1.infinity(), dict(enumerate(messages)), sk, params)

    @classmethod
    def new_with_committed_messages(
            cls, rng, commitment: Point, uncommitted_messages: dict,
            sk: SecretKey, params: SignatureParamsG1) -> "SignatureG1":
        if not uncommitted_messages:
            raise BBSPlusError("no messages to sign")
        if len(uncommitted_messages) > params.supported_message_count:
            raise BBSPlusError("message count incompatible with params")
        s = bls.Fr.rand(rng)
        b = params.b(sorted(uncommitted_messages.items()), s)
        e = bls.Fr.rand(rng)
        while (e + sk.x).is_zero():
            e = bls.Fr.rand(rng)
        A = (b + commitment) * int((e + sk.x).inverse())
        return cls(A=A.normalize(), e=e, s=s)

    def unblind(self, blinding: Fp) -> "SignatureG1":
        return SignatureG1(A=self.A, e=self.e, s=self.s + blinding)

    def is_non_zero(self) -> bool:
        return not self.A.is_infinity()

    def _pre_verify(self, messages, params: SignatureParamsG1) -> Point:
        if not messages:
            raise BBSPlusError("no messages")
        if len(messages) != params.supported_message_count:
            raise BBSPlusError("message count incompatible with params")
        if not self.is_non_zero():
            raise BBSPlusError("zero signature")
        return params.b(list(enumerate(messages)), self.s)

    def verify(self, messages, pk: PublicKeyG2,
               params: SignatureParamsG1) -> bool:
        b = self._pre_verify(messages, params)
        Aeb = self.A * int(self.e) - b
        out = bls.multi_pairing([(self.A, pk.w), (Aeb, params.g2)])
        return out.is_one()

    def verify_with_pairing_checker(self, messages, pk: PublicKeyG2,
                                    params: SignatureParamsG1,
                                    checker) -> None:
        """Accumulate the pairing check into a RandomizedPairingChecker."""
        b = self._pre_verify(messages, params)
        Aeb = self.A * int(self.e) - b
        checker.add_multiple_sources_and_target(
            [self.A, Aeb.normalize()], [pk.w, params.g2], bls.Fq12.one())
