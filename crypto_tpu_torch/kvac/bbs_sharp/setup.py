"""BBS# setup: MAC parameters over a pairing-free group (canonically
secp256r1 — the curve in the user's secure hardware), signer/user keys and
the designated-verifier PoK (reference `kvac/src/bbs_sharp/setup.rs`).

The designated-verifier proof is a SIMULATED Schnorr proof of the
verifier's secret key: (c, s) random, t = g*s - pk*c.  OR-composed with the
real proof (challenge split c_total - c_dv), it makes the combined proof
deniable: the verifier could have forged it (`setup.rs:191-221`).

The port's own copy of `crypto_tpu/kvac/bbs_sharp/setup.py`; host
code (no device field is built for secp256r1)."""

from __future__ import annotations

from dataclasses import dataclass

from ...curves.extra_curves import secp256r1
from ...curves.sw import Point, SWCurve
from ...fields.host import Fp
from ...hashing import (blake2b512, concat_slices,
                        group_elem_from_try_and_incr, n_group_elements)
from ...utils.msm import msm
from ..bbdt16 import KVACError


@dataclass
class MACParams:
    """(g_0, g_tilde, g, g_1..g_n): g for user keys, g_tilde for signer
    keys, g_0 the constant term, g_i per message."""
    g_0: Point
    g_tilde: Point
    g: Point
    g_vec: list

    @classmethod
    def new(cls, label: bytes, message_count: int,
            curve: SWCurve = None, digest=blake2b512) -> "MACParams":
        assert message_count > 0
        curve = curve or secp256r1
        g_0 = group_elem_from_try_and_incr(
            curve, concat_slices(label, b" : g_0"), digest).normalize()
        g = group_elem_from_try_and_incr(
            curve, concat_slices(label, b" : g"), digest).normalize()
        g_tilde = group_elem_from_try_and_incr(
            curve, concat_slices(label, b" : g_tilde"), digest).normalize()
        g_vec = [p.normalize() for p in n_group_elements(
            curve, 1, message_count + 1, concat_slices(label, b" : g_"),
            digest)]
        return cls(g_0=g_0, g_tilde=g_tilde, g=g, g_vec=g_vec)

    @property
    def supported_message_count(self) -> int:
        return len(self.g_vec)

    @property
    def scalar_field(self):
        return self.g.curve.scalar_field

    def commit_to_messages(self, indexed_messages) -> Point:
        bases, scalars = [], []
        last = -1
        for i, m in indexed_messages:
            if i <= last or i >= len(self.g_vec):
                raise KVACError("message indices must be sorted and valid")
            last = i
            bases.append(self.g_vec[i])
            scalars.append(m)
        return msm(bases, scalars).normalize()

    def b(self, indexed_messages, user_public_key: "UserPublicKey") -> Point:
        """B = g_0 + upk + sum g_i * m_i (`setup.rs` `b`)."""
        return (self.commit_to_messages(indexed_messages) + self.g_0
                + user_public_key.point).normalize()


@dataclass
class SecretKey:
    x: Fp

    @classmethod
    def new(cls, rng, field) -> "SecretKey":
        return cls(x=field.rand(rng))


@dataclass
class UserPublicKey:
    point: Point

    @classmethod
    def new(cls, sk: SecretKey, g: Point) -> "UserPublicKey":
        return cls(point=(g * int(sk.x)).normalize())

    @classmethod
    def new_from_params(cls, sk: SecretKey, params: MACParams):
        return cls.new(sk, params.g)

    def get_blinded_for_schnorr_sig(self, blinding: Fp,
                                    g: Point) -> "UserPublicKey":
        """pk + g*blinding."""
        return UserPublicKey(point=(g * int(blinding)
                                    + self.point).normalize())

    def get_blinded_for_ecdsa(self, blinding: Fp) -> "UserPublicKey":
        """pk * blinding."""
        return UserPublicKey(point=(self.point * int(blinding)).normalize())


@dataclass
class SignerPublicKey:
    point: Point

    @classmethod
    def new(cls, sk: SecretKey, g_tilde: Point) -> "SignerPublicKey":
        return cls(point=(g_tilde * int(sk.x)).normalize())

    @classmethod
    def new_from_params(cls, sk: SecretKey, params: MACParams):
        return cls.new(sk, params.g_tilde)


@dataclass
class DesignatedVerifierPoKOfPublicKey:
    t: Point
    challenge: Fp
    response: Fp

    @classmethod
    def new(cls, rng, public_key: Point, g: Point):
        F = g.curve.scalar_field
        challenge = F.rand(rng)
        response = F.rand(rng)
        t = (g * int(response) - public_key * int(challenge)).normalize()
        return cls(t=t, challenge=challenge, response=response)

    def verify(self, public_key: Point, g: Point) -> bool:
        return (g * int(self.response)
                - public_key * int(self.challenge)).normalize() == self.t
