"""BBS# MAC: a weak-BB style MAC A = B * 1/(e+x) over a pairing-free group
with the user's public key folded into B, plus the issuer's proof of
validity (two discrete-log proofs with a SHARED response, optionally
OR-composed with a designated-verifier simulation)
(reference `kvac/src/bbs_sharp/mac.rs`).

The port's own copy of `crypto_tpu/kvac/bbs_sharp/mac.py`; host
code (no device field is built for secp256r1)."""

from __future__ import annotations

from dataclasses import dataclass

from ...curves.sw import Point
from ...fields.host import Fp
from ...hashing import blake2b512, compute_random_oracle_challenge
from ...schnorr.discrete_log import PokDiscreteLog, PokDiscreteLogProtocol
from ...serialize import ByteWriter
from ..bbdt16 import KVACError
from .setup import (DesignatedVerifierPoKOfPublicKey, MACParams, SecretKey,
                    SignerPublicKey, UserPublicKey)


@dataclass
class MAC:
    A: Point
    e: Fp

    @classmethod
    def new(cls, rng, messages, user_public_key: UserPublicKey,
            signer_secret_key: SecretKey, params: MACParams) -> "MAC":
        if not messages:
            raise KVACError("no messages")
        if len(messages) != params.supported_message_count:
            raise KVACError("message count mismatch")
        F = params.scalar_field
        e = F.rand(rng)
        while (e + signer_secret_key.x).is_zero():
            e = F.rand(rng)
        B = params.b(list(enumerate(messages)), user_public_key)
        A = (B * int((e + signer_secret_key.x).inverse())).normalize()
        return cls(A=A, e=e)

    def verify(self, messages, user_public_key: UserPublicKey,
               sk: SecretKey, params: MACParams) -> bool:
        if len(messages) != params.supported_message_count:
            return False
        B = params.b(list(enumerate(messages)), user_public_key)
        inv = (self.e + sk.x)
        if inv.is_zero():
            return False
        return (B * int(inv.inverse())).normalize() == self.A


@dataclass
class ProofOfValidityOfMAC:
    """Proves B = A*x and signer_pk = g_tilde*x with one shared response
    (`mac.rs:103-175`)."""
    sc_B: PokDiscreteLog
    sc_pk: PokDiscreteLog
    designated_verifier_pk_proof: object = None

    @classmethod
    def new(cls, rng, mac: MAC, secret_key: SecretKey,
            public_key: SignerPublicKey, params: MACParams,
            user_public_key: UserPublicKey = None,
            digest=blake2b512) -> "ProofOfValidityOfMAC":
        F = params.scalar_field
        witness = secret_key.x
        blinding = F.rand(rng)
        B = (mac.A * int(witness)).normalize()
        p1 = PokDiscreteLogProtocol.init(witness, blinding, mac.A)
        p2 = PokDiscreteLogProtocol.init(witness, blinding, params.g_tilde)
        w = ByteWriter()
        p1.challenge_contribution(mac.A, B, w)
        p2.challenge_contribution(params.g_tilde, public_key.point, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        dvp = None
        if user_public_key is not None:
            dvp = DesignatedVerifierPoKOfPublicKey.new(
                rng, user_public_key.point, params.g)
            challenge = challenge - dvp.challenge
        return cls(sc_B=p1.gen_proof(challenge), sc_pk=p2.gen_proof(challenge),
                   designated_verifier_pk_proof=dvp)

    def verify(self, mac: MAC, messages, user_public_key: UserPublicKey,
               signer_public_key: SignerPublicKey, params: MACParams,
               digest=blake2b512) -> bool:
        if self.sc_B.response != self.sc_pk.response:
            return False
        F = params.scalar_field
        B = (params.b(list(enumerate(messages)), user_public_key)
             - mac.A * int(mac.e)).normalize()
        w = ByteWriter()
        self.sc_B.challenge_contribution(mac.A, B, w)
        self.sc_pk.challenge_contribution(params.g_tilde,
                                          signer_public_key.point, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        if self.designated_verifier_pk_proof is not None:
            if not self.designated_verifier_pk_proof.verify(
                    user_public_key.point, params.g):
                return False
            challenge = challenge - self.designated_verifier_pk_proof.challenge
        if not self.sc_B.verify(B, mac.A, challenge):
            return False
        return self.sc_pk.verify(signer_public_key.point, params.g_tilde,
                                 challenge)
