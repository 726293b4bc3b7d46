"""BBS# proof of knowledge of MAC (reference `kvac/src/bbs_sharp/proof.rs`).

BBS-style randomization: A_hat = A*(r1*r2), D = B*r2, B_bar = D*r1 -
A_hat*e, with two Schnorr legs:
  1. B_bar = A_hat*(-e) + D*r1                       (PokPedersenCommitment)
  2. 0 = sum g_i*m_i (hidden) + D*(-r3) + <pk leg>   (SchnorrCommitment)
The public-key leg binds the proof to the user's hardware key: for Schnorr
hardware sigs the base is params.g with witness -blinding_pk (blinded_pk =
pk + g*blinding); for ECDSA the base is blinded_pk (= pk*blinding) with
witness 1/blinding.  The verifier additionally checks a hardware signature
on the session against blinded_pk, which the user produced by transforming
the hardware's signature with the same blinding (footnote 31 of the paper,
modified per the module comments for composability).

Verification either uses the signer's secret key (B_bar == A_hat*x), a
keyed proof handed to the signer, or a HOL proof-of-validity token.

The port's own copy of `crypto_tpu/kvac/bbs_sharp/proof.py`; host
code (no device field is built for secp256r1)."""

from __future__ import annotations

from dataclasses import dataclass

from ...curves.extra_curves import secp256r1
from ...curves.sw import Point
from ...fields.host import Fp
from ...hashing import blake2b512
from ...schnorr.discrete_log import (PokPedersenCommitment,
                                     PokPedersenCommitmentProtocol)
from ...schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ...serialize import ByteWriter
from ...utils.msm import msm
from ..bbdt16 import KVACError
from .hol import ProofOfValidity, TokenPrivateData
from .mac import MAC
from .setup import (DesignatedVerifierPoKOfPublicKey, MACParams, SecretKey,
                    SignerPublicKey, UserPublicKey)

SCHNORR = "schnorr"
ECDSA = "ecdsa"


@dataclass
class KeyedProofBBSSharp:
    """(B_0, C) with C = B_0 * x — checkable only with the signer key
    (same shape as BBDT16's keyed proof)."""
    B_0: Point
    C: Point

    def verify(self, secret_key: SecretKey) -> bool:
        return (self.B_0 * int(secret_key.x)).normalize() == self.C


@dataclass
class PoKOfMACProtocol:
    A_hat: Point
    D: Point
    B_bar: Point
    blinded_pk: Point
    blinding_pk: Fp
    sc_B_bar: PokPedersenCommitmentProtocol
    sc_comm_msgs: SchnorrCommitment
    sc_wits_msgs: list
    hw_sig_type: str
    proof_of_validity: tuple = None
    designated_verifier_pk_proof: object = None

    @classmethod
    def init(cls, rng, mac: MAC, params: MACParams, messages_and_blindings,
             user_public_key: UserPublicKey, hw_sig_type: str = SCHNORR,
             verifier_pub_key: Point = None) -> "PoKOfMACProtocol":
        messages, indexed_blindings = cls._split(rng, messages_and_blindings,
                                                 params)
        F = params.scalar_field
        r1 = F.rand(rng)
        r2 = F.rand_nonzero(rng)
        r3 = r2.inverse()
        A_hat = (mac.A * int(r1 * r2)).normalize()
        B = params.b(list(enumerate(messages)), user_public_key)
        D = (B * int(r2)).normalize()
        minus_e = -mac.e
        B_bar = (D * int(r1) + A_hat * int(minus_e)).normalize()
        return cls._init(rng, A_hat, B_bar, D, r1, r3, minus_e, messages,
                         indexed_blindings, params, user_public_key,
                         hw_sig_type, None, verifier_pub_key)

    @classmethod
    def init_using_token(cls, rng, private_data: TokenPrivateData,
                         proof_of_validity: ProofOfValidity,
                         params: MACParams, messages_and_blindings,
                         user_public_key: UserPublicKey,
                         hw_sig_type: str = SCHNORR,
                         verifier_pub_key: Point = None):
        messages, indexed_blindings = cls._split(rng, messages_and_blindings,
                                                 params)
        return cls._init(
            rng, proof_of_validity.A_hat, proof_of_validity.B_bar,
            private_data.D, private_data.r1, private_data.r3,
            private_data.minus_e, messages, indexed_blindings, params,
            user_public_key, hw_sig_type,
            (proof_of_validity.c, proof_of_validity.r), verifier_pub_key)

    @staticmethod
    def _split(rng, messages_and_blindings, params: MACParams):
        if len(messages_and_blindings) != params.supported_message_count:
            raise KVACError("message count mismatch")
        F = params.scalar_field
        messages = [mb.message for mb in messages_and_blindings]
        indexed_blindings = [
            (i, mb.blinding if mb.blinding is not None else F.rand(rng))
            for i, mb in enumerate(messages_and_blindings) if not mb.reveal]
        return messages, indexed_blindings

    @classmethod
    def _init(cls, rng, A_hat, B_bar, D, r1, r3, minus_e, messages,
              indexed_blindings, params: MACParams,
              user_public_key: UserPublicKey, hw_sig_type,
              proof_of_validity, verifier_pub_key):
        F = params.scalar_field
        blinding_pk = F.rand_nonzero(rng)
        if hw_sig_type == SCHNORR:
            blinded = user_public_key.get_blinded_for_schnorr_sig(
                blinding_pk, params.g)
        elif hw_sig_type == ECDSA:
            blinded = user_public_key.get_blinded_for_ecdsa(blinding_pk)
        else:
            raise KVACError("unknown hardware signature type")

        sc_B_bar = PokPedersenCommitmentProtocol.init(
            minus_e, F.rand(rng), A_hat, r1, F.rand(rng), D)

        bases = [params.g_vec[i] for i, _ in indexed_blindings]
        randomness = [b for _, b in indexed_blindings]
        wits = [messages[i] for i, _ in indexed_blindings]
        bases.append(D)
        randomness.append(F.rand(rng))
        wits.append(-r3)
        if hw_sig_type == SCHNORR:
            bases.append(params.g)
            wits.append(-blinding_pk)
        else:
            bases.append(blinded.point)
            wits.append(blinding_pk.inverse())
        randomness.append(F.rand(rng))
        sc_comm_msgs = SchnorrCommitment.new(bases, randomness)

        dvp = None
        if verifier_pub_key is not None:
            dvp = DesignatedVerifierPoKOfPublicKey.new(
                rng, verifier_pub_key, params.g_tilde)
        return cls(A_hat=A_hat, D=D, B_bar=B_bar, blinded_pk=blinded.point,
                   blinding_pk=blinding_pk, sc_B_bar=sc_B_bar,
                   sc_comm_msgs=sc_comm_msgs, sc_wits_msgs=wits,
                   hw_sig_type=hw_sig_type,
                   proof_of_validity=proof_of_validity,
                   designated_verifier_pk_proof=dvp)

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               writer: ByteWriter):
        compute_challenge_contribution(
            self.A_hat, self.B_bar, self.D, self.blinded_pk,
            self.sc_B_bar.t, self.sc_comm_msgs.t, revealed_msgs, params,
            writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfMAC":
        chal = challenge
        if self.designated_verifier_pk_proof is not None:
            chal = challenge - self.designated_verifier_pk_proof.challenge
        return PoKOfMAC(
            A_hat=self.A_hat, B_bar=self.B_bar, D=self.D,
            blinded_pk=self.blinded_pk,
            sc_B_bar=self.sc_B_bar.gen_proof(chal),
            t_msgs=self.sc_comm_msgs.t,
            sc_resp_msgs=self.sc_comm_msgs.response(self.sc_wits_msgs, chal),
            hw_sig_type=self.hw_sig_type,
            proof_of_validity=self.proof_of_validity,
            designated_verifier_pk_proof=self.designated_verifier_pk_proof)

    # -- hardware signature transformations --

    def transform_schnorr_sig(self, sig):
        """response' = response + blinding*challenge so the sig verifies
        under blinded_pk = pk + g*blinding."""
        if self.hw_sig_type != SCHNORR:
            raise KVACError("wrong hardware signature type")
        from ...utils.schnorr_signature import SchnorrSignature
        return SchnorrSignature(
            response=sig.response + self.blinding_pk * sig.challenge,
            challenge=sig.challenge)

    def transform_message_for_ecdsa_sig(self, message: Fp) -> Fp:
        """Hardware must sign message/blinding for the transformed sig to
        verify the original message under blinded_pk."""
        if self.hw_sig_type != ECDSA:
            raise KVACError("wrong hardware signature type")
        Fs = secp256r1.scalar_field
        return message * Fs(int(self.blinding_pk)).inverse()

    def transform_ecdsa_sig(self, sig):
        """(r, s) -> (r, s*blinding): verifies under blinded_pk =
        pk*blinding for the ORIGINAL message."""
        if self.hw_sig_type != ECDSA:
            raise KVACError("wrong hardware signature type")
        Fs = secp256r1.scalar_field
        r, s = sig
        return (r, int(Fs(s) * Fs(int(self.blinding_pk))))


@dataclass
class PoKOfMAC:
    A_hat: Point
    B_bar: Point
    D: Point
    blinded_pk: Point
    sc_B_bar: PokPedersenCommitment
    t_msgs: Point
    sc_resp_msgs: SchnorrResponse
    hw_sig_type: str
    proof_of_validity: tuple = None
    designated_verifier_pk_proof: object = None

    def verify(self, revealed_msgs: dict, challenge: Fp,
               secret_key: SecretKey, params: MACParams,
               verifier_pub_key: Point = None) -> bool:
        if self.B_bar != (self.A_hat * int(secret_key.x)).normalize():
            return False
        return self.verify_common(revealed_msgs, challenge, params,
                                  verifier_pub_key)

    def verify_given_proof_of_validity(self, revealed_msgs: dict,
                                       challenge: Fp,
                                       signer_pk: SignerPublicKey,
                                       params: MACParams,
                                       nonce: bytes = None,
                                       verifier_pub_key: Point = None,
                                       digest=blake2b512) -> bool:
        if self.proof_of_validity is None:
            return False
        c, r = self.proof_of_validity
        if not ProofOfValidity.verify_given_destructured(
                self.A_hat, self.B_bar, c, r, signer_pk.point,
                params.g_tilde, nonce, digest):
            return False
        return self.verify_common(revealed_msgs, challenge, params,
                                  verifier_pub_key)

    def to_keyed_proof(self) -> KeyedProofBBSSharp:
        return KeyedProofBBSSharp(B_0=self.A_hat, C=self.B_bar)

    def verify_common(self, revealed_msgs: dict, challenge: Fp,
                      params: MACParams,
                      verifier_pub_key: Point = None) -> bool:
        chal = challenge
        if self.designated_verifier_pk_proof is not None:
            if verifier_pub_key is None:
                return False
            if not self.designated_verifier_pk_proof.verify(
                    verifier_pub_key, params.g_tilde):
                return False
            chal = challenge - self.designated_verifier_pk_proof.challenge
        if not self.sc_B_bar.verify(self.B_bar, self.A_hat, self.D, chal):
            return False
        bases, bases_rev, exps = [], [], []
        for i in range(params.supported_message_count):
            if i in revealed_msgs:
                bases_rev.append(params.g_vec[i])
                exps.append(revealed_msgs[i])
            else:
                bases.append(params.g_vec[i])
        bases.append(self.D)
        revealed_part = msm(bases_rev, exps) if bases_rev \
            else params.g.curve.infinity()
        if self.hw_sig_type == SCHNORR:
            bases.append(params.g)
            y = (-(revealed_part + params.g_0 + self.blinded_pk)).normalize()
        else:
            bases.append(self.blinded_pk)
            y = (-(revealed_part + params.g_0)).normalize()
        return self.sc_resp_msgs.is_valid(bases, y, self.t_msgs, chal)

    def challenge_contribution(self, revealed_msgs: dict, params: MACParams,
                               writer: ByteWriter):
        compute_challenge_contribution(
            self.A_hat, self.B_bar, self.D, self.blinded_pk,
            self.sc_B_bar.t, self.t_msgs, revealed_msgs, params, writer)

    def get_resp_for_message(self, msg_idx: int,
                             revealed_msg_ids) -> Fp:
        if msg_idx in revealed_msg_ids:
            raise KVACError("message is revealed")
        adjusted = sum(1 for i in range(msg_idx)
                       if i not in revealed_msg_ids)
        return self.sc_resp_msgs.get_response(adjusted)


def compute_challenge_contribution(A_hat, B_bar, D, blinded_pk, t_B_bar,
                                   t_msgs, revealed_msgs: dict,
                                   params: MACParams, writer: ByteWriter):
    writer.point(A_hat)
    writer.point(B_bar)
    writer.point(D)
    writer.point(blinded_pk)
    writer.point(params.g)
    writer.point(t_B_bar)
    writer.point(t_msgs)
    for i in range(len(params.g_vec)):
        writer.point(params.g_vec[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])
