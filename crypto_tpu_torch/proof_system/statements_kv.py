"""Keyed-verification and detached accumulator statements: the port's own
copy of `crypto_tpu/proof_system/statements_kv.py` (reference
`proof_system/src/statement/accumulator/{keyed_verification,detached}.rs`
and `sub_protocols/accumulator/{keyed_verification,detached}.rs`).  Host
code: the detached verifier's accumulator proof pairs on the host, as
the reference's does.

Keyed-verification (KV) statements carry no pairings: the prover sends the
randomized-witness pair (C', C_bar) with a Schnorr proof, a plain verifier
checks only the Schnorr part (delegating C_bar == C'*alpha to the key
holder via the proof's `keyed_part()`), and the *FullVerifier statements
additionally hold the accumulator secret key and check the keyed relation
inline.

Detached statements hide which accumulator the membership proof refers
to: the prover randomizes the accumulator value V' = V*r (witness C' =
C*r; the relation C(y+alpha) = V is homogeneous in r), proves membership
against V', and ECIES-encrypts the opening (V, r) to the verifier's
accumulator public key so only the key holder can link V' back to V
(reference `detached.rs:126-150`)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import (ByteWriter, deserialize_field, deserialize_point,
                         point_nbytes, serialize_field, serialize_point)
from ..accumulator.setup import (AccumPublicKey, AccumSecretKey,
                                 AccumSetupParams)
from ..accumulator.core import MembershipWitness, NonMembershipWitness
from ..accumulator import proofs_cdh as acc_proofs
from ..accumulator.keyed import (KeyedMembershipProof,
                                 KeyedMembershipProofProtocol)
from ..utils.ecies import EciesEncryption
from .base import Statement, ProofSystemError
from .statements import AccumMembershipWit, AccumNonMembershipWit

F = bls.Fr


# ---------------------------------------------------------------------------
# Keyed-verification accumulator statements
# ---------------------------------------------------------------------------

@dataclass
class VBAccumulatorMembershipKV(Statement):
    """Statement `VBAccumulatorMembershipKV` (keyed_verification.rs:57-61):
    the verifier checks only the Schnorr leg; the (C', C_bar) pair is
    later checked by whoever holds alpha."""
    accumulator_value: Point

    def init_subprotocol(self, rng, blindings, witness: AccumMembershipWit):
        protocol = KeyedMembershipProofProtocol.init(
            rng, witness.element, blindings.get(0), witness.witness,
            self.accumulator_value)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                protocol.challenge_contribution(stmt.accumulator_value,
                                                writer)

            def gen_proof(self, challenge):
                return protocol.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof: KeyedMembershipProof,
                                     writer: ByteWriter):
        proof.challenge_contribution(self.accumulator_value, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify_schnorr(self.accumulator_value, challenge):
            raise ProofSystemError("KV accumulator Schnorr proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.response_for_element()


@dataclass
class VBAccumulatorMembershipKVFullVerifier(VBAccumulatorMembershipKV):
    """`VBAccumulatorMembershipKVFullVerifier`: also holds the secret key
    and checks C_bar == C'*alpha inline."""
    secret_key: AccumSecretKey = None

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify(self.accumulator_value, challenge,
                            self.secret_key):
            raise ProofSystemError("KV full-verifier accumulator proof "
                                   "failed")


@dataclass
class KBUniversalAccumulatorMembershipKV(VBAccumulatorMembershipKV):
    """KB-universal KV membership == VB KV membership against the MEMBER
    accumulator's value (keyed_verification.rs:64-68); pass
    accumulator_value = kb.mem.value()."""


@dataclass
class KBUniversalAccumulatorMembershipKVFullVerifier(
        VBAccumulatorMembershipKVFullVerifier):
    pass


@dataclass
class KBUniversalAccumulatorNonMembershipKV(VBAccumulatorMembershipKV):
    """KB-universal KV NON-membership == VB KV membership against the
    NON-MEMBER accumulator's value; pass accumulator_value =
    kb.non_mem.value() and the KB non-membership witness."""


@dataclass
class KBUniversalAccumulatorNonMembershipKVFullVerifier(
        VBAccumulatorMembershipKVFullVerifier):
    pass


# ---------------------------------------------------------------------------
# Detached accumulator statements
# ---------------------------------------------------------------------------

def _serialize_opening(V: Point, randomizer: Fp) -> bytes:
    return serialize_point(V) + serialize_field(randomizer)


def _deserialize_opening(data: bytes):
    n = point_nbytes(bls.G1)
    V = deserialize_point(bls.G1, data[:n])
    r = deserialize_field(F, data[n:n + F.nbytes])
    return V, r


@dataclass
class DetachedAccumMembershipProof:
    """`DetachedAccumulatorMembershipProof`: the randomized accumulator,
    the membership proof against it, its (sub-transcript) challenge, and
    the ECIES-encrypted opening."""
    accumulator: Point                # V' = V * r
    accum_proof: object               # CDH (non)membership proof
    challenge: Fp
    encrypted: EciesEncryption


@dataclass
class DetachedAccumulatorMembershipProver(Statement):
    """Prover-side statement (detached.rs:19-77).  The composite
    challenge seeds a sub-transcript; the accumulator proof itself runs
    against the randomized value so the proof reveals nothing about which
    accumulator (epoch) it refers to."""
    params: AccumSetupParams
    public_key: AccumPublicKey
    Q: Point = None           # only for non-membership

    _non_membership: bool = field(default=False, repr=False)

    def init_subprotocol(self, rng, blindings, witness):
        randomizer = F.rand_nonzero(rng)
        V = witness.accumulator_value
        V_rand = (V * int(randomizer)).normalize()
        if self._non_membership:
            rand_wit = NonMembershipWitness(
                C=(witness.witness.C * int(randomizer)).normalize(),
                d=witness.witness.d * randomizer)
            protocol = acc_proofs.NonMembershipProofProtocol.init(
                rng, witness.element, blindings.get(0), rand_wit, V_rand,
                self.params, self.Q)
        else:
            rand_wit = MembershipWitness(
                C=(witness.witness.C * int(randomizer)).normalize())
            protocol = acc_proofs.MembershipProofProtocol.init(
                rng, witness.element, blindings.get(0), rand_wit, V_rand)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                if stmt._non_membership:
                    protocol.challenge_contribution(V_rand, stmt.params,
                                                    stmt.Q, writer)
                else:
                    protocol.challenge_contribution(V_rand, writer)

            def gen_proof(self, challenge):
                accum_proof = protocol.gen_proof(challenge)
                opening = _serialize_opening(V, randomizer)
                encrypted = EciesEncryption.encrypt(
                    rng, opening, stmt.public_key.Q_tilde,
                    stmt.params.P_tilde, F)
                return DetachedAccumMembershipProof(
                    accumulator=V_rand, accum_proof=accum_proof,
                    challenge=challenge, encrypted=encrypted)

        return SP()

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        if self._non_membership:
            proof.accum_proof.challenge_contribution(
                proof.accumulator, self.params, self.Q, writer)
        else:
            proof.accum_proof.challenge_contribution(proof.accumulator,
                                                     writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        # A plain verifier cannot check anything beyond proof integrity;
        # full verification needs the secret key (verifier statement).
        pass

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.accum_proof.get_schnorr_response_for_element()


@dataclass
class DetachedAccumulatorMembershipVerifier(Statement):
    """Verifier-side statement (detached.rs:81-134 +
    `verify_proof_contribution`): holds the accumulator secret key,
    decrypts the opening and checks V * r == V' in addition to the
    embedded accumulator proof."""
    params: AccumSetupParams
    public_key: AccumPublicKey
    secret_key: AccumSecretKey

    _non_membership: bool = field(default=False, repr=False)
    Q: Point = None           # only for non-membership

    def init_subprotocol(self, rng, blindings, witness):
        raise ProofSystemError("verifier-side statement cannot prove")

    def proof_challenge_contribution(self, proof, writer: ByteWriter):
        writer.point(proof.accumulator)
        writer.point(proof.accum_proof.t if hasattr(proof.accum_proof, "t")
                     else proof.accumulator)

    def verify_proof(self, proof: DetachedAccumMembershipProof, challenge,
                     pairing_checker=None):
        opening = proof.encrypted.decrypt(self.secret_key.alpha)
        V, r = _deserialize_opening(opening)
        if self._non_membership:
            ok = proof.accum_proof.verify(
                proof.accumulator, proof.challenge, self.public_key,
                self.params, self.Q)
        else:
            ok = proof.accum_proof.verify(
                proof.accumulator, proof.challenge, self.public_key,
                self.params)
        if not ok:
            raise ProofSystemError("detached accumulator proof failed")
        if (V * int(r)).normalize() != proof.accumulator:
            raise ProofSystemError("encrypted accumulator opening is "
                                   "inconsistent with the randomized value")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.accum_proof.get_schnorr_response_for_element()


@dataclass
class DetachedAccumNonMembershipWit(AccumNonMembershipWit):
    accumulator_value: Point = None


@dataclass
class DetachedAccumMembershipWit(AccumMembershipWit):
    accumulator_value: Point = None


@dataclass
class DetachedAccumulatorNonMembershipProver(
        DetachedAccumulatorMembershipProver):
    def __post_init__(self):
        self._non_membership = True


@dataclass
class DetachedAccumulatorNonMembershipVerifier(
        DetachedAccumulatorMembershipVerifier):
    def __post_init__(self):
        self._non_membership = True
