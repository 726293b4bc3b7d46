"""Keyed proofs for BBDT16 KVAC: the part of a credential presentation
that only the MAC-issuer can check, plus the issuer's proofs of its
validity or invalidity toward third parties
(reference `kvac/src/bbdt_2016/keyed_proof.rs`): the port's own copy of
`crypto_tpu/kvac/keyed_proof.py`.  Host code but for the public
verification key's pairing product, which goes through
`curves.tpairing.multi_pairings_routed` on `device` (CUDA unless the
caller names the CPU; raises without a card).

A KeyedProof (B_0, C) claims C = B_0 * sk.  The issuer can:
  - check it directly with sk,
  - publish a PublicVerificationKey (P, Q=P*sk) in G2 so ANYONE can check
    via the pairing e(B_0, Q) == e(C, P) (BLS12-381 only),
  - issue a proof of validity: dual Schnorr on (g_0 -> pk) and (B_0 -> C)
    with a shared response,
  - issue a proof of invalidity: unknown-discrete-log inequality showing
    its key does NOT map B_0 to C.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..hashing import (blake2b512, compute_random_oracle_challenge,
                       concat_slices, group_elem_from_try_and_incr)
from ..schnorr.discrete_log import (PartialPokDiscreteLog, PokDiscreteLog,
                                    PokDiscreteLogProtocol)
from ..schnorr.inequality import (UnknownDiscreteLogInequalityProof,
                                  UnknownDiscreteLogInequalityProtocol)
from ..serialize import ByteWriter


@dataclass
class PublicVerificationKey:
    """(P, Q = P*sk) in G2 — lets third parties pairing-check keyed proofs
    whose group is BLS12-381 G1."""
    P: Point
    Q: Point

    @classmethod
    def new(cls, label: bytes, sk: Fp, digest=blake2b512):
        P = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : P"), digest).normalize()
        return cls(P=P, Q=(P * int(sk)).normalize())


@dataclass
class KeyedProof:
    B_0: Point
    C: Point

    def verify(self, secret_key: Fp) -> bool:
        return (self.B_0 * int(secret_key)).normalize() == \
            self.C.normalize()

    def verify_with_public_verification_key(
            self, pk: PublicVerificationKey, device="cuda") -> bool:
        """e(B_0, Q) * e(-C, P) == 1 (`keyed_proof.rs:82-103`)."""
        return multi_pairings_routed(
            [[(self.B_0, pk.Q), ((-self.C).normalize(), pk.P)]],
            device)[0].is_one()

    def create_proof_of_validity(self, rng, secret_key: Fp, pk: Point,
                                 g_0: Point, digest=blake2b512
                                 ) -> "ProofOfValidityOfKeyedProof":
        F = secret_key.f
        sk_blinding = F.rand(rng)
        sc_pk = PokDiscreteLogProtocol.init(secret_key, sk_blinding, g_0)
        sc_proof = PokDiscreteLogProtocol.init(secret_key, sk_blinding,
                                               self.B_0)
        w = ByteWriter()
        sc_pk.challenge_contribution(g_0, pk, w)
        sc_proof.challenge_contribution(self.B_0, self.C, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        return ProofOfValidityOfKeyedProof(
            sc_pk=sc_pk.gen_proof(challenge),
            sc_proof=sc_proof.gen_partial_proof())

    def create_proof_of_invalidity(self, rng, secret_key: Fp, pk: Point,
                                   g_0: Point, digest=blake2b512
                                   ) -> "ProofOfInvalidityOfKeyedProof":
        F = secret_key.f
        protocol = UnknownDiscreteLogInequalityProtocol.init(
            rng, secret_key, g_0, self.B_0, pk, self.C)
        w = ByteWriter()
        protocol.challenge_contribution(g_0, self.B_0, pk, self.C, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        return ProofOfInvalidityOfKeyedProof(
            proof=protocol.gen_proof(challenge))


@dataclass
class ProofOfValidityOfKeyedProof:
    sc_pk: PokDiscreteLog
    sc_proof: PartialPokDiscreteLog

    def verify(self, proof: KeyedProof, pk: Point, g_0: Point,
               digest=blake2b512) -> bool:
        return self.verify_given_destructured(proof.B_0, proof.C, pk, g_0,
                                              digest)

    def verify_given_destructured(self, B_0: Point, C: Point, pk: Point,
                                  g_0: Point, digest=blake2b512) -> bool:
        F = pk.curve.scalar_field
        w = ByteWriter()
        self.sc_pk.challenge_contribution(g_0, pk, w)
        self.sc_proof.challenge_contribution(B_0, C, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        if not self.sc_pk.verify(pk, g_0, challenge):
            return False
        return self.sc_proof.verify(C, B_0, challenge, self.sc_pk.response)


@dataclass
class ProofOfInvalidityOfKeyedProof:
    proof: UnknownDiscreteLogInequalityProof

    def verify(self, keyed: KeyedProof, pk: Point, g_0: Point,
               digest=blake2b512) -> bool:
        F = pk.curve.scalar_field
        w = ByteWriter()
        self.proof.challenge_contribution(g_0, keyed.B_0, pk, keyed.C, w)
        challenge = compute_random_oracle_challenge(F, bytes(w.buf), digest)
        return self.proof.verify(g_0, keyed.B_0, pk, keyed.C, challenge)
