"""Proof of knowledge of a BBS+ signature with selective disclosure: the
port's own copy of `crypto_tpu/bbs_plus/proof.py` (reference
`bbs_plus/src/proof.rs:100-560`, paper 2016/663 section 4.5).

Prover randomizes the signature:
  r1 != 0, r2 random, r3 = 1/r1
  A' = A*r1 ;  A_bar = b*r1 - A'*e ;  d = b*r1 - h_0*r2 ;  s' = s - r2*r3
and proves two Schnorr relations sharing one challenge:
  (1) A_bar - d == A'*(-e) + h_0*r2              (PokPedersenCommitment)
  (2) d*(-r3) + h_0*s' + sum_{j not in D} h_j*m_j
        == -(g1 + sum_{i in D} h_i*m_i)          (generalized Schnorr)
Verifier additionally checks the pairing  e(A', pk) * e(-A_bar, g2) == 1:
on the host (`verify`), or deferred into a RandomizedPairingChecker
(`verify_with_randomized_pairing_checker`), whose lazy Miller product runs
on the device; `bbs_plus/batch.py` `batch_verify_proofs` collapses N
proofs' pairing legs into one device 2-pairing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..serialize import ByteWriter
from ..utils.msm import msm
from .setup import PublicKeyG2, SignatureParamsG1
from .signature import BBSPlusError, SignatureG1


@dataclass
class MessageOrBlinding:
    """How each message participates in the proof."""
    message: Fp
    reveal: bool = False
    blinding: Optional[Fp] = None  # used when hidden and caller supplies it

    @classmethod
    def blind_randomly(cls, m: Fp):
        return cls(message=m, reveal=False, blinding=None)

    @classmethod
    def reveal_message(cls, m: Fp):
        return cls(message=m, reveal=True)

    @classmethod
    def blind_with(cls, m: Fp, blinding: Fp):
        return cls(message=m, reveal=False, blinding=blinding)


@dataclass
class PoKOfSignatureG1Protocol:
    A_prime: Point
    A_bar: Point
    d: Point
    sc_comm_1: PokPedersenCommitmentProtocol
    sc_comm_2: SchnorrCommitment
    sc_wits_2: list
    undisclosed_indices: list

    @classmethod
    def init(cls, rng, signature: SignatureG1, params: SignatureParamsG1,
             messages_and_blindings: list) -> "PoKOfSignatureG1Protocol":
        if len(messages_and_blindings) != params.supported_message_count:
            raise BBSPlusError("message count incompatible with params")
        messages = [mb.message for mb in messages_and_blindings]
        indexed_blindings = [
            (i, mb.blinding if mb.blinding is not None else bls.Fr.rand(rng))
            for i, mb in enumerate(messages_and_blindings) if not mb.reveal
        ]

        r1 = bls.Fr.rand_nonzero(rng)
        r2 = bls.Fr.rand(rng)
        r3 = r1.inverse()

        b = params.b(list(enumerate(messages)), signature.s)
        A_prime = signature.A * int(r1)
        b_r1 = b * int(r1)
        A_bar = b_r1 - A_prime * int(signature.e)
        d = b_r1 - params.h_0 * int(r2)
        A_prime, A_bar, d = (p.normalize() for p in (A_prime, A_bar, d))
        s_prime = signature.s - r2 * r3

        sc_comm_1 = PokPedersenCommitmentProtocol.init(
            -signature.e, bls.Fr.rand(rng), A_prime,
            r2, bls.Fr.rand(rng), params.h_0)

        bases_2 = [params.h[i] for i, _ in indexed_blindings] + [d, params.h_0]
        randomness_2 = [bl for _, bl in indexed_blindings] + \
            [bls.Fr.rand(rng), bls.Fr.rand(rng)]
        wits_2 = [messages[i] for i, _ in indexed_blindings] + [-r3, s_prime]
        sc_comm_2 = SchnorrCommitment.new(bases_2, randomness_2)

        return cls(A_prime=A_prime, A_bar=A_bar, d=d, sc_comm_1=sc_comm_1,
                   sc_comm_2=sc_comm_2, sc_wits_2=wits_2,
                   undisclosed_indices=[i for i, _ in indexed_blindings])

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParamsG1, writer: ByteWriter):
        compute_challenge_contribution(
            self.A_prime, self.A_bar, self.d, self.sc_comm_1.t,
            self.sc_comm_2.t, revealed_msgs, params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKOfSignatureG1Proof":
        return PoKOfSignatureG1Proof(
            A_prime=self.A_prime, A_bar=self.A_bar, d=self.d,
            sc_resp_1=self.sc_comm_1.gen_proof(challenge),
            T2=self.sc_comm_2.t,
            sc_resp_2=self.sc_comm_2.response(self.sc_wits_2, challenge),
        )


def compute_challenge_contribution(A_prime, A_bar, d, T1, T2, revealed_msgs,
                                   params, writer: ByteWriter):
    """Byte layout mirrors `proof.rs:322-353`."""
    writer.points((A_prime, A_bar, d, params.h_0, params.g1, T1, T2))
    for i in range(len(params.h)):
        writer.point(params.h[i])
        if i in revealed_msgs:
            writer.field(revealed_msgs[i])


@dataclass
class PoKOfSignatureG1Proof:
    A_prime: Point
    A_bar: Point
    d: Point
    sc_resp_1: PokPedersenCommitment
    T2: Point
    sc_resp_2: SchnorrResponse

    def challenge_contribution(self, revealed_msgs: dict,
                               params: SignatureParamsG1, writer: ByteWriter):
        compute_challenge_contribution(
            self.A_prime, self.A_bar, self.d, self.sc_resp_1.t, self.T2,
            revealed_msgs, params, writer)

    def _schnorr_2_statement(self, revealed_msgs: dict,
                             params: SignatureParamsG1) -> tuple:
        """Relation (2)'s bases and its y = -(g1 + sum_{revealed} h_i*m_i)."""
        undisclosed = [i for i in range(len(params.h))
                       if i not in revealed_msgs]
        bases_2 = [params.h[i] for i in undisclosed] + [self.d, params.h_0]
        pts = [params.g1] + [params.h[i] for i in revealed_msgs]
        sc = [bls.Fr(1)] + [revealed_msgs[i] for i in revealed_msgs]
        return bases_2, (-msm(pts, sc)).normalize()

    def _verify_schnorr(self, revealed_msgs: dict, challenge: Fp,
                        params: SignatureParamsG1) -> None:
        if self.A_prime.is_infinity():
            raise BBSPlusError("zero randomized signature")
        A_bar_minus_d = (self.A_bar - self.d).normalize()
        if not self.sc_resp_1.verify(A_bar_minus_d, self.A_prime,
                                     params.h_0, challenge):
            raise BBSPlusError("first Schnorr verification failed")
        bases_2, y = self._schnorr_2_statement(revealed_msgs, params)
        if not self.sc_resp_2.is_valid(bases_2, y, self.T2, challenge):
            raise BBSPlusError("second Schnorr verification failed")

    def verify(self, revealed_msgs: dict, challenge: Fp, pk: PublicKeyG2,
               params: SignatureParamsG1) -> bool:
        self._verify_schnorr(revealed_msgs, challenge, params)
        out = bls.multi_pairing([(self.A_prime, pk.w),
                                 (-self.A_bar, params.g2)])
        if not out.is_one():
            raise BBSPlusError("pairing check failed")
        return True

    def verify_schnorr_with_randomized_mult_checker(
            self, revealed_msgs: dict, challenge: Fp,
            params: SignatureParamsG1, rmc) -> None:
        """Accumulate both Schnorr legs into a RandomizedMultChecker so N
        proofs verify with ONE MSM (reference `proof.rs` with
        `RandomizedMultChecker`; used by `batch.batch_verify_proofs`)."""
        A_bar_minus_d = (self.A_bar - self.d).normalize()
        self.sc_resp_1.verify_with_randomized_mult_checker(
            A_bar_minus_d, self.A_prime, params.h_0, challenge, rmc)
        bases_2, y = self._schnorr_2_statement(revealed_msgs, params)
        rmc.add_many(bases_2 + [y],
                     list(self.sc_resp_2.responses) + [-challenge], self.T2)

    def verify_with_randomized_pairing_checker(self, revealed_msgs: dict,
                                               challenge: Fp, pk: PublicKeyG2,
                                               params: SignatureParamsG1,
                                               checker) -> None:
        self._verify_schnorr(revealed_msgs, challenge, params)
        checker.add_sources(self.A_prime, pk.w, self.A_bar, params.g2)

    def get_resp_for_message(self, msg_idx: int, revealed_ids=None) -> Fp:
        """Schnorr response for an undisclosed message (for cross-protocol
        equality checks; `proof.rs:447-466`)."""
        revealed_ids = revealed_ids or set()
        if msg_idx in revealed_ids:
            raise BBSPlusError("message is revealed; no response")
        # adjusted index = rank of msg_idx among undisclosed messages
        adjusted = sum(1 for j in range(msg_idx) if j not in revealed_ids)
        return self.sc_resp_2.get_response(adjusted)
