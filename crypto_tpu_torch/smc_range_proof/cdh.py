"""CDH variants of the CCS/CLS range proofs, the port's own copy of
`crypto_tpu/smc_range_proof/cdh.py` (reference
`smc_range_proof/src/ccs_range_proof/{perfect_range_cdh,
arbitrary_range_cdh}.rs` and `cls_range_proof/{range_proof_cdh,
kv_range_proof}.rs`).

Same digit-certificate structure as the originals, but each digit's
weak-BB signature knowledge proof is the pairing-free CDH PoK
(A' = A*r, A_bar = g1*r - A'*d): the PROVER does no pairings and no GT
exponentiations; the verifier does one pairing pair per digit (batchable
with the randomized pairing checker).  The digit responses come out of
the PoKs with externally-forced blindings, so the same
commitment-consistency linear checks as the original variants apply.
The CLS KV variant additionally replaces the verifier's pairings with
the secret-key check A_bar == A'*x.

The verifier's pairs: each digit's two into a `RandomizedPairingChecker`
when there is one (its lazy Miller product on the device from the
checker's threshold), else every digit's 2-pairing product in one
`curves.tpairing.multi_pairings_routed` call on `device`, each held to
one (the reference pairs digit by digit on the host and stops at the
first bad one; the verdict is the same)."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..serialize import ByteWriter
from ..short_group_sig.weak_bb import (PoKWeakBBSig, PoKWeakBBSigKV,
                                       PoKWeakBBSigKVProtocol,
                                       PoKWeakBBSigProtocol,
                                       WeakBBSecretKey)
from .ccs import (MemberCommitmentKey, SetMembershipCheckParams, SmcError,
                  base_n_digits_padded, find_l_for_perfect_range)
from .kv import SetMembershipCheckParamsKV
from .ranges_extra import (find_l_for_arbitrary_range,
                           find_number_of_digits, find_sumset_boundaries,
                           get_range_and_randomness_multiple,
                           get_sumset_parameters)

F = bls.Fr


def _pok_digit_protocols(rng, digits, blindings, params):
    return [PoKWeakBBSigProtocol.init(rng, params.get_sig(d), d, params.g1,
                                      blinding=blindings[i])
            for i, d in enumerate(digits)]


def _verify_pok_sigs(pok_sigs, challenge, params, pairing_checker=None,
                     device="cuda"):
    if pairing_checker is not None:
        return all(p.verify_with_pairing_checker(
            challenge, params.bb_pk, params.g1, params.g2, pairing_checker)
            for p in pok_sigs)
    if not all(p.verify_schnorr(challenge, params.g1) for p in pok_sigs):
        return False
    # e(A', pk) == e(A_bar, g2), each digit's as one product
    groups = [[(p.A_prime, params.bb_pk.w),
               ((-p.A_bar).normalize(), params.g2)] for p in pok_sigs]
    return all(x.is_one() for x in multi_pairings_routed(groups, device))


# ---------------------------------------------------------------------------
# CCS perfect range, CDH (`perfect_range_cdh.rs`)
# ---------------------------------------------------------------------------

@dataclass
class CCSPerfectRangeCDHProtocol:
    base: int
    pok_sigs: list
    D: Point
    m: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, max_val: int, base: int,
             comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams):
        l = find_l_for_perfect_range(max_val, base)
        m = F.rand(rng)
        msg_blindings = [F.rand(rng) for _ in range(l)]
        D = comm_key.commit_decomposed(base, msg_blindings, m)
        digits = base_n_digits_padded(value, base, l)
        return cls(base=base,
                   pok_sigs=_pok_digit_protocols(rng, digits, msg_blindings,
                                                 params),
                   D=D, m=m, r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs:
            p.challenge_contribution(params.g1, writer)
        writer.point(comm_key.g)
        writer.point(comm_key.h)
        writer.point(commitment)
        writer.point(self.D)

    def gen_proof(self, challenge: Fp) -> "CCSPerfectRangeCDHProof":
        return CCSPerfectRangeCDHProof(
            base=self.base,
            pok_sigs=[p.gen_proof(challenge) for p in self.pok_sigs],
            D=self.D, resp_r=self.m + self.r * challenge)


@dataclass
class CCSPerfectRangeCDHProof:
    base: int
    pok_sigs: list
    D: Point
    resp_r: Fp

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs:
            p.challenge_contribution(params.g1, writer)
        writer.point(comm_key.g)
        writer.point(comm_key.h)
        writer.point(commitment)
        writer.point(self.D)

    def verify(self, commitment: Point, challenge: Fp, max_val: int,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        l = find_l_for_perfect_range(max_val, self.base)
        if len(self.pok_sigs) != l:
            return False
        z_sigma = [p.get_resp_for_message() for p in self.pok_sigs]
        lhs = (comm_key.commit_decomposed(self.base, z_sigma, self.resp_r)
               - commitment * int(challenge)).normalize()
        if lhs != self.D:
            return False
        return _verify_pok_sigs(self.pok_sigs, challenge, params,
                                pairing_checker, device)


# ---------------------------------------------------------------------------
# CCS arbitrary range, CDH (`arbitrary_range_cdh.rs`)
# ---------------------------------------------------------------------------

@dataclass
class CCSArbitraryRangeCDHProtocol:
    base: int
    pok_sigs_min: list
    pok_sigs_max: list
    D_min: Point
    D_max: Point
    m_min: Fp
    m_max: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, min_val: int,
             max_val: int, base: int, comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams):
        if not (min_val <= value < max_val):
            raise SmcError("value out of claimed range")
        l = find_l_for_arbitrary_range(max_val, min_val, base)
        m_min, m_max = F.rand(rng), F.rand(rng)
        bl_min = [F.rand(rng) for _ in range(l)]
        bl_max = [F.rand(rng) for _ in range(l)]
        D_min = comm_key.commit_decomposed(base, bl_min, m_min)
        D_max = comm_key.commit_decomposed(base, bl_max, m_max)
        digits_min = base_n_digits_padded(value - min_val, base, l)
        digits_max = base_n_digits_padded(value + base ** l - max_val,
                                          base, l)
        return cls(
            base=base,
            pok_sigs_min=_pok_digit_protocols(rng, digits_min, bl_min,
                                              params),
            pok_sigs_max=_pok_digit_protocols(rng, digits_max, bl_max,
                                              params),
            D_min=D_min, D_max=D_max, m_min=m_min, m_max=m_max,
            r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs_min + self.pok_sigs_max:
            p.challenge_contribution(params.g1, writer)
        writer.point(commitment)
        writer.point(self.D_min)
        writer.point(self.D_max)

    def gen_proof(self, challenge: Fp) -> "CCSArbitraryRangeCDHProof":
        return CCSArbitraryRangeCDHProof(
            base=self.base,
            pok_sigs_min=[p.gen_proof(challenge)
                          for p in self.pok_sigs_min],
            pok_sigs_max=[p.gen_proof(challenge)
                          for p in self.pok_sigs_max],
            D_min=self.D_min, D_max=self.D_max,
            resp_r_min=self.m_min + self.r * challenge,
            resp_r_max=self.m_max + self.r * challenge)


@dataclass
class CCSArbitraryRangeCDHProof:
    base: int
    pok_sigs_min: list
    pok_sigs_max: list
    D_min: Point
    D_max: Point
    resp_r_min: Fp
    resp_r_max: Fp

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs_min + self.pok_sigs_max:
            p.challenge_contribution(params.g1, writer)
        writer.point(commitment)
        writer.point(self.D_min)
        writer.point(self.D_max)

    def verify(self, commitment: Point, challenge: Fp, min_val: int,
               max_val: int, comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        l = find_l_for_arbitrary_range(max_val, min_val, self.base)
        if len(self.pok_sigs_min) != l or len(self.pok_sigs_max) != l:
            return False
        comm_c = commitment * int(challenge)
        z_min = [p.get_resp_for_message() for p in self.pok_sigs_min]
        z_max = [p.get_resp_for_message() for p in self.pok_sigs_max]
        lhs = (comm_key.commit_decomposed(self.base, z_min, self.resp_r_min)
               + comm_key.g * int(F(min_val) * challenge)
               - comm_c).normalize()
        if lhs != self.D_min:
            return False
        x = F(self.base ** l) - F(max_val)
        lhs = (comm_key.commit_decomposed(self.base, z_max, self.resp_r_max)
               - comm_key.g * int(x * challenge) - comm_c).normalize()
        if lhs != self.D_max:
            return False
        return _verify_pok_sigs(self.pok_sigs_min + self.pok_sigs_max,
                                challenge, params, pairing_checker, device)


# ---------------------------------------------------------------------------
# CLS sumset range, CDH + KV (`range_proof_cdh.rs`, `kv_range_proof.rs`)
# ---------------------------------------------------------------------------

def _cls_commit(comm_key, weights, responses, randomness):
    ip = F(0)
    for zi, gi in zip(responses, weights):
        ip = ip + zi * F(gi)
    return comm_key.commit(ip, randomness)


@dataclass
class CLSRangeCDHProtocol:
    base: int
    pok_sigs: list
    D: Point
    m: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, min_val: int,
             max_val: int, base: int, comm_key: MemberCommitmentKey,
             params, kv: bool = False):
        if not (min_val <= value < max_val):
            raise SmcError("value out of claimed range")
        l, G, rmult, digits = get_sumset_parameters(value, min_val,
                                                    max_val, base)
        m = F.rand(rng)
        s = [F.rand(rng) for _ in range(l)]
        D = _cls_commit(comm_key, G, s, m * F(rmult))
        proto = PoKWeakBBSigKVProtocol if kv else PoKWeakBBSigProtocol
        pok_sigs = [proto.init(rng, params.get_sig(F(d)), F(d), params.g1,
                               blinding=s[i])
                    for i, d in enumerate(digits)]
        return cls(base=base, pok_sigs=pok_sigs, D=D, m=m, r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs:
            p.challenge_contribution(params.g1, writer)
        writer.point(comm_key.g)
        writer.point(comm_key.h)
        writer.point(commitment)
        writer.point(self.D)

    def gen_proof(self, challenge: Fp):
        proofs = [p.gen_proof(challenge) for p in self.pok_sigs]
        resp_r = self.m + self.r * challenge
        if proofs and isinstance(proofs[0], PoKWeakBBSigKV):
            return CLSRangeKVProof(base=self.base, pok_sigs=proofs,
                                   D=self.D, resp_r=resp_r)
        return CLSRangeCDHProof(base=self.base, pok_sigs=proofs, D=self.D,
                                resp_r=resp_r)


class _CLSVerifyMixin:
    def _check_commitment(self, commitment, challenge, min_val, max_val,
                          comm_key, responses):
        range_, rmult = get_range_and_randomness_multiple(
            self.base, min_val, max_val - 1)
        l = find_number_of_digits(range_, self.base)
        G = find_sumset_boundaries(range_, self.base, l)
        if len(self.pok_sigs) != l:
            return False
        lhs = (_cls_commit(comm_key, G, responses,
                           F(rmult) * self.resp_r)
               + comm_key.g * int(F(min_val * rmult) * challenge)
               - commitment * int(F(rmult) * challenge)).normalize()
        return lhs == self.D

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs:
            p.challenge_contribution(params.g1, writer)
        writer.point(comm_key.g)
        writer.point(comm_key.h)
        writer.point(commitment)
        writer.point(self.D)


@dataclass
class CLSRangeCDHProof(_CLSVerifyMixin):
    base: int
    pok_sigs: list
    D: Point
    resp_r: Fp

    def verify(self, commitment: Point, challenge: Fp, min_val: int,
               max_val: int, comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        responses = [p.get_resp_for_message() for p in self.pok_sigs]
        if not self._check_commitment(commitment, challenge, min_val,
                                      max_val, comm_key, responses):
            return False
        return _verify_pok_sigs(self.pok_sigs, challenge, params,
                                pairing_checker, device)


@dataclass
class CLSRangeKVProof(_CLSVerifyMixin):
    base: int
    pok_sigs: list
    D: Point
    resp_r: Fp

    def verify(self, commitment: Point, challenge: Fp, min_val: int,
               max_val: int, comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParamsKV,
               secret_key: WeakBBSecretKey) -> bool:
        responses = [p.response_for_message() for p in self.pok_sigs]
        if not self._check_commitment(commitment, challenge, min_val,
                                      max_val, comm_key, responses):
            return False
        return all(p.verify(challenge, secret_key, params.g1)
                   for p in self.pok_sigs)
