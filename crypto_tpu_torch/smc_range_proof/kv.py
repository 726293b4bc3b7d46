"""Keyed-verification CCS range proofs, the port's own copy of
`crypto_tpu/smc_range_proof/kv.py` (reference
`smc_range_proof/src/ccs_range_proof/{kv_perfect_range,
kv_arbitrary_range}.rs` and `ccs_set_membership/kv_single.rs`): no
pairings anywhere — the verifier holds the BB-sig secret key and checks
each digit's randomized weak-BB signature directly (A_bar == A'*sk).

The digit responses come out of the weak-BB KV PoKs (msg_blinding = s_i),
so the same commitment-consistency checks as the public variants apply."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, concat_slices, group_elem_from_try_and_incr
from ..serialize import ByteWriter
from ..short_group_sig.weak_bb import (PoKWeakBBSigKV,
                                       PoKWeakBBSigKVProtocol,
                                       WeakBBSecretKey, WeakBBSig)
from .ccs import MemberCommitmentKey, SmcError, base_n_digits_padded
from .ranges_extra import find_l_for_arbitrary_range
from .ccs import find_l_for_perfect_range

F = bls.Fr


@dataclass
class SetMembershipCheckParamsKV:
    g1: Point
    set_members: list
    sigs: list
    sk: WeakBBSecretKey    # retained by the VERIFIER only in deployments

    @classmethod
    def new(cls, rng, label: bytes, members, digest=blake2b512):
        g1 = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g1"), digest).normalize()
        sk = WeakBBSecretKey.generate(rng)
        sigs = [WeakBBSig.new(m, sk, g1) for m in members]
        return cls(g1=g1, set_members=list(members), sigs=sigs, sk=sk)

    @classmethod
    def new_for_range_proof(cls, rng, label: bytes, base: int):
        return cls.new(rng, label, [F(i) for i in range(base)])

    def get_sig(self, member: Fp) -> WeakBBSig:
        for m, s in zip(self.set_members, self.sigs):
            if m == member:
                return s
        raise SmcError("member not in set")


@dataclass
class CCSPerfectRangeKVProtocol:
    base: int
    pok_sigs: list
    D: Point
    m: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, max_val: int, base: int,
             comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParamsKV):
        l = find_l_for_perfect_range(max_val, base)
        m = F.rand(rng)
        msg_blindings = [F.rand(rng) for _ in range(l)]
        D = comm_key.commit_decomposed(base, msg_blindings, m)
        digits = base_n_digits_padded(value, base, l)
        pok_sigs = [
            PoKWeakBBSigKVProtocol.init(
                rng, params.get_sig(d), d, params.g1,
                blinding=msg_blindings[i])
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

    def gen_proof(self, challenge: Fp) -> "CCSPerfectRangeKVProof":
        return CCSPerfectRangeKVProof(
            base=self.base,
            pok_sigs=[p.gen_proof(challenge) for p in self.pok_sigs],
            D=self.D, resp_r=self.m + self.r * challenge)


@dataclass
class CCSPerfectRangeKVProof:
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
               params: SetMembershipCheckParamsKV,
               secret_key: WeakBBSecretKey) -> bool:
        l = find_l_for_perfect_range(max_val, self.base)
        if len(self.pok_sigs) != l:
            return False
        z_sigma = [p.response_for_message() for p in self.pok_sigs]
        lhs = (comm_key.commit_decomposed(self.base, z_sigma, self.resp_r)
               - commitment * int(challenge)).normalize()
        if lhs != self.D:
            return False
        return all(p.verify(challenge, secret_key, params.g1)
                   for p in self.pok_sigs)


@dataclass
class CCSArbitraryRangeKVProtocol:
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
             params: SetMembershipCheckParamsKV):
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
        mk = lambda ds, bl: [
            PoKWeakBBSigKVProtocol.init(rng, params.get_sig(d), d,
                                        params.g1, blinding=bl[i])
            for i, d in enumerate(ds)]
        return cls(base=base, pok_sigs_min=mk(digits_min, bl_min),
                   pok_sigs_max=mk(digits_max, bl_max), D_min=D_min,
                   D_max=D_max, m_min=m_min, m_max=m_max, r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        for p in self.pok_sigs_min + self.pok_sigs_max:
            p.challenge_contribution(params.g1, writer)
        writer.point(commitment)
        writer.point(self.D_min)
        writer.point(self.D_max)

    def gen_proof(self, challenge: Fp) -> "CCSArbitraryRangeKVProof":
        return CCSArbitraryRangeKVProof(
            base=self.base,
            pok_sigs_min=[p.gen_proof(challenge)
                          for p in self.pok_sigs_min],
            pok_sigs_max=[p.gen_proof(challenge)
                          for p in self.pok_sigs_max],
            D_min=self.D_min, D_max=self.D_max,
            resp_r_min=self.m_min + self.r * challenge,
            resp_r_max=self.m_max + self.r * challenge)


@dataclass
class CCSArbitraryRangeKVProof:
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
               params: SetMembershipCheckParamsKV,
               secret_key: WeakBBSecretKey) -> bool:
        l = find_l_for_arbitrary_range(max_val, min_val, self.base)
        if len(self.pok_sigs_min) != l or len(self.pok_sigs_max) != l:
            return False
        comm_c = commitment * int(challenge)
        z_min = [p.response_for_message() for p in self.pok_sigs_min]
        z_max = [p.response_for_message() for p in self.pok_sigs_max]
        lhs = (comm_key.commit_decomposed(self.base, z_min,
                                          self.resp_r_min)
               + comm_key.g * int(F(min_val) * challenge)
               - comm_c).normalize()
        if lhs != self.D_min:
            return False
        x = F(self.base ** l) - F(max_val)
        lhs = (comm_key.commit_decomposed(self.base, z_max,
                                          self.resp_r_max)
               - comm_key.g * int(x * challenge) - comm_c).normalize()
        if lhs != self.D_max:
            return False
        return all(p.verify(challenge, secret_key, params.g1)
                   for p in self.pok_sigs_min + self.pok_sigs_max)
