"""Remaining CCS set-membership variants, the port's own copy of
`crypto_tpu/smc_range_proof/set_membership.py` (reference
`smc_range_proof/src/ccs_set_membership/{single_member_cdh,batch_members,
kv_single}.rs`); the original single-member protocol lives in `ccs.py`.

* CDH variant: no GT exponentiations for the prover — the weak-BB PoK is
  the CDH-style (A', A_bar) proof, linked to the Pedersen commitment by a
  shared member-blinding (the reference ships the Schnorr with a partial
  response; we carry both responses and check they agree).
* Batch variant: the original sigma protocol vectorized over
  (member_i, r_i, commitment_i).
* KV variant: the verifier holds the BB secret key, so the signature leg
  is the pairing-free keyed-verification PoK.

The batch variant's pairings run as in `ccs.py` on `device`: the
prover's a values in one routed call, the verifier's every member's
equation in one routed call (the reference stops at the first bad
member; the verdict is the same).  The CDH variant's verifier pairs on
the host, as the reference's."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..short_group_sig.weak_bb import (PoKWeakBBSig, PoKWeakBBSigKV,
                                       PoKWeakBBSigKVProtocol,
                                       PoKWeakBBSigProtocol,
                                       WeakBBSecretKey)
from .ccs import (MemberCommitmentKey, SetMembershipCheckParams, SmcError,
                  check_digits, digit_commitments)
from .kv import SetMembershipCheckParamsKV

F = bls.Fr


# ---------------------------------------------------------------------------
# CDH single member (`single_member_cdh.rs`)
# ---------------------------------------------------------------------------

@dataclass
class SetMembershipCheckCDHProtocol:
    pok_sig: PoKWeakBBSigProtocol
    sc: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, member: Fp, r: Fp, comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams):
        sig = params.get_sig(member)
        s = F.rand(rng)
        pok_sig = PoKWeakBBSigProtocol.init(rng, sig, member, params.g1,
                                            blinding=s)
        sc = PokPedersenCommitmentProtocol.init(
            member, s, comm_key.g, r, F.rand(rng), comm_key.h)
        return cls(pok_sig=pok_sig, sc=sc)

    def challenge_contribution(self, commitment: Point,
                               comm_key: MemberCommitmentKey,
                               params: SetMembershipCheckParams,
                               writer: ByteWriter):
        self.pok_sig.challenge_contribution(params.g1, writer)
        self.sc.challenge_contribution(comm_key.g, comm_key.h, commitment,
                                       writer)

    def gen_proof(self, challenge: Fp) -> "SetMembershipCheckCDHProof":
        return SetMembershipCheckCDHProof(
            pok_sig=self.pok_sig.gen_proof(challenge),
            sc=self.sc.gen_proof(challenge))


@dataclass
class SetMembershipCheckCDHProof:
    pok_sig: PoKWeakBBSig
    sc: PokPedersenCommitment

    def challenge_contribution(self, commitment, comm_key, params, writer):
        self.pok_sig.challenge_contribution(params.g1, writer)
        self.sc.challenge_contribution(comm_key.g, comm_key.h, commitment,
                                       writer)

    def verify(self, commitment: Point, challenge: Fp,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams) -> bool:
        if not self.pok_sig.verify(challenge, params.bb_pk, params.g1,
                                   params.g2):
            return False
        # shared member response links signature and commitment
        if self.sc.response1 != self.pok_sig.get_resp_for_message():
            return False
        return self.sc.verify(commitment, comm_key.g, comm_key.h, challenge)


# ---------------------------------------------------------------------------
# Batch members (`batch_members.rs`)
# ---------------------------------------------------------------------------

@dataclass
class SetMembershipBatchCheckProtocol:
    members: list
    r: list
    v: list
    V: list
    a: list
    D: list
    m: list
    s: list
    t: list

    @classmethod
    def init(cls, rng, members: list, r: list,
             comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams, device="cuda"):
        if len(members) != len(r):
            raise SmcError("members/randomness length mismatch")
        n = len(members)
        v = [F.rand_nonzero(rng) for _ in range(n)]
        V = [(params.get_sig(members[i]).A * int(v[i])).normalize()
             for i in range(n)]
        m = [F.rand(rng) for _ in range(n)]
        s = [F.rand(rng) for _ in range(n)]
        t = [F.rand(rng) for _ in range(n)]
        D = [comm_key.commit(s[i], m[i]) for i in range(n)]
        a = digit_commitments(V, s, t, params, device)
        return cls(members=list(members), r=list(r), v=v, V=V, a=a, D=D,
                   m=m, s=s, t=t)

    def challenge_contribution(self, commitments: list,
                               comm_key: MemberCommitmentKey,
                               params: SetMembershipCheckParams,
                               writer: ByteWriter):
        _batch_contribution(self.V, self.a, self.D, commitments, comm_key,
                            params, writer)

    def gen_proof(self, challenge: Fp) -> "SetMembershipBatchCheckProof":
        n = len(self.V)
        return SetMembershipBatchCheckProof(
            V=self.V, a=self.a, D=self.D,
            z_v=[self.t[i] + self.v[i] * challenge for i in range(n)],
            z_sigma=[self.s[i] + self.members[i] * challenge
                     for i in range(n)],
            z_r=[self.m[i] + self.r[i] * challenge for i in range(n)])


def _batch_contribution(V, a, D, commitments, comm_key, params,
                        writer: ByteWriter):
    writer.point(params.g1)
    writer.point(params.g2)
    writer.point(params.bb_pk.w)
    writer.point(comm_key.g)
    writer.point(comm_key.h)
    writer.points(commitments)
    writer.points(V)
    for ai in a:
        writer.write(ai.to_bytes_le())
    writer.points(D)


@dataclass
class SetMembershipBatchCheckProof:
    V: list
    a: list
    D: list
    z_v: list
    z_sigma: list
    z_r: list

    def challenge_contribution(self, commitments, comm_key, params, writer):
        _batch_contribution(self.V, self.a, self.D, commitments, comm_key,
                            params, writer)

    def verify(self, commitments: list, challenge: Fp,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams, device="cuda") -> bool:
        n = len(commitments)
        if not (len(self.V) == len(self.a) == len(self.D) == len(self.z_v)
                == len(self.z_sigma) == len(self.z_r) == n):
            return False
        for i in range(n):
            lhs = (comm_key.commit(self.z_sigma[i], self.z_r[i])
                   - commitments[i] * int(challenge)).normalize()
            if lhs != self.D[i]:
                return False
        return check_digits(self.V, self.z_sigma, self.z_v, self.a,
                            challenge, params, device=device)


# ---------------------------------------------------------------------------
# Keyed-verification single member (`kv_single.rs`)
# ---------------------------------------------------------------------------

@dataclass
class SetMembershipCheckWithKVProtocol:
    pok_sig: PoKWeakBBSigKVProtocol
    sc: PokPedersenCommitmentProtocol

    @classmethod
    def init(cls, rng, member: Fp, r: Fp, comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParamsKV):
        sig = params.get_sig(member)
        blinding = F.rand(rng)
        pok_sig = PoKWeakBBSigKVProtocol.init(rng, sig, member, params.g1,
                                              blinding=blinding)
        sc = PokPedersenCommitmentProtocol.init(
            member, blinding, comm_key.g, r, F.rand(rng), comm_key.h)
        return cls(pok_sig=pok_sig, sc=sc)

    def challenge_contribution(self, commitment, comm_key, params, writer):
        self.pok_sig.challenge_contribution(params.g1, writer)
        self.sc.challenge_contribution(comm_key.g, comm_key.h, commitment,
                                       writer)

    def gen_proof(self, challenge: Fp) -> "SetMembershipCheckWithKVProof":
        return SetMembershipCheckWithKVProof(
            pok_sig=self.pok_sig.gen_proof(challenge),
            sc=self.sc.gen_proof(challenge))


@dataclass
class SetMembershipCheckWithKVProof:
    pok_sig: PoKWeakBBSigKV
    sc: PokPedersenCommitment

    def challenge_contribution(self, commitment, comm_key, params, writer):
        self.pok_sig.challenge_contribution(params.g1, writer)
        self.sc.challenge_contribution(comm_key.g, comm_key.h, commitment,
                                       writer)

    def verify(self, commitment: Point, challenge: Fp,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParamsKV,
               secret_key: WeakBBSecretKey) -> bool:
        if not self.pok_sig.verify(challenge, secret_key, params.g1):
            return False
        if self.sc.response1 != self.pok_sig.response_for_message():
            return False
        return self.sc.verify(commitment, comm_key.g, comm_key.h, challenge)
