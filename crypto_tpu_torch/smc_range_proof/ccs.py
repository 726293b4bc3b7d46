"""Set-membership and range proofs from BB-signature "digit certificates":
the port's own copy of `crypto_tpu/smc_range_proof/ccs.py` (reference
`smc_range_proof/src/{ccs_set_membership,ccs_range_proof}/`, paper CCS08
"Efficient Protocols for Set Membership and Range Proofs").

Setup: verifier-side issuer creates weak-BB signatures A_sigma = 1/(x+sigma)*g1
for every set member (or digit 0..base-1 for range proofs).

Membership PoK of committed value sigma (commitment C = g*sigma + h*r):
  V = A_sigma * v;  a = e(V, g2)*s - e(g1,g2)*t;  D = g*s' + h*m
  z_v = t + v*c, z_sigma = s + sigma*c, z_r = m + r*c
  checks:  g*z_sigma + h*z_r - C*c == D
           e(V, y*c + g2*z_sigma) == a + e(g1,g2)*z_v

Perfect range [0, base^l): value decomposed into l base-`base` digits, one
randomized digit signature V_i per digit, one shared D over the weighted
commitment key (g*base^i), same two checks per digit
(`perfect_range.rs:50-245`).

The pairings, on `device` (CUDA unless the caller names the CPU):
* the prover's a = e(V s, g2) e(g1, g2)^-t is the single pairing
  e(V s - g1 t, g2) (bilinearity: the same value as the reference's
  pairing and GT power); every digit's goes into one
  `curves.tpairing.multi_pairings_routed` call, a group of one pair a
  digit, which the router sends to the card or the host;
* the verifier's e(V, y c + g2 z_sigma) == a e(g1, g2)^z_v is checked as
  e(V c, y) e(V z_sigma - g1 z_v, g2) == a: two pairs and the GT target
  a a digit, no GT power.  With a `RandomizedPairingChecker` each digit
  defers there (`add_multiple_sources_and_target`); without one, every
  digit's product is one routed call and each is held to its a.  The
  reference stops at the first bad digit; the verdict is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, group_elem_from_try_and_incr)
from ..serialize import ByteWriter
from ..short_group_sig.weak_bb import (WeakBBSecretKey, WeakBBPublicKeyG2,
                                       WeakBBSig)
from ..utils.msm import msm

F = bls.Fr


class SmcError(Exception):
    pass


@dataclass
class MemberCommitmentKey:
    g: Point
    h: Point

    @classmethod
    def new(cls, label: bytes, digest=blake2b512):
        return cls(
            g=group_elem_from_try_and_incr(
                bls.G1, concat_slices(label, b" : G"), digest).normalize(),
            h=group_elem_from_try_and_incr(
                bls.G1, concat_slices(label, b" : H"), digest).normalize())

    def commit(self, value: Fp, randomness: Fp) -> Point:
        return (self.g * int(value) + self.h * int(randomness)).normalize()

    def commit_decomposed(self, base: int, digits, randomness: Fp) -> Point:
        acc = F(0)
        w = F(1)
        for d in digits:
            acc = acc + w * d
            w = w * F(base)
        return (self.g * int(acc) + self.h * int(randomness)).normalize()


@dataclass
class SetMembershipCheckParams:
    g1: Point
    g2: Point
    bb_pk: WeakBBPublicKeyG2
    set_members: list
    sigs: dict  # int(member) -> WeakBBSig

    @classmethod
    def new(cls, rng, label: bytes, members, digest=blake2b512):
        g1 = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : g1"), digest).normalize()
        g2 = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : g2"), digest).normalize()
        sk = WeakBBSecretKey.generate(rng)
        pk = WeakBBPublicKeyG2.generate(sk, g2)
        sigs = {int(m): WeakBBSig.new(m, sk, g1) for m in members}
        return cls(g1=g1, g2=g2, bb_pk=pk, set_members=list(members),
                   sigs=sigs)

    @classmethod
    def new_for_range_proof(cls, rng, label: bytes, base: int):
        return cls.new(rng, label, [F(i) for i in range(base)])

    def get_sig(self, member: Fp) -> WeakBBSig:
        sig = self.sigs.get(int(member))
        if sig is None:
            raise SmcError("member not in set")
        return sig


def digit_commitments(V: list, s: list, t: list,
                      params: SetMembershipCheckParams, device="cuda") -> list:
    """[e(V_i s_i, g2) e(g1, g2)^-t_i] = [e(V_i s_i - g1 t_i, g2)]: one
    routed call, a group of one pair a digit."""
    return multi_pairings_routed(
        [[((Vi * int(si) + params.g1 * int(-ti)).normalize(), params.g2)]
         for Vi, si, ti in zip(V, s, t)], device)


def digit_pairs(V: Point, z_sigma: Fp, z_v: Fp, challenge: Fp,
                params: SetMembershipCheckParams) -> list:
    """The two pairs whose product a digit's a must equal:
    e(V, y c + g2 z_sigma) e(g1, g2)^-z_v = e(V c, y) e(V z_sigma - g1 z_v,
    g2)."""
    return [((V * int(challenge)).normalize(), params.bb_pk.w),
            ((V * int(z_sigma) + params.g1 * int(-z_v)).normalize(),
             params.g2)]


def check_digits(V: list, z_sigma: list, z_v: list, a: list, challenge: Fp,
                 params: SetMembershipCheckParams, pairing_checker=None,
                 device="cuda") -> bool:
    """Each digit's pairing equation: deferred into `pairing_checker` (its
    two pairs and the GT target a_i), else every digit's product in one
    routed call, each held to its a_i."""
    groups = [digit_pairs(Vi, zs, zv, challenge, params)
              for Vi, zs, zv in zip(V, z_sigma, z_v)]
    if pairing_checker is not None:
        for g, ai in zip(groups, a):
            pairing_checker.add_multiple_sources_and_target(
                [p for p, _ in g], [q for _, q in g], ai)
        return True
    return all(x == ai for x, ai in
               zip(multi_pairings_routed(groups, device), a))


@dataclass
class SetMembershipProtocol:
    V: Point
    a: object          # GT
    D: Point
    v: Fp
    s: Fp
    t: Fp
    m: Fp
    member: Fp
    r: Fp

    @classmethod
    def init(cls, rng, member: Fp, randomness: Fp,
             comm_key: MemberCommitmentKey, params: SetMembershipCheckParams,
             device="cuda"):
        sig = params.get_sig(member)
        v = F.rand_nonzero(rng)
        s, t, m = F.rand(rng), F.rand(rng), F.rand(rng)
        V = (sig.A * int(v)).normalize()
        a = digit_commitments([V], [s], [t], params, device)[0]
        D = comm_key.commit(s, m)
        return cls(V=V, a=a, D=D, v=v, s=s, t=t, m=m, member=member,
                   r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _smc_contribution(self.V, self.a, self.D, commitment, comm_key,
                          params, writer)

    def gen_proof(self, challenge: Fp) -> "SetMembershipProof":
        return SetMembershipProof(
            V=self.V, a=self.a, D=self.D,
            z_v=self.t + self.v * challenge,
            z_sigma=self.s + self.member * challenge,
            z_r=self.m + self.r * challenge)


def _smc_contribution(V, a, D, commitment, comm_key, params,
                      writer: ByteWriter):
    writer.point(params.g1)
    writer.point(params.g2)
    writer.point(params.bb_pk.w)
    writer.point(comm_key.g)
    writer.point(comm_key.h)
    writer.point(commitment)
    if isinstance(V, list):
        writer.points(V)
    else:
        writer.point(V)
    for ai in (a if isinstance(a, list) else [a]):
        writer.write(ai.to_bytes_le())
    writer.point(D)


@dataclass
class SetMembershipProof:
    V: Point
    a: object
    D: Point
    z_v: Fp
    z_sigma: Fp
    z_r: Fp

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _smc_contribution(self.V, self.a, self.D, commitment, comm_key,
                          params, writer)

    def verify(self, commitment: Point, challenge: Fp,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams, device="cuda") -> bool:
        lhs = (comm_key.g * int(self.z_sigma) + comm_key.h * int(self.z_r)
               - commitment * int(challenge)).normalize()
        if lhs != self.D:
            return False
        return check_digits([self.V], [self.z_sigma], [self.z_v], [self.a],
                            challenge, params, device=device)


def base_n_digits_padded(value: int, base: int, l: int) -> list:
    digits = []
    v = value
    for _ in range(l):
        digits.append(F(v % base))
        v //= base
    if v:
        raise SmcError("value out of range")
    return digits


def find_l_for_perfect_range(max_val: int, base: int) -> int:
    l = 0
    m = 1
    while m < max_val:
        m *= base
        l += 1
    if m != max_val:
        raise SmcError("max must be a power of base")
    return l


@dataclass
class CCSPerfectRangeProtocol:
    base: int
    V: list
    a: list
    D: Point
    digits: list
    v: list
    s: list
    t: list
    m: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, max_val: int, base: int,
             comm_key: MemberCommitmentKey, params: SetMembershipCheckParams,
             device="cuda"):
        l = find_l_for_perfect_range(max_val, base)
        digits = base_n_digits_padded(value, base, l)
        m = F.rand(rng)
        s = [F.rand(rng) for _ in range(l)]
        t = [F.rand(rng) for _ in range(l)]
        v = [F.rand_nonzero(rng) for _ in range(l)]
        D = comm_key.commit_decomposed(base, s, m)
        V = [(params.get_sig(d).A * int(vi)).normalize()
             for d, vi in zip(digits, v)]
        a = digit_commitments(V, s, t, params, device)
        return cls(base=base, V=V, a=a, D=D, digits=digits, v=v, s=s, t=t,
                   m=m, r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _smc_contribution(self.V, self.a, self.D, commitment, comm_key,
                          params, writer)

    def gen_proof(self, challenge: Fp) -> "CCSPerfectRangeProof":
        l = len(self.V)
        return CCSPerfectRangeProof(
            base=self.base, V=self.V, a=self.a, D=self.D,
            z_v=[self.t[i] + self.v[i] * challenge for i in range(l)],
            z_sigma=[self.s[i] + self.digits[i] * challenge for i in range(l)],
            z_r=self.m + self.r * challenge)


@dataclass
class CCSPerfectRangeProof:
    base: int
    V: list
    a: list
    D: Point
    z_v: list
    z_sigma: list
    z_r: Fp

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _smc_contribution(self.V, self.a, self.D, commitment, comm_key,
                          params, writer)

    def verify(self, commitment: Point, challenge: Fp, max_val: int,
               comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        l = find_l_for_perfect_range(max_val, self.base)
        if len(self.V) != l:
            return False
        # commitment consistency over weighted digits
        lhs = (comm_key.commit_decomposed(self.base, self.z_sigma, self.z_r)
               - commitment * int(challenge)).normalize()
        if lhs != self.D:
            return False
        if len(self.a) != l or len(self.z_v) != l or len(self.z_sigma) != l:
            return False
        return check_digits(self.V, self.z_sigma, self.z_v, self.a,
                            challenge, params, pairing_checker, device)
