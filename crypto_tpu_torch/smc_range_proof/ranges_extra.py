"""Arbitrary-range variants of the BB-signature set-membership range
proofs, the port's own copy of `crypto_tpu/smc_range_proof/ranges_extra.py`:
CCS08 arbitrary range [min, max) (reference
`smc_range_proof/src/ccs_range_proof/arbitrary_range.rs`) and the CLS
sumset-decomposition range proof (reference
`smc_range_proof/src/cls_range_proof/{util,range_proof}.rs`).

CCS arbitrary range runs two digit decompositions per value: value-min and
value + base^l - max, sharing the commitment randomness; the commitment
checks offset by g*min*c and g*(base^l - max)*c.  CLS instead decomposes
value-min over the SUMSET boundaries G_i (so any value in the range has a
digit vector with digits < base and exact reconstruction), needing a
single decomposition — shorter proofs at the cost of the boundary math.

The digits' pairings run as in `ccs.py` (`digit_commitments`,
`check_digits`), on `device`: the prover's every digit (both
decompositions of the CCS range) in one routed call, the verifier's
deferred into a checker or in one routed call."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..serialize import ByteWriter
from .ccs import (MemberCommitmentKey, SetMembershipCheckParams, SmcError,
                  _smc_contribution, base_n_digits_padded, check_digits,
                  digit_commitments)

F = bls.Fr


def find_l_for_arbitrary_range(max_val: int, min_val: int,
                               base: int) -> int:
    diff = max_val - min_val
    l = 1
    while base ** l <= diff:
        l += 1
    return l


# ---------------------------------------------------------------------------
# CCS arbitrary range
# ---------------------------------------------------------------------------

@dataclass
class CCSArbitraryRangeProtocol:
    base: int
    V_min: list
    V_max: list
    a_min: list
    a_max: list
    D_min: Point
    D_max: Point
    digits_min: list
    digits_max: list
    v_min: list
    v_max: list
    s_min: list
    s_max: list
    t_min: list
    t_max: list
    m_min: Fp
    m_max: Fp
    r: Fp

    @classmethod
    def init(cls, rng, value: int, randomness: Fp, min_val: int,
             max_val: int, base: int, comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams, device="cuda"):
        if not (min_val <= value < max_val):
            raise SmcError("value out of claimed range")
        l = find_l_for_arbitrary_range(max_val, min_val, base)
        m_min, m_max = F.rand(rng), F.rand(rng)
        s_min = [F.rand(rng) for _ in range(l)]
        s_max = [F.rand(rng) for _ in range(l)]
        D_min = comm_key.commit_decomposed(base, s_min, m_min)
        D_max = comm_key.commit_decomposed(base, s_max, m_max)
        digits_min = base_n_digits_padded(value - min_val, base, l)
        digits_max = base_n_digits_padded(
            value + base ** l - max_val, base, l)
        t_min = [F.rand(rng) for _ in range(l)]
        t_max = [F.rand(rng) for _ in range(l)]
        v_min = [F.rand_nonzero(rng) for _ in range(l)]
        v_max = [F.rand_nonzero(rng) for _ in range(l)]
        V_min = [(params.get_sig(d).A * int(vi)).normalize()
                 for d, vi in zip(digits_min, v_min)]
        V_max = [(params.get_sig(d).A * int(vi)).normalize()
                 for d, vi in zip(digits_max, v_max)]
        a = digit_commitments(V_min + V_max, s_min + s_max, t_min + t_max,
                              params, device)
        a_min, a_max = a[:l], a[l:]
        return cls(base=base, V_min=V_min, V_max=V_max, a_min=a_min,
                   a_max=a_max, D_min=D_min, D_max=D_max,
                   digits_min=digits_min, digits_max=digits_max,
                   v_min=v_min, v_max=v_max, s_min=s_min, s_max=s_max,
                   t_min=t_min, t_max=t_max, m_min=m_min, m_max=m_max,
                   r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _ccs_arb_contribution(self.V_min, self.V_max, self.a_min,
                              self.a_max, self.D_min, self.D_max,
                              commitment, comm_key, params, writer)

    def gen_proof(self, challenge: Fp) -> "CCSArbitraryRangeProof":
        l = len(self.V_min)
        return CCSArbitraryRangeProof(
            base=self.base, V_min=self.V_min, V_max=self.V_max,
            a_min=self.a_min, a_max=self.a_max, D_min=self.D_min,
            D_max=self.D_max,
            z_v_min=[self.t_min[i] + self.v_min[i] * challenge
                     for i in range(l)],
            z_v_max=[self.t_max[i] + self.v_max[i] * challenge
                     for i in range(l)],
            z_sigma_min=[self.s_min[i] + self.digits_min[i] * challenge
                         for i in range(l)],
            z_sigma_max=[self.s_max[i] + self.digits_max[i] * challenge
                         for i in range(l)],
            z_r_min=self.m_min + self.r * challenge,
            z_r_max=self.m_max + self.r * challenge)


def _ccs_arb_contribution(V_min, V_max, a_min, a_max, D_min, D_max,
                          commitment, comm_key, params, writer: ByteWriter):
    writer.point(params.g1)
    writer.point(params.g2)
    writer.point(params.bb_pk.w)
    writer.point(comm_key.g)
    writer.point(comm_key.h)
    writer.point(commitment)
    writer.points(V_min)
    writer.points(V_max)
    for ai in a_min + a_max:
        writer.write(ai.to_bytes_le())
    writer.point(D_min)
    writer.point(D_max)


@dataclass
class CCSArbitraryRangeProof:
    base: int
    V_min: list
    V_max: list
    a_min: list
    a_max: list
    D_min: Point
    D_max: Point
    z_v_min: list
    z_v_max: list
    z_sigma_min: list
    z_sigma_max: list
    z_r_min: Fp
    z_r_max: Fp

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _ccs_arb_contribution(self.V_min, self.V_max, self.a_min,
                              self.a_max, self.D_min, self.D_max,
                              commitment, comm_key, params, writer)

    def verify(self, commitment: Point, challenge: Fp, min_val: int,
               max_val: int, comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        l = find_l_for_arbitrary_range(max_val, min_val, self.base)
        if any(len(x) != l for x in (
                self.V_min, self.V_max, self.a_min, self.a_max,
                self.z_v_min, self.z_v_max, self.z_sigma_min,
                self.z_sigma_max)):
            return False
        comm_c = commitment * int(challenge)
        # D_min = -C*c + g*min*c + commit(z_sigma_min, z_r_min)
        lhs = (comm_key.commit_decomposed(self.base, self.z_sigma_min,
                                          self.z_r_min)
               + comm_key.g * int(F(min_val) * challenge)
               - comm_c).normalize()
        if lhs != self.D_min:
            return False
        x = F(self.base ** l) - F(max_val)
        lhs = (comm_key.commit_decomposed(self.base, self.z_sigma_max,
                                          self.z_r_max)
               - comm_key.g * int(x * challenge) - comm_c).normalize()
        if lhs != self.D_max:
            return False
        return check_digits(self.V_min + self.V_max,
                            self.z_sigma_min + self.z_sigma_max,
                            self.z_v_min + self.z_v_max,
                            self.a_min + self.a_max, challenge, params,
                            pairing_checker, device)


# ---------------------------------------------------------------------------
# CLS sumset range proof
# ---------------------------------------------------------------------------

def get_range_and_randomness_multiple(base: int, min_val: int,
                                      max_val: int):
    range_ = max_val - min_val
    randomness_multiple = 1
    b_1 = base - 1
    if range_ % b_1 != 0:
        range_ = range_ * b_1
        randomness_multiple = b_1
    return range_, randomness_multiple


def find_number_of_digits(range_: int, base: int) -> int:
    l = 0
    while base ** l < range_ + 1:
        l += 1
    return max(l, 1)


def find_sumset_boundaries(range_: int, base: int, num: int) -> list:
    if base == 2:
        return [(range_ + (1 << i)) >> (i + 1) for i in range(num)]
    h = []
    v = range_
    for _ in range(num):
        h.append(v % base)
        v //= base
    g = []
    for i in range(num):
        h_hat = range_ // (base ** (i + 1))
        ssum = sum(h[:i])
        g.append(h_hat + (1 + h[i] + (ssum % (base - 1))) // base)
    return g


def decompose_for_sumset(value: int, G: list, base: int) -> list:
    out = [0] * len(G)
    target = value
    for i, g_i in enumerate(G):
        for u in range(base - 1, 0, -1):
            if target >= g_i * u:
                out[i] = u
                target -= g_i * u
                break
    if target != 0:
        raise SmcError("sumset decomposition failed")
    return out


def get_sumset_parameters(value: int, min_val: int, max_val: int,
                          base: int):
    range_, rmult = get_range_and_randomness_multiple(base, min_val,
                                                      max_val - 1)
    v = value - min_val
    if rmult != 1:
        v = v * (base - 1)
    l = find_number_of_digits(range_, base)
    G = find_sumset_boundaries(range_, base, l)
    digits = decompose_for_sumset(v, G, base)
    return l, G, rmult, digits


@dataclass
class CLSRangeProtocol:
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
    def init(cls, rng, value: int, randomness: Fp, min_val: int,
             max_val: int, base: int, comm_key: MemberCommitmentKey,
             params: SetMembershipCheckParams, device="cuda"):
        if not (min_val <= value < max_val):
            raise SmcError("value out of claimed range")
        l, G, rmult, digits = get_sumset_parameters(value, min_val, max_val,
                                                    base)
        m = F.rand(rng)
        s = [F.rand(rng) for _ in range(l)]
        G_f = [F(g) for g in G]
        ip = F(0)
        for si, gi in zip(s, G_f):
            ip = ip + si * gi
        D = comm_key.commit(ip, m * F(rmult))
        digits_f = [F(d) for d in digits]
        t = [F.rand(rng) for _ in range(l)]
        v = [F.rand_nonzero(rng) for _ in range(l)]
        V = [(params.get_sig(d).A * int(vi)).normalize()
             for d, vi in zip(digits_f, v)]
        a = digit_commitments(V, s, t, params, device)
        return cls(base=base, V=V, a=a, D=D, digits=digits_f, v=v, s=s,
                   t=t, m=m, r=randomness)

    def challenge_contribution(self, commitment, comm_key, params,
                               writer: ByteWriter):
        _smc_contribution(self.V, self.a, self.D, commitment, comm_key,
                          params, writer)

    def gen_proof(self, challenge: Fp) -> "CLSRangeProof":
        l = len(self.V)
        return CLSRangeProof(
            base=self.base, V=self.V, a=self.a, D=self.D,
            z_v=[self.t[i] + self.v[i] * challenge for i in range(l)],
            z_sigma=[self.s[i] + self.digits[i] * challenge
                     for i in range(l)],
            z_r=self.m + self.r * challenge)


@dataclass
class CLSRangeProof:
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

    def verify(self, commitment: Point, challenge: Fp, min_val: int,
               max_val: int, comm_key: MemberCommitmentKey,
               params: SetMembershipCheckParams,
               pairing_checker=None, device="cuda") -> bool:
        range_, rmult = get_range_and_randomness_multiple(
            self.base, min_val, max_val - 1)
        l = find_number_of_digits(range_, self.base)
        G = find_sumset_boundaries(range_, self.base, l)
        if any(len(x) != l for x in (self.V, self.a, self.z_v,
                                     self.z_sigma)):
            return False
        ip = F(0)
        for zi, gi in zip(self.z_sigma, G):
            ip = ip + zi * F(gi)
        lhs = (comm_key.commit(ip, F(rmult) * self.z_r)
               + comm_key.g * int(F(min_val * rmult) * challenge)
               - commitment * int(F(rmult) * challenge)).normalize()
        if lhs != self.D:
            return False
        return check_digits(self.V, self.z_sigma, self.z_v, self.a,
                            challenge, params, pairing_checker, device)
