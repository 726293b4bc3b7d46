"""Weighted Norm Linear Argument, the recursive core of Bulletproofs++:
the port's own copy of `crypto_tpu/bulletproofs_pp/wnla.py` (reference
`bulletproofs_plus_plus/src/weighted_norm_linear_argument.rs`).  Host
code: the vectors are a range proof's digits long, and every MSM is the
host `utils/msm.py` `msm`.

Proves knowledge of vectors l, n with
    v = <c, l> + |n|^2_mu          (mu-weighted norm: sum mu^{i+1} n_i^2)
for a public commitment  C = v*G + <l, H_vec> + <n, G_vec>,
in O(log) rounds of even/odd halving.  Each round sends (X, R); a challenge
gamma folds vectors as
    l' = l_even + gamma*l_odd,  n' = n_even/rho + gamma*n_odd,
    h' = h_even + gamma*h_odd,  g' = g_even*rho + gamma*g_odd,
    C' = C + X*gamma + R*(gamma^2 - 1),  rho' = mu, mu' = mu^2.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, concat_slices, group_elem_from_try_and_incr, n_group_elements
from ..transcript.transcript import Transcript
from ..utils.msm import msm

F = bls.Fr


class BppError(Exception):
    pass


@dataclass
class BppSetupParams:
    """G (commitment base), G_vec (for n), H_vec (for l)
    (reference `setup.rs:1-117`)."""
    G: Point
    G_vec: list
    H_vec: list

    @classmethod
    def new(cls, label: bytes, g_count: int, h_count: int, digest=blake2b512,
            curve=None):
        curve = curve or bls.G1
        G = group_elem_from_try_and_incr(
            curve, concat_slices(label, b" : G"), digest).normalize()
        G_vec = [p.normalize() for p in n_group_elements(
            curve, 0, g_count, concat_slices(label, b" : G_"), digest)]
        H_vec = [p.normalize() for p in n_group_elements(
            curve, 0, h_count, concat_slices(label, b" : H_"), digest)]
        return cls(G=G, G_vec=G_vec, H_vec=H_vec)

    @property
    def scalar_field(self):
        return self.G.curve.scalar_field


def weighted_norm(n, mu: Fp) -> Fp:
    """|n|^2_mu = sum mu^{i+1} * n_i^2."""
    acc = mu.f(0)
    w = mu
    for x in n:
        acc = acc + w * x * x
        w = w * mu
    return acc


def inner_product(a, b, zero: Fp = None) -> Fp:
    """<a, b> truncated to the shorter; `zero` supplies the field's zero
    when both vectors may be empty (during uneven folding rounds)."""
    if a:
        acc = a[0].f(0)
    elif b:
        acc = b[0].f(0)
    elif zero is not None:
        acc = zero
    else:
        raise BppError("empty inner product")
    for x, y in zip(a, b):
        acc = acc + x * y
    return acc


def weighted_inner_product(a, b, mu: Fp) -> Fp:
    acc = mu.f(0)
    w = mu
    for x, y in zip(a, b):
        acc = acc + w * x * y
        w = w * mu
    return acc


def commit(params: BppSetupParams, v: Fp, l, n) -> Point:
    bases = [params.G] + params.H_vec[:len(l)] + params.G_vec[:len(n)]
    scalars = [v] + list(l) + list(n)
    return msm(bases, scalars).normalize()


def _split(vec):
    return vec[0::2], vec[1::2]


@dataclass
class WeightedNormLinearArgument:
    X: list
    R: list
    l: list
    n: list

    @classmethod
    def new(cls, l, n, c, rho: Fp, params: BppSetupParams,
            transcript: Transcript) -> "WeightedNormLinearArgument":
        if len(l) != len(c) or len(c) != len(params.H_vec):
            raise BppError("l/c/H_vec length mismatch")
        if len(n) & (len(n) - 1):
            raise BppError("n length must be a power of two")
        F = rho.f
        l, n, c = list(l), list(n), list(c)
        g_vec, h_vec = list(params.G_vec), list(params.H_vec)
        g = params.G
        mu = rho * rho
        Xs, Rs = [], []
        while len(l) > 1 or len(n) > 1:
            l0, l1 = _split(l)
            n0, n1 = _split(n)
            c0, c1 = _split(c)
            g0, g1 = _split(g_vec)
            h0, h1 = _split(h_vec)
            rho_inv = rho.inverse()
            mu_sqr = mu * mu

            zero = mu.f(0)
            v_x = (rho_inv + rho_inv) * weighted_inner_product(n0, n1, mu_sqr) \
                + inner_product(c0, l1, zero) + inner_product(c1, l0, zero)
            v_r = weighted_norm(n1, mu_sqr) + inner_product(c1, l1, zero)

            sn0 = [x * rho_inv for x in n0]
            sn1 = [x * rho for x in n1]

            bases = [g] + h0[:len(l1)] + h1[:len(l0)] + g0[:len(sn1)] + g1[:len(sn0)]
            scalars = [v_x] + l1[:len(h0)] + l0[:len(h1)] + sn1[:len(g0)] + sn0[:len(g1)]
            X_i = msm(bases, scalars).normalize()

            bases = [g] + h1[:len(l1)] + g1[:len(n1)]
            scalars = [v_r] + l1[:len(h1)] + n1[:len(g1)]
            R_i = msm(bases, scalars).normalize()

            transcript.append(b"X", X_i)
            transcript.append(b"R", R_i)
            gamma = transcript.challenge_scalar(F, b"gamma")

            if len(l) > 1:
                l = [a + gamma * b for a, b in zip(l0, l1)]
                c = [a + gamma * b for a, b in zip(c0, c1)]
                h_vec = [(a + b * int(gamma)).normalize()
                         for a, b in zip(h0, h1)]
            if len(n) > 1:
                n = [a * rho_inv + gamma * b for a, b in zip(n0, n1)]
                g_vec = [(a * int(rho) + b * int(gamma)).normalize()
                         for a, b in zip(g0, g1)]
            rho = mu
            mu = mu_sqr
            Xs.append(X_i)
            Rs.append(R_i)
        return cls(X=Xs, R=Rs, l=l, n=n)

    def verify(self, c, rho: Fp, commitment: Point, params: BppSetupParams,
               transcript: Transcript) -> bool:
        """Recursive verification (folds bases and commitment per round,
        reference `verify_recursively`)."""
        F = rho.f
        c = list(c)
        g_vec, h_vec = list(params.G_vec), list(params.H_vec)
        if len(c) != len(h_vec):
            return False
        if len(self.X) != len(self.R):
            return False
        mu = rho * rho
        # the |n|^2 weight advances only when n actually folds; with
        # len(H_vec) > len(G_vec) the last rounds fold l alone and the weight
        # must stay frozen (reference `get_bases_and_scalars_for_reduced_
        # commitment`: mu squared log2(G_vec.len()) times, not once per round)
        n_weight = rho * rho
        com = commitment
        for X_i, R_i in zip(self.X, self.R):
            transcript.append(b"X", X_i)
            transcript.append(b"R", R_i)
            gamma = transcript.challenge_scalar(F, b"gamma")
            if len(c) > 1:  # mirrors the prover's len(l) > 1 condition
                c0, c1 = _split(c)
                h0, h1 = _split(h_vec)
                c = [a + gamma * b for a, b in zip(c0, c1)]
                h_vec = [(a + b * int(gamma)).normalize()
                         for a, b in zip(h0, h1)]
            if len(g_vec) > 1:  # mirrors the prover's len(n) > 1 condition
                g0, g1 = _split(g_vec)
                g_vec = [(a * int(rho) + b * int(gamma)).normalize()
                         for a, b in zip(g0, g1)]
                n_weight = n_weight * n_weight
            com = (com + X_i * int(gamma)
                   + R_i * int(gamma * gamma - F(1))).normalize()
            rho = mu
            mu = mu * mu
        # final: com == G*v + h*l + g*n with v = <c,l> + |n|^2_{n_weight}
        v = inner_product(c, self.l) + weighted_norm(self.n, n_weight)
        bases = [params.G] + h_vec[:len(self.l)] + g_vec[:len(self.n)]
        scalars = [v] + self.l + self.n
        return msm(bases, scalars) == com
