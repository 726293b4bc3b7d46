"""Bulletproofs++ perfect-range proof via the reciprocal argument: the
port's own copy of `crypto_tpu/bulletproofs_pp/range_proof.py` (reference
`bulletproofs_plus_plus/src/range_proof.rs`).

Proves v in [0, base^num_digits) for Pedersen-committed values
V_i = v_i*G + gamma_i*H_vec[0], batched over many values with one shared
multiplicity vector (`range_proof.rs:246-257`).  The protocol commits to:

  round 1: D = r_d0*G + <H,r_d1> + <G_vec,d>   (digit vector d)
           M = r_m0*G + <H,r_m1> + <G_vec,m>   (multiplicity vector m)
  round 2: R = r_r0*G + <H,r_r1> + <G_vec,r>   (reciprocals r_i = 1/(e+d_i))
  round 3: S                                   (masking vector s + T-poly
                                                balancing terms l_s)
  round 4: a WeightedNormLinearArgument on the evaluations of the vector
           polynomials w(T), l(T) at challenge t, proving
           v = <c, l> + |n|^2_q  for C = S/t + delta*M + t*D + t^2*R
                                      + 2t^3*<V,lambda_pows> + P(public).

Three constraints are folded into the single norm relation with challenges
(x, y, q=r^2, lambda, delta):  sum-value (v = <d, base_pows>), reciprocal
(r_i*(e+d_i) = 1) and range-check (<m, 1/(e+j)> = <r, 1>); see the long
comment block at `range_proof.rs:300-470`.  The T-power balancing
constraints (r_m1[6]=r_m1[3]=0, r_r1[4]=-r_d1[5], r_r1[1]=-r_d1[2]) keep
the uncancellable T^3/T^7 blinding terms out of the verification equation
(`range_proof.rs:292-303,447-453`).

Host-side protocol logic (vectors are ~num_digits long); the generator
setup and verifier MSM use the shared Pippenger in `utils/msm.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..transcript.transcript import Transcript
from ..utils.ff import hadamard_product, powers, powers_starting_from, scale
from ..utils.msm import msm
from .wnla import BppError, BppSetupParams, WeightedNormLinearArgument

F = bls.Fr


def base_bits(base: int) -> int:
    """Number of bits in `base` (power of two), reference `util.rs:2-4`."""
    return base.bit_length() - 1


def _inner(a, b) -> Fp:
    """Truncating inner product (reference `ff.rs:21-26`)."""
    acc = a[0].f(0)
    for x, y in zip(a, b):
        acc = acc + x * y
    return acc


def _add_padded(a, b):
    """Element-wise sum padded to max length (reference `ff.rs:37-47`)."""
    zero = (a if a else b)[0].f(0)
    n = max(len(a), len(b))
    return [(a[i] if i < len(a) else zero) + (b[i] if i < len(b) else zero)
            for i in range(n)]


class SetupParams(BppSetupParams):
    """BP++ generators; H_vec is always length 8 (the l-vector slots)."""

    @classmethod
    def new_for_perfect_range_proof(cls, label: bytes, base: int,
                                    num_value_bits: int, num_proofs: int,
                                    curve=None):
        g_count = max(num_value_bits // base_bits(base), base) * num_proofs
        return cls.new(label, g_count, 8, curve=curve)

    def compute_pedersen_commitment(self, v: int, gamma: Fp) -> Point:
        return (self.G * int(gamma.f(v))
                + self.H_vec[0] * int(gamma)).normalize()

    def compute_commitment(self, v: Fp, l, n) -> Point:
        """v*G + <G_vec, n> + <H_vec, l> (reference `setup.rs:76-96`)."""
        bases = [self.G] + self.G_vec[:len(n)] + self.H_vec[:len(l)]
        scalars = [v] + list(n) + list(l)
        return msm(bases, scalars).normalize()


class TPowers:
    """(t^-1, 1, t, ..., t^{n-1}) with signed indexing."""

    def __init__(self, t: Fp, n: int):
        self.v = powers_starting_from(t.inverse(), t, n + 1)

    def nth(self, i: int) -> Fp:
        return self.v[i + 1]


def t_pow_in_c(i: int) -> int:
    """Power-of-T offset of l-slot i in the c polynomial
    (`range_proof.rs` `t_pow_in_c`): slot 0 is the G coordinate (constant 1,
    T^0 -> offset 1); slots 1.. are H_vec with c entries y*t^{-1,1,2,3,5,6,7}."""
    return {0: 1, 1: 0, 2: 2, 3: 3, 4: 4, 5: 6, 6: 7, 7: 8, 8: 9}[i]


def c_poly_consts(y: Fp):
    """Scalar part of the c polynomial per l-slot."""
    return [y.f(1), y, y, y, y, y, y, y, y.f(0)]


def create_c_vec(y: Fp, tp: TPowers):
    """c vector handed to the norm argument at challenge t."""
    return [y * tp.nth(-1), y * tp.nth(1), y * tp.nth(2), y * tp.nth(3),
            y * tp.nth(5), y * tp.nth(6), y * tp.nth(7), y.f(0)]


class Poly:
    """Vector-valued Laurent polynomial in T; coeffs[j] is the coefficient
    vector of T^{j-1} (`range_proof.rs` `struct Poly`)."""

    def __init__(self, coeffs):
        self.coeffs = coeffs

    def eval_given_t_powers(self, tp: TPowers):
        res = [tp.v[0].f(0)] * len(self.coeffs[0])
        for j, cv in enumerate(self.coeffs):
            tj = tp.nth(j - 1)
            for i, c in enumerate(cv):
                res[i] = res[i] + tj * c
        return res

    def w_q_norm(self, q: Fp):
        """q-weighted self inner product; entry k is the T^{k-2} coefficient
        of |w(T)|^2_q (weights q^{k+1} per vector slot)."""
        deg = len(self.coeffs)
        res = [q.f(0)] * (2 * deg - 1)
        max_len = max(len(c) for c in self.coeffs)
        q_powers = powers_starting_from(q, q, max(max_len, 1))
        for i in range(deg):
            for j in range(deg):
                a, b = self.coeffs[i], self.coeffs[j]
                acc = q.f(0)
                for k in range(min(len(a), len(b))):
                    acc = acc + a[k] * b[k] * q_powers[k]
                res[i + j] = res[i + j] + acc
        return res

    def multiply_with_poly_of_constants(self, consts):
        """<c(T), l(T)> where c is the per-slot constant poly with T powers
        given by `t_pow_in_c`; entry k is the T^{k-2} coefficient."""
        res = [consts[0].f(0)] * (len(self.coeffs) + len(consts))
        for l, lv in enumerate(self.coeffs):
            for i in range(len(lv)):
                off = t_pow_in_c(i)
                if off >= len(consts):
                    continue
                res[l + off] = res[l + off] + lv[i] * consts[i]
        return res


# -- alpha vectors (public parts folded into the norm relation) --

def alpha_d(base: int, num_digits_per_proof: int, lambda_powers):
    """(1,b,..,b^{m-1}, lam, lam*b, ..., lam^{p-1}*b^{m-1})."""
    base_powers = powers(lambda_powers[0].f(base), num_digits_per_proof)
    out = []
    for lp in lambda_powers:
        out.extend(scale(base_powers, lp))
    return out


def alpha_m(e: Fp, x: Fp, n: int):
    """x/(e+j) for j in 0..base."""
    return [x * (e + e.f(j)).inverse() for j in range(n)]


def alpha_r(n: int, x: Fp, delta: Fp):
    return [-(x * delta)] * n


def alpha_r2(n: int, e: Fp):
    return [e] * n


@dataclass
class Round1Commitments:
    D: Point
    M: Point

    def challenge(self, base: int, num_bits: int, V, transcript: Transcript,
                  field=None):
        field = field or V[0].curve.scalar_field
        transcript.append_message(b"base", base.to_bytes(2, "little"))
        transcript.append_message(b"num_bits", num_bits.to_bytes(2, "little"))
        for V_i in V:
            transcript.append(b"V", V_i)
        transcript.append(b"D", self.D)
        transcript.append(b"M", self.M)
        return transcript.challenge_scalar(field, b"e")


@dataclass
class Round2Commitments:
    R: Point

    def challenges(self, transcript: Transcript, field=None):
        field = field or self.R.curve.scalar_field
        transcript.append(b"R", self.R)
        x = transcript.challenge_scalar(field, b"x")
        y = transcript.challenge_scalar(field, b"y")
        r = transcript.challenge_scalar(field, b"r")
        lam = transcript.challenge_scalar(field, b"lambda")
        delta = transcript.challenge_scalar(field, b"delta")
        return x, y, r, r * r, lam, delta


@dataclass
class Round3Commitments:
    S: Point

    def challenge(self, transcript: Transcript, field=None):
        field = field or self.S.curve.scalar_field
        transcript.append(b"S", self.S)
        return transcript.challenge_scalar(field, b"t")


class Prover:
    """4-round prover; shared-multiplicity batching over `values`."""

    def __init__(self, base: int, num_bits: int, V: list, values: list,
                 gamma: list):
        if base & (base - 1) or base < 2:
            raise BppError("base must be a power of two")
        if num_bits & (num_bits - 1):
            raise BppError("num_bits must be a power of two")
        if num_bits < base_bits(base):
            raise BppError("num_bits smaller than digit size")
        if not (len(V) == len(values) == len(gamma)):
            raise BppError("V/values/gamma length mismatch")
        self.base, self.num_bits = base, num_bits
        self.V, self.values, self.gamma = V, values, gamma
        self.F = gamma[0].f

    @classmethod
    def new(cls, num_bits: int, V: list, values: list, gamma: list):
        return cls(2, num_bits, V, values, gamma)

    @property
    def num_digits_per_proof(self) -> int:
        return self.num_bits // base_bits(self.base)

    @property
    def total_num_digits(self) -> int:
        return self.num_digits_per_proof * len(self.V)

    def prove(self, rng, params: SetupParams,
              transcript: Transcript) -> "Proof":
        r1c = self._round_1(rng, params)
        e = r1c.challenge(self.base, self.num_bits, self.V, transcript)
        r2c = self._round_2(rng, e, params)
        x, y, r, q, lam, delta = r2c.challenges(transcript)
        r3c = self._round_3(rng, x, y, q, e, lam, delta, params)
        t = r3c.challenge(transcript)
        return self._round_4(r1c, r2c, r3c, y, t, r, params, transcript)

    def _round_1(self, rng, params: SetupParams) -> Round1Commitments:
        nbb = base_bits(self.base)
        mask = (1 << nbb) - 1
        d, m = [], [0] * self.base
        for v in self.values:
            if v < 0 or v >> self.num_bits:
                raise BppError("value out of range")
            for _ in range(self.num_digits_per_proof):
                dig = v & mask
                d.append(dig)
                m[dig] += 1
                v >>= nbb
        F = self.F
        d = [F(x) for x in d]
        m = [F(x) for x in m]

        r_m1 = [F.rand(rng) for _ in range(8)]
        r_d1 = [F(0)] * 8
        # balancing: uncancellable T^7 and T^3 blinding terms must vanish
        r_m1[6] = F(0)
        r_d1[5] = F.rand(rng)
        r_m1[3] = F(0)
        r_d1[2] = F.rand(rng)

        r_d0, r_m0 = F.rand(rng), F.rand(rng)
        D = params.compute_commitment(r_d0, r_d1, d)
        M = params.compute_commitment(r_m0, r_m1, m)
        self._d, self._m = d, m
        self._r_d0, self._r_d1, self._r_m0, self._r_m1 = r_d0, r_d1, r_m0, r_m1
        return Round1Commitments(D=D, M=M)

    def _round_2(self, rng, e: Fp, params: SetupParams) -> Round2Commitments:
        r_vec = [(e + x).inverse() for x in self._d]
        r_r1 = [self.F(0)] * 8
        r_r1[4] = -self._r_d1[5]   # cancels the T^7 cross term
        r_r1[1] = -self._r_d1[2]   # cancels the T^3 cross term
        r_r0 = self.F.rand(rng)
        R = params.compute_commitment(r_r0, r_r1, r_vec)
        self._r_vec, self._r_r0, self._r_r1 = r_vec, r_r0, r_r1
        return Round2Commitments(R=R)

    def _round_3(self, rng, x, y, q, e, lam, delta,
                 params: SetupParams) -> Round3Commitments:
        F = self.F
        d = self._d
        m = scale(self._m, delta)
        r_vec = self._r_vec
        g_len = len(params.G_vec)
        q_inv = q.inverse()
        q_inv_pows = powers_starting_from(q_inv, q_inv, g_len)

        a_r = _add_padded(
            hadamard_product(alpha_r(self.total_num_digits, x, delta),
                             q_inv_pows),
            alpha_r2(self.total_num_digits, e))
        lambda_powers = powers(lam, len(self.V))
        a_d = hadamard_product(
            alpha_d(self.base, self.num_digits_per_proof, lambda_powers),
            q_inv_pows)
        a_m = hadamard_product(alpha_m(e, x, self.base), q_inv_pows)

        t_2 = _add_padded(d, a_r)
        t_3 = _add_padded(r_vec, a_d)
        s = [F.rand(rng) for _ in range(g_len)]
        w_poly = Poly([s, m, t_2, t_3, a_m])
        w_w_q = w_poly.w_q_norm(q)   # T^-2 .. T^6

        y_inv = y.inverse()
        consts = c_poly_consts(y)

        # gamma_v = <gamma, (2, 2lam, 2lam^2, ...)>
        dbl_lam = powers_starting_from(F(2), lam, len(self.gamma))
        gamma_v = _inner(self.gamma, dbl_lam)

        lm1 = scale([-self._r_m0] + self._r_m1, delta)
        ld1 = [-self._r_d0] + self._r_d1
        lr1 = [-self._r_r0] + self._r_r1
        l_poly = Poly([[], lm1, ld1, lr1, [F(0), gamma_v], [], [], []])
        l_w = l_poly.multiply_with_poly_of_constants(consts)

        # blinding l_s cancels every T power of v(T) except T^3 (the value,
        # supplied by the verifier via 2t^3*V) and T^-1 (put on G as -b_s)
        l_s = [-(w_w_q[i] + l_w[i]) for i in range(len(params.H_vec) + 1)]
        l_s.pop(5)            # T^3: handled by 2t^3*<V, lambda_powers>
        b_s = l_s.pop(1)      # T^-1: carried on the G coordinate of S
        l_s.append(F(0))
        l_s = scale(l_s, y_inv)

        S = params.compute_commitment(-b_s, l_s, s)
        l_poly.coeffs[0] = l_s
        for j in (1, 2, 3, 4):
            l_poly.coeffs[j] = l_poly.coeffs[j][1:]   # drop the G slot
        self._w_poly, self._l_poly = w_poly, l_poly
        return Round3Commitments(S=S)

    def _round_4(self, r1c, r2c, r3c, y, t, r, params: SetupParams,
                 transcript: Transcript) -> "Proof":
        tp = TPowers(t, len(params.H_vec))
        w_eval = self._w_poly.eval_given_t_powers(tp)
        l_eval = self._l_poly.eval_given_t_powers(tp)
        c_vec = create_c_vec(y, tp)
        norm = WeightedNormLinearArgument.new(
            l_eval, w_eval, c_vec, r, params, transcript)
        return Proof(base=self.base, r1_comm=r1c, r2_comm=r2c, r3_comm=r3c,
                     norm_proof=norm)


@dataclass
class Proof:
    base: int
    r1_comm: Round1Commitments
    r2_comm: Round2Commitments
    r3_comm: Round3Commitments
    norm_proof: WeightedNormLinearArgument

    def verify(self, num_bits: int, V: list, params: SetupParams,
               transcript: Transcript) -> bool:
        bb = base_bits(self.base)
        if num_bits < bb:
            return False
        num_digits_per_proof = num_bits // bb
        num_proofs = len(V)
        total = num_digits_per_proof * num_proofs

        e = self.r1_comm.challenge(self.base, num_bits, V, transcript)
        x, y, r, q, lam, delta = self.r2_comm.challenges(transcript)
        t = self.r3_comm.challenge(transcript)
        tp = TPowers(t, len(params.H_vec))
        c_vec = create_c_vec(y, tp)
        t_inv, t_sqr, t_cube = tp.nth(-1), tp.nth(2), tp.nth(3)

        g_len = len(params.G_vec)
        q_pows = powers_starting_from(q, q, g_len)
        q_inv_pows = [p.inverse() for p in q_pows]

        lambda_powers = powers(lam, num_proofs)
        a_d = alpha_d(self.base, num_digits_per_proof, lambda_powers)
        a_d_qi = hadamard_product(a_d, q_inv_pows)
        a_r2 = alpha_r2(total, e)
        a_r = alpha_r(total, x, delta)
        a_r_qi = _add_padded(hadamard_product(a_r, q_inv_pows), a_r2)

        # P's G coordinate: the public 2t^3 terms of the three constraints
        two_t3 = t_cube + t_cube
        v_hat_1 = _inner([two_t3] * total, q_pows)
        v_hat_2 = _inner(a_d, a_r2) * two_t3
        v_hat_3 = _inner(a_d_qi, a_r) * two_t3
        g_offset = v_hat_1 + v_hat_2 + v_hat_3

        # P's G_vec coordinates: alpha vectors at their w-poly T powers
        a_m_qi = hadamard_product(alpha_m(e, x, self.base), q_inv_pows)
        g_vec_pub = _add_padded(
            _add_padded(scale(a_d_qi, t_sqr), scale(a_r_qi, tp.nth(1))),
            scale(a_m_qi, t_cube))

        # C = 2t^3<V,lam> + S/t + delta*M + t*D + t^2*R + <G_vec,pub> + g_off*G
        bases = list(V) + [self.r3_comm.S, self.r1_comm.M, self.r1_comm.D,
                           self.r2_comm.R]
        scalars = scale(lambda_powers, two_t3) + [t_inv, delta, t, t_sqr]
        bases += params.G_vec[:len(g_vec_pub)]
        scalars += g_vec_pub
        bases.append(params.G)
        scalars.append(g_offset)
        C = msm(bases, scalars).normalize()

        return self.norm_proof.verify(c_vec, r, C, params, transcript)
