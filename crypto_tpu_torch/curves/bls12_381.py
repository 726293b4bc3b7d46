"""BLS12-381: fields, tower, G1/G2 and the optimal ate pairing (host).

The port's own copy of `crypto_tpu/curves/bls12_381.py` (standard
BLS12-381 constants, as in arkworks `ark-bls12-381`): Fq2 = Fq[u]/(u^2 +
1), Fq6 = Fq2[v]/(v^3 - (u + 1)), Fq12 = Fq6[w]/(w^2 - v), and G2 is the
M-type twist E'/Fq2: y^2 = x^3 + 4(u + 1).  The host pairing here is the
port's ground truth for the batched one (`curves/tpairing.py`).
"""

from __future__ import annotations

from ..fields.host import Field
from ..fields.tower import CubicOverQuad, Fp12, QuadExtField, QuadOverCubic
from .sw import Point, SWCurve

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624_1EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D805_53BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter (negative): p, r are polynomials in x
X = -0xD201000000010000

Fq = Field("bls12_381.Fq", P, generator=2)
Fr = Field("bls12_381.Fr", R, generator=7)

assert Fr.two_adicity == 32
assert R == X ** 4 - X ** 2 + 1
assert P == (X - 1) ** 2 * (X ** 4 - X ** 2 + 1) // 3 + X

Fq2 = QuadExtField(Fq, Fq(P - 1), "bls12_381.Fq2")       # u^2 = -1
XI = Fq2(Fq(1), Fq(1))                                    # xi = u + 1
Fq6 = CubicOverQuad(Fq2, XI, "bls12_381.Fq6")             # v^3 = xi
Fq12 = QuadOverCubic(Fq6, "bls12_381.Fq12")               # w^2 = v

G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

G1 = SWCurve(
    "bls12_381.G1", Fq, Fq(0), Fq(4), Fr,
    cofactor=G1_COFACTOR,
    generator_xy=(
        Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
        Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    ),
)

G2 = SWCurve(
    "bls12_381.G2", Fq2, Fq2.zero(), XI.mul_base(4), Fr,
    cofactor=G2_COFACTOR,
    generator_xy=(
        Fq2(
            Fq(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8),
            Fq(0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
        ),
        Fq2(
            Fq(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801),
            Fq(0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
        ),
    ),
)

# ---------------------------------------------------------------------------
# Pairing: optimal ate.  e(P in G1, Q in G2) -> GT subset of Fq12
# ---------------------------------------------------------------------------

_X_ABS = -X
_X_BITS = bin(_X_ABS)[2:]  # MSB first

_TWO_INV = Fq(2).inverse()
_TWIST_B = XI.mul_base(4)  # b of the twist curve


class _HomG2:
    """Homogeneous projective G2 point used only inside the Miller loop."""
    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z


def _doubling_step(r: _HomG2):
    """Costello-Lange-Naehrig doubling step; returns M-twist line coeffs
    (c0, c1, c2) to be combined as f.mul_by_014(c0, c1*xP, c2*yP)."""
    a = (r.x * r.y).mul_base(_TWO_INV)
    b = r.y.square()
    c = r.z.square()
    e = _TWIST_B * (c + c + c)
    f = e + e + e
    g = (b + f).mul_base(_TWO_INV)
    h = (r.y + r.z).square() - (b + c)
    i = e - b
    j = r.x.square()
    e2 = e.square()
    r.x = a * (b - f)
    r.y = g.square() - (e2 + e2 + e2)
    r.z = b * h
    return (i, j + j + j, -h)


def _addition_step(r: _HomG2, qx, qy):
    theta = r.y - qy * r.z
    lam = r.x - qx * r.z
    c = theta.square()
    d = lam.square()
    e = lam * d
    f = r.z * c
    g = r.x * d
    h = e + f - (g + g)
    r.x = lam * h
    r.y = theta * (g - h) - e * r.y
    r.z = r.z * e
    j = theta * qx - lam * qy
    return (j, -theta, lam)


def _mul_by_014(f: Fp12, c0, c1, c4) -> Fp12:
    """f * (c0 + c1 v + c4 w) sparse multiplication — i.e. multiplier has
    Fq6 coords a = (c0, c1, 0), b = (c4-in-c1-slot): (0, c4, 0)."""
    fq6 = Fq6
    z = Fq2.zero()
    a = fq6(c0, c1, z)
    b = fq6(z, c4, z)
    # standard Karatsuba for Fp12 with sparse operands
    v0 = f.c0 * a
    v1 = f.c1 * b
    nc0 = v0 + v1.mul_by_v()
    nc1 = (f.c0 + f.c1) * (a + b) - v0 - v1
    return Fp12(nc0, nc1, Fq12)


def miller_loop(pairs) -> Fp12:
    """Product of Miller loops over [(P_g1, Q_g2)] (affine-normalized inputs).
    Mirrors arkworks `Pairing::multi_miller_loop` usage throughout the
    reference (e.g. `utils/src/randomized_pairing_check.rs:204-215`)."""
    prepared = []
    for (p, q) in pairs:
        if p.is_infinity() or q.is_infinity():
            continue
        px, py = p.to_affine()
        qx, qy = q.to_affine()
        prepared.append((px, py, qx, qy, _HomG2(qx, qy, Fq2.one())))
    f = Fq12.one()
    first = True
    for bit in _X_BITS[1:]:
        if not first:
            f = f.square()
        first = False
        for (px, py, qx, qy, r) in prepared:
            c0, c1, c2 = _doubling_step(r)
            f = _mul_by_014(f, c0, c1.mul_base(px), c2.mul_base(py))
        if bit == "1":
            for (px, py, qx, qy, r) in prepared:
                c0, c1, c2 = _addition_step(r, qx, qy)
                f = _mul_by_014(f, c0, c1.mul_base(px), c2.mul_base(py))
    # X < 0 for BLS12-381: conjugate
    return f.conjugate()


_HARD_EXP = (P ** 4 - P ** 2 + 1) // R


def hard_part_generic(f: Fp12) -> Fp12:
    return f ** _HARD_EXP


_K_ABS = (_X_ABS + 1) // 3  # |x - 1| / 3 (x-1 is negative and divisible by 3)


def _cyclotomic_exp_abs(f: Fp12, e: int) -> Fp12:
    r = None
    for bit in bin(e)[2:]:
        if r is not None:
            r = r.cyclotomic_square()
        if bit == "1":
            r = f if r is None else r * f
    return r


def hard_part(f: Fp12) -> Fp12:
    """Hard part of BLS12 final exponentiation, canonical exponent
    d = (p^4-p^2+1)/r, via the decomposition
    d = ((x-1)/3)·(x-1)·(x+p)·(x^2+p^2-1) + 1   (x the BLS parameter).
    Verified against `hard_part_generic` in tests."""
    # a = f^(x-1): x negative -> f^|x| conj, times f^-1 (conj)
    a = _cyclotomic_exp_abs(f, _X_ABS).conjugate() * f.conjugate()
    # b = a^((x-1)/3): (x-1)/3 negative with magnitude _K_ABS
    b = _cyclotomic_exp_abs(a, _K_ABS).conjugate()
    # c = b^(x+p) = b^x * b^p
    c = _cyclotomic_exp_abs(b, _X_ABS).conjugate() * b.frobenius(1)
    # d = c^(x^2+p^2-1) = (c^x)^x * c^(p^2) * c^(-1)
    cx = _cyclotomic_exp_abs(c, _X_ABS).conjugate()
    cxx = _cyclotomic_exp_abs(cx, _X_ABS).conjugate()
    d = cxx * c.frobenius(2) * c.conjugate()
    return d * f


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r).  Easy part via conjugation/frobenius; hard part via
    the x-addition chain."""
    # easy part: f^(p^6 - 1) then ^(p^2 + 1)
    f = f.conjugate() * f.inverse()
    f = f.frobenius(2) * f
    return hard_part(f)


def pairing(p: Point, q: Point) -> Fp12:
    return final_exponentiation(miller_loop([(p, q)]))


def multi_pairing(pairs) -> Fp12:
    """prod e(P_i, Q_i); the product-of-pairings form every verifier in the
    reference uses (`bbs_plus/src/signature.rs:272-295` etc.)."""
    return final_exponentiation(miller_loop(pairs))


# GT (multiplicative target group) helpers
GT_GEN = None  # computed lazily


def gt_generator() -> Fp12:
    global GT_GEN
    if GT_GEN is None:
        GT_GEN = pairing(G1.generator(), G2.generator())
    return GT_GEN
