"""BN254 (alt_bn128): fields, tower, G1/G2 and the optimal ate pairing
(host).

The port's own copy of `crypto_tpu/curves/bn254.py` (standard BN254 /
alt_bn128 constants, as in arkworks `ark-bn254` and the Ethereum
precompiles; Circom's bn128): Fq2 = Fq[u]/(u^2 + 1), Fq6 = Fq2[v]/(v^3 -
(9 + u)), Fq12 = Fq6[w]/(w^2 - v), and G2 is the D-type twist E'/Fq2: y^2
= x^3 + 3/xi.  Against BLS12-381 (`curves/bls12_381.py`):

  * the BN parameter x is positive; the ate loop runs over the bits of
    6x + 2 and ends with two Frobenius addition steps (no conjugation);
  * the Miller lines embed into Fq12 at coefficients (0, 3, 4)
    (`_mul_by_034`), not (0, 1, 4);
  * the final exponentiation's hard part takes the generic exponent
    (p^4 - p^2 + 1)/r.

The host pairing here is the port's ground truth for the batched one
(`curves/tpairing.py` `TPairingBN`) and the pairing the LegoGroth16
verifier runs over BN254.
"""

from __future__ import annotations

from ..fields.host import Field
from ..fields.tower import QuadExtField, CubicOverQuad, QuadOverCubic, Fp12
from .sw import SWCurve, Point

# ---------------------------------------------------------------------------
# Base parameters
# ---------------------------------------------------------------------------

# BN parameter (positive)
X = 4965661367192848881

P = 36 * X**4 + 36 * X**3 + 24 * X**2 + 6 * X + 1
R = 36 * X**4 + 36 * X**3 + 18 * X**2 + 6 * X + 1
T = 6 * X**2 + 1       # trace of Frobenius

assert P == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert R == 21888242871839275222246405745257275088548364400416034343698204186575808495617
assert P + 1 - T == R

Fq = Field("bn254.Fq", P, generator=3)
Fr = Field("bn254.Fr", R, generator=5)
assert Fr.two_adicity == 28

# ---------------------------------------------------------------------------
# Tower (matches arkworks ark-bn254)
# ---------------------------------------------------------------------------

Fq2 = QuadExtField(Fq, Fq(P - 1), "bn254.Fq2")           # u^2 = -1
XI = Fq2(Fq(9), Fq(1))                                    # xi = 9 + u
Fq6 = CubicOverQuad(Fq2, XI, "bn254.Fq6")                 # v^3 = xi
Fq12 = QuadOverCubic(Fq6, "bn254.Fq12")                   # w^2 = v

# ---------------------------------------------------------------------------
# Curves:  G1: y^2 = x^3 + 3;  G2 (D-twist): y^2 = x^3 + 3/xi
# ---------------------------------------------------------------------------

TWIST_B = XI.inverse().mul_base(3)

# cofactors: G1 has prime order; G2 cofactor from #E'(Fq2) = p^2 + 1 - t2
_T2 = T * T - 2 * P
_N2 = P * P + 1 - _T2
G2_COFACTOR = _N2 // R
assert G2_COFACTOR * R == _N2

G1 = SWCurve(
    "bn254.G1", Fq, Fq(0), Fq(3), Fr, cofactor=1,
    generator_xy=(Fq(1), Fq(2)),
)

G2 = SWCurve(
    "bn254.G2", Fq2, Fq2.zero(), TWIST_B, Fr,
    cofactor=G2_COFACTOR,
    generator_xy=(
        Fq2(
            Fq(10857046999023057135944570762232829481370756359578518086990519993285655852781),
            Fq(11559732032986387107991004021392285783925812861821192530917403151452391805634),
        ),
        Fq2(
            Fq(8495653923123431417604973247489272438418190587263600148770280649306958101930),
            Fq(4082367875863433681332203403145435568316851327593401208105741076214120093531),
        ),
    ),
)

# ---------------------------------------------------------------------------
# Pairing: optimal ate, D-type twist
# ---------------------------------------------------------------------------

ATE_LOOP = 6 * X + 2
_ATE_BITS = bin(ATE_LOOP)[2:]
_TWO_INV = Fq(2).inverse()

# Frobenius-on-twist constants: pi(x, y) = (x^p * GAMMA_X, y^p * GAMMA_Y)
GAMMA_X = XI ** ((P - 1) // 3)
GAMMA_Y = XI ** ((P - 1) // 2)


class _HomG2:
    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z


def _doubling_step(r: _HomG2):
    """CLN doubling; returns D-twist line coeffs (c0, c1, c2) combined as
    f.mul_by_034(c0*yP, c1*xP, c2)."""
    a = (r.x * r.y).mul_base(_TWO_INV)
    b = r.y.square()
    c = r.z.square()
    e = TWIST_B * (c + c + c)
    f = e + e + e
    g = (b + f).mul_base(_TWO_INV)
    h = (r.y + r.z).square() - (b + c)
    i = e - b
    j = r.x.square()
    e2 = e.square()
    r.x = a * (b - f)
    r.y = g.square() - (e2 + e2 + e2)
    r.z = b * h
    return (-h, j + j + j, i)


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
    return (lam, -theta, j)


def _mul_by_034(f: Fp12, c0, c3, c4) -> Fp12:
    """f * (c0 + c3 w + c4 v w): multiplier Fq6 coords a = (c0, 0, 0),
    b = (c3, c4, 0)."""
    z = Fq2.zero()
    a = Fq6(c0, z, z)
    b = Fq6(c3, c4, z)
    v0 = f.c0 * a
    v1 = f.c1 * b
    nc0 = v0 + v1.mul_by_v()
    nc1 = (f.c0 + f.c1) * (a + b) - v0 - v1
    return Fp12(nc0, nc1, Fq12)


def _frob_twist(qx, qy, power: int):
    """pi^power on affine twisted points."""
    x, y = qx, qy
    for _ in range(power):
        x = x.frobenius(1) * GAMMA_X
        y = y.frobenius(1) * GAMMA_Y
    return x, y


def miller_loop(pairs) -> Fp12:
    """Product of Miller loops over [(P_g1, Q_g2)], affine inputs.
    BN structure: loop over |6x+2| bits + two Frobenius addition steps."""
    prepared = []
    for (p, q) in pairs:
        if p.is_infinity() or q.is_infinity():
            continue
        px, py = p.to_affine()
        qx, qy = q.to_affine()
        prepared.append((px, py, qx, qy, _HomG2(qx, qy, Fq2.one())))
    f = Fq12.one()
    first = True
    for bit in _ATE_BITS[1:]:
        if not first:
            f = f.square()
        first = False
        for (px, py, qx, qy, r) in prepared:
            c0, c1, c2 = _doubling_step(r)
            f = _mul_by_034(f, c0.mul_base(py), c1.mul_base(px), c2)
        if bit == "1":
            for (px, py, qx, qy, r) in prepared:
                c0, c1, c2 = _addition_step(r, qx, qy)
                f = _mul_by_034(f, c0.mul_base(py), c1.mul_base(px), c2)
    # two extra steps with pi(Q) and -pi^2(Q)
    for (px, py, qx, qy, r) in prepared:
        q1x, q1y = _frob_twist(qx, qy, 1)
        c0, c1, c2 = _addition_step(r, q1x, q1y)
        f = _mul_by_034(f, c0.mul_base(py), c1.mul_base(px), c2)
        q2x, q2y = _frob_twist(qx, qy, 2)
        c0, c1, c2 = _addition_step(r, q2x, -q2y)
        f = _mul_by_034(f, c0.mul_base(py), c1.mul_base(px), c2)
    return f


_HARD_EXP = (P ** 4 - P ** 2 + 1) // R


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r): easy part via conjugate/frobenius, generic hard part
    (host-only correctness path)."""
    f = f.conjugate() * f.inverse()
    f = f.frobenius(2) * f
    return f ** _HARD_EXP


def pairing(p: Point, q: Point) -> Fp12:
    return final_exponentiation(miller_loop([(p, q)]))


def multi_pairing(pairs) -> Fp12:
    return final_exponentiation(miller_loop(pairs))
