"""Host-side short-Weierstrass curve arithmetic, generic over the coefficient
field (Fq for G1, Fq2 for G2).

The port's own copy of `crypto_tpu/curves/sw.py`.  Points are immutable;
`Point` is Jacobian projective (Z=0 encodes infinity).  The batched path
lives in `crypto_tpu_torch.curves.tcurve`.
"""

from __future__ import annotations

from typing import Optional

from ..fields.host import Field


class SWCurve:
    """y^2 = x^3 + a x + b over coefficient field `K` (duck-typed factory:
    must provide __call__(int), zero(), one(), rand(rng))."""

    __slots__ = ("name", "K", "a", "b", "scalar_field", "cofactor", "_gen")

    def __init__(self, name, K, a, b, scalar_field, cofactor=1, generator_xy=None):
        self.name = name
        self.K = K
        self.a = a
        self.b = b
        self.scalar_field = scalar_field  # host.Field for the prime-order group
        self.cofactor = cofactor
        self._gen = None
        if generator_xy is not None:
            x, y = generator_xy
            self._gen = Point(x, y, K.one(), self)
            assert self._gen.is_on_curve(), f"{name}: generator not on curve"

    def generator(self) -> "Point":
        return self._gen

    def infinity(self) -> "Point":
        return Point(self.K.one(), self.K.one(), self.K.zero(), self)

    def point_from_affine(self, x, y) -> "Point":
        p = Point(x, y, self.K.one(), self)
        if not p.is_on_curve():
            raise ValueError(f"{self.name}: point not on curve")
        return p

    def y_from_x(self, x) -> Optional[tuple]:
        """Both candidate y for given x, or None if x not on curve."""
        rhs = x * x * x + self.a * x + self.b
        y = rhs.sqrt()
        if y is None:
            return None
        return (y, -y)

    def rand(self, rng) -> "Point":
        """Random point in the prime-order subgroup: s * G."""
        return self._gen * self.scalar_field.rand(rng).v

    def __repr__(self):
        return f"SWCurve({self.name})"


class Point:
    """Jacobian projective point: (X, Y, Z) with x = X/Z^2, y = Y/Z^3."""

    __slots__ = ("X", "Y", "Z", "curve")

    def __init__(self, X, Y, Z, curve: SWCurve):
        self.X, self.Y, self.Z, self.curve = X, Y, Z, curve

    def is_infinity(self) -> bool:
        return self.Z.is_zero()

    def double(self) -> "Point":
        if self.is_infinity() or self.Y.is_zero():
            return self.curve.infinity()
        X1, Y1, Z1 = self.X, self.Y, self.Z
        a = self.curve.a
        XX = X1.square()
        YY = Y1.square()
        YYYY = YY.square()
        S = ((X1 + YY).square() - XX - YYYY).double()
        M = XX + XX + XX
        if not a.is_zero():
            ZZ = Z1.square()
            M = M + a * ZZ.square()
        T = M.square() - S - S
        X3 = T
        Y3 = M * (S - T) - YYYY.double().double().double()
        Z3 = (Y1 * Z1).double()
        return Point(X3, Y3, Z3, self.curve)

    def __add__(self, o: "Point") -> "Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = o.X, o.Y, o.Z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return self.curve.infinity()
        H = U2 - U1
        I = H.double().square()
        J = H * I
        r = (S2 - S1).double()
        V = U1 * I
        X3 = r.square() - J - V.double()
        Y3 = r * (V - X3) - (S1 * J).double()
        Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
        return Point(X3, Y3, Z3, self.curve)

    def __neg__(self) -> "Point":
        return Point(self.X, -self.Y, self.Z, self.curve)

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k) -> "Point":
        """Scalar multiplication; k is int or host Fp (scalar field)."""
        if not isinstance(k, int):
            k = int(k)
        k = k % self.curve.scalar_field.p if self.curve.scalar_field else k
        return self.mul_raw(k)

    __rmul__ = __mul__

    def mul_raw(self, k: int) -> "Point":
        """Scalar mul without reducing k mod group order (for cofactor
        etc.).  Over a prime field (G1) on plain integers with a
        signed-digit recoding (`_mul_ints`, an affine result), about 8x
        fewer Python objects and reductions than the field objects'
        double-and-add, which the other curves (G2) take."""
        if k == 0 or self.is_infinity():
            return self.curve.infinity()
        neg = k < 0
        k = -k if neg else k
        r = _mul_ints(self, k) if isinstance(self.curve.K, Field) else None
        if r is None:
            r = self.curve.infinity()
            q = self
            while k:
                if k & 1:
                    r = r + q
                q = q.double()
                k >>= 1
        return -r if neg else r

    def to_affine(self):
        """Returns (x, y) coefficient-field pair, or None for infinity."""
        if self.is_infinity():
            return None
        zinv = self.Z.inverse()
        zinv2 = zinv.square()
        return (self.X * zinv2, self.Y * zinv2 * zinv)

    def normalize(self) -> "Point":
        if self.is_infinity():
            return self.curve.infinity()
        x, y = self.to_affine()
        return Point(x, y, self.curve.K.one(), self.curve)

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.to_affine()
        return y * y == x * x * x + self.curve.a * x + self.curve.b

    def __eq__(self, o) -> bool:
        if not isinstance(o, Point):
            return NotImplemented
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        Z1Z1 = self.Z.square()
        Z2Z2 = o.Z.square()
        return (self.X * Z2Z2 == o.X * Z1Z1
                and self.Y * Z2Z2 * o.Z == o.Y * Z1Z1 * self.Z)

    def __hash__(self):
        if self.is_infinity():
            return hash((self.curve.name, "inf"))
        x, y = self.to_affine()
        return hash((self.curve.name, x, y))

    def __repr__(self):
        if self.is_infinity():
            return f"{self.curve.name}(inf)"
        x, y = self.to_affine()
        return f"{self.curve.name}({x}, {y})"


# ---------------------------------------------------------------------------
# scalar multiplication over plain integers (curves over a prime field)
# ---------------------------------------------------------------------------

def _jdouble(X, Y, Z, a, p):
    if Z == 0 or Y == 0:
        return 1, 1, 0
    XX, YY = X * X % p, Y * Y % p
    YYYY = YY * YY % p
    S = 2 * ((X + YY) ** 2 - XX - YYYY) % p
    M = 3 * XX
    if a:
        M += a * pow(Z, 4, p)
    M %= p
    X3 = (M * M - 2 * S) % p
    return X3, (M * (S - X3) - 8 * YYYY) % p, 2 * Y * Z % p


def _jadd_affine(X, Y, Z, x2, y2, a, p):
    """(X, Y, Z) + (x2, y2), the second point affine and finite."""
    if Z == 0:
        return x2, y2, 1
    ZZ = Z * Z % p
    H = (x2 * ZZ - X) % p
    r = 2 * (y2 * Z * ZZ - Y) % p
    if H == 0:
        return _jdouble(X, Y, Z, a, p) if r == 0 else (1, 1, 0)
    HH = H * H % p
    I4 = 4 * HH
    J = H * I4 % p
    V = X * I4 % p
    X3 = (r * r - J - 2 * V) % p
    return (X3, (r * (V - X3) - 2 * Y * J) % p,
            ((Z + H) ** 2 - ZZ - HH) % p)


def _naf(k: int, w: int) -> list:
    """Width-w NAF digits of k > 0, least significant first."""
    out, half, full = [], 1 << (w - 1), 1 << w
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out


def _mul_ints(P: "Point", k: int) -> Optional["Point"]:
    """k P (k > 0, P finite, over a prime field) on plain integers: a
    width-5 NAF (width 2 below 2^32) over a table of P's odd multiples,
    affine, with mixed Jacobian additions; returned affine (Z = 1), one
    integer inversion.  None when a multiple in the table is infinite (P
    of tiny order), for the caller's loop."""
    curve, K = P.curve, P.curve.K
    p, a = K.p, curve.a.v
    Q = P.normalize()
    x, y = Q.X.v, Q.Y.v
    w = 5 if k.bit_length() > 32 else 2
    # odd multiples P, 3P, ..., (2^(w-1) - 1)P, affine
    table = [(x, y)]
    if w > 2:
        X2, Y2, Z2 = _jdouble(x, y, 1, a, p)
        if Z2 == 0:
            return None
        zi = pow(Z2, -1, p)
        dx, dy = X2 * zi * zi % p, Y2 * zi * zi * zi % p
        for _ in range((1 << (w - 2)) - 1):
            X3, Y3, Z3 = _jadd_affine(dx, dy, 1, *table[-1], a, p)
            if Z3 == 0:
                return None
            zi = pow(Z3, -1, p)
            table.append((X3 * zi * zi % p, Y3 * zi * zi * zi % p))
    X, Y, Z = 1, 1, 0
    for d in reversed(_naf(k, w)):
        X, Y, Z = _jdouble(X, Y, Z, a, p)
        if d:
            tx, ty = table[abs(d) >> 1]
            X, Y, Z = _jadd_affine(X, Y, Z, tx, ty if d > 0 else p - ty,
                                   a, p)
    if Z == 0:
        return curve.infinity()
    zi = pow(Z, -1, p)
    return Point(K(X * zi * zi % p), K(Y * zi * zi * zi % p), K.one(), curve)
