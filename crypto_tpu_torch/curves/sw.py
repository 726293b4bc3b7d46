"""Host-side short-Weierstrass curve arithmetic, generic over the coefficient
field (Fq for G1, Fq2 for G2).

The port's own copy of `crypto_tpu/curves/sw.py`.  Points are immutable;
`Point` is Jacobian projective (Z=0 encodes infinity).  The batched path
lives in `crypto_tpu_torch.curves.tcurve`.
"""

from __future__ import annotations

from typing import Optional


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
        if k == 0 or self.is_infinity():
            return self.curve.infinity()
        neg = k < 0
        k = -k if neg else k
        r = self.curve.infinity()
        q = self
        while k:
            if k & 1:
                r = r + q
            q = q.double()
            k >>= 1
        return -r if neg else r

    __rmul__ = __mul__

    def mul_raw(self, k: int) -> "Point":
        """Scalar mul without reducing k mod group order (for cofactor etc.)."""
        if k == 0 or self.is_infinity():
            return self.curve.infinity()
        neg = k < 0
        k = -k if neg else k
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
