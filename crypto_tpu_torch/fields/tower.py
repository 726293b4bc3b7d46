"""Host-side extension-field towers for pairing-friendly curves.

The port's own copy of `crypto_tpu/fields/tower.py` (arkworks'
BLS12-381 tower shape):

    Fq2  = Fq [u] / (u^2 - beta)        (beta a quadratic nonresidue, -1 here)
    Fq6  = Fq2[v] / (v^3 - xi)          (xi a cubic nonresidue in Fq2)
    Fq12 = Fq6[w] / (w^2 - v)

Elements are immutable tuples of base-field elements with the same
arithmetic interface as `host.Fp`, so the host curve and pairing code is
generic over the coefficient field.  This is the port's ground truth; the
batched path lives in `crypto_tpu_torch.fields.ttower`.  The Fq2 square
root and sign (`Fp2.sqrt`, `is_gt_half`) serve hashing to G2
(`crypto_tpu_torch/hashing.py`); `Fp2.to_bytes_le` and
`QuadExtField.from_bytes_le` (arkworks' c0 || c1) serve `serialize.py`,
`Fp12.to_bytes_le` the transcript (`transcript/transcript.py`).
"""

from __future__ import annotations

from typing import Optional

from .host import Field, Fp


class QuadExtField:
    """Fq2 = Fq[u]/(u^2 - beta). Instances are element factories."""

    __slots__ = ("base", "beta", "name", "frob_c1")

    def __init__(self, base: Field, beta: Fp, name: str):
        self.base = base
        self.beta = beta
        self.name = name
        # Frobenius: u^p = u * beta^((p-1)/2); c1[i] = beta^((p^i - 1)/2)
        p = base.p
        self.frob_c1 = [base(1), base(pow(beta.v, (p - 1) // 2, p))]

    def __call__(self, c0, c1=None) -> "Fp2":
        if c1 is None:
            c1 = self.base(0)
        if isinstance(c0, int):
            c0 = self.base(c0)
        if isinstance(c1, int):
            c1 = self.base(c1)
        return Fp2(c0, c1, self)

    def zero(self):
        return self(self.base(0), self.base(0))

    def one(self):
        return self(self.base(1), self.base(0))

    def rand(self, rng):
        return self(self.base.rand(rng), self.base.rand(rng))

    def from_base(self, c0: Fp):
        return self(c0, self.base(0))

    def from_bytes_le(self, b: bytes) -> "Fp2":
        """The reader of `Fp2.to_bytes_le`: c0 || c1, each little-endian
        at the base field's width and below p."""
        nb = self.base.nbytes
        if len(b) != 2 * nb:
            raise ValueError(f"{self.name}: bad element length")
        return self(self.base.from_bytes_le(b[:nb]),
                    self.base.from_bytes_le(b[nb:]))

    @property
    def p(self):  # characteristic
        return self.base.p

    def __eq__(self, o):
        return isinstance(o, QuadExtField) and o.base == self.base and o.beta == self.beta

    def __hash__(self):
        return hash(("Fp2", self.base.p, self.beta.v))

    def __repr__(self):
        return f"QuadExtField({self.name})"


class Fp2:
    __slots__ = ("c0", "c1", "f")

    def __init__(self, c0: Fp, c1: Fp, f: QuadExtField):
        self.c0 = c0
        self.c1 = c1
        self.f = f

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1, self.f)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1, self.f)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1, self.f)

    def __mul__(self, o):
        if isinstance(o, (Fp, int)):
            return self.mul_base(o)
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 + beta a1b1 + (a0b1+a1b0) u
        a0b0 = self.c0 * o.c0
        a1b1 = self.c1 * o.c1
        t = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(a0b0 + self.f.beta * a1b1, t - a0b0 - a1b1, self.f)

    __rmul__ = __mul__

    def mul_base(self, s):
        if isinstance(s, int):
            s = self.f.base(s)
        return Fp2(self.c0 * s, self.c1 * s, self.f)

    def square(self):
        a, b = self.c0, self.c1
        t0 = a * b
        t1 = (a + b) * (a + self.f.beta * b)
        return Fp2(t1 - t0 - self.f.beta * t0, t0 + t0, self.f)

    def double(self):
        return self + self

    def inverse(self):
        # 1/(a + bu) = (a - bu)/(a^2 - beta b^2)
        ninv = self.norm().inverse()
        return Fp2(self.c0 * ninv, -(self.c1 * ninv), self.f)

    def __truediv__(self, o):
        return self * o.inverse()

    def conjugate(self):
        return Fp2(self.c0, -self.c1, self.f)

    def frobenius(self, power: int = 1):
        if power % 2 == 0:
            return self
        return self.conjugate()

    def norm(self) -> Fp:
        return self.c0.square() - self.f.beta * self.c1.square()

    def __pow__(self, e: int):
        r = self.f.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def sqrt(self) -> Optional["Fp2"]:
        """Square root in Fq2 (G2 point decompression, hashing to G2).
        Uses the 'complex method' valid for any beta: for x = a + bu,
        solve via norm: n = a^2 - beta b^2 must be a QR in Fq."""
        if self.is_zero():
            return self
        n = self.norm()
        sn = n.sqrt()
        if sn is None:
            return None
        two_inv = self.f.base(2).inverse()
        for s in (sn, -sn):
            alpha = (self.c0 + s) * two_inv
            a0 = alpha.sqrt()
            if a0 is None:
                continue
            if a0.is_zero():
                # x = beta * b^2 ... handle pure-u case: x = c1 * u
                # then (y0 + y1 u)^2 = x => y0^2 + beta y1^2 = 0, 2 y0 y1 = c1
                continue
            y1 = self.c1 * (a0 + a0).inverse()
            cand = Fp2(a0, y1, self.f)
            if cand.square() == self:
                return cand
        # fallback: generic Tonelli-Shanks in Fq2 via exponentiation
        return self._sqrt_ts()

    def _sqrt_ts(self) -> Optional["Fp2"]:
        p = self.f.base.p
        q = p * p
        # Tonelli-Shanks over Fq2 using field exponentiation
        Q = q - 1
        S = 0
        while Q % 2 == 0:
            Q //= 2
            S += 1
        # find non-residue
        import random as _r
        rng = _r.Random(7)
        while True:
            z = self.f.rand(rng)
            if z.is_zero():
                continue
            if z ** ((q - 1) // 2) == -self.f.one():
                break
        M, c, t, r = S, z ** Q, self ** Q, self ** ((Q + 1) // 2)
        one = self.f.one()
        while not (t == one):
            i, tt = 0, t
            while not (tt == one):
                tt = tt.square()
                i += 1
                if i == M:
                    return None
            b = c ** (1 << (M - i - 1))
            M, c = i, b.square()
            t = t * c
            r = r * b
        return r

    # arkworks serialization: c0 bytes || c1 bytes (little-endian each)
    def to_bytes_le(self) -> bytes:
        return self.c0.to_bytes_le() + self.c1.to_bytes_le()

    def is_gt_half(self) -> bool:
        """Lexicographic 'is positive' for sign flags: compare (c1, c0)."""
        if not self.c1.is_zero():
            return self.c1.is_gt_half()
        return self.c0.is_gt_half()

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def is_one(self):
        return self.c0.is_one() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"{self.f.name}({self.c0}, {self.c1})"


class CubicOverQuad:
    """Fq6 = Fq2[v]/(v^3 - xi)."""

    __slots__ = ("fq2", "xi", "name", "frob_c1", "frob_c2")

    def __init__(self, fq2: QuadExtField, xi: Fp2, name: str):
        self.fq2 = fq2
        self.xi = xi
        self.name = name
        p = fq2.base.p
        # Frobenius coefficients: v^(p^i) = v * xi^((p^i - 1)/3)
        self.frob_c1 = [xi ** ((p ** i - 1) // 3) for i in range(6)]
        self.frob_c2 = [xi ** ((2 * (p ** i - 1)) // 3) for i in range(6)]

    def __call__(self, c0, c1, c2):
        return Fp6(c0, c1, c2, self)

    def zero(self):
        z = self.fq2.zero()
        return Fp6(z, z, z, self)

    def one(self):
        return Fp6(self.fq2.one(), self.fq2.zero(), self.fq2.zero(), self)

    def rand(self, rng):
        return Fp6(self.fq2.rand(rng), self.fq2.rand(rng), self.fq2.rand(rng), self)

    def __repr__(self):
        return f"CubicOverQuad({self.name})"


class Fp6:
    __slots__ = ("c0", "c1", "c2", "f")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2, f: CubicOverQuad):
        self.c0, self.c1, self.c2, self.f = c0, c1, c2, f

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2, self.f)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2, self.f)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2, self.f)

    def _mul_by_xi(self, x: Fp2) -> Fp2:
        return x * self.f.xi

    def __mul__(self, o):
        if isinstance(o, Fp2):
            return Fp6(self.c0 * o, self.c1 * o, self.c2 * o, self.f)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        # Toom/Karatsuba-lite (CH-SQR2 style):
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = v0 + self._mul_by_xi((a1 + a2) * (b1 + b2) - v1 - v2)
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + self._mul_by_xi(v2)
        c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
        return Fp6(c0, c1, c2, self.f)

    def square(self):
        return self * self

    def mul_by_v(self):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fp6(self._mul_by_xi(self.c2), self.c0, self.c1, self.f)

    def inverse(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        xi = self.f.xi
        t0 = a0 * a0 - xi * (a1 * a2)
        t1 = xi * (a2 * a2) - a0 * a1
        t2 = a1 * a1 - a0 * a2
        d = a0 * t0 + xi * (a2 * t1) + xi * (a1 * t2)
        dinv = d.inverse()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv, self.f)

    def frobenius(self, power: int):
        k = power % 6
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power) * self.f.frob_c1[k]
        c2 = self.c2.frobenius(power) * self.f.frob_c2[k]
        return Fp6(c0, c1, c2, self.f)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fp6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    def __repr__(self):
        return f"Fp6({self.c0}, {self.c1}, {self.c2})"


class QuadOverCubic:
    """Fq12 = Fq6[w]/(w^2 - v). GT lives here."""

    __slots__ = ("fq6", "name", "frob_c1")

    def __init__(self, fq6: CubicOverQuad, name: str):
        self.fq6 = fq6
        self.name = name
        p = fq6.fq2.base.p
        # w^(p^i) = w * xi^((p^i - 1)/6)
        self.frob_c1 = [fq6.xi ** ((p ** i - 1) // 6) for i in range(12)]

    def __call__(self, c0, c1):
        return Fp12(c0, c1, self)

    def zero(self):
        return Fp12(self.fq6.zero(), self.fq6.zero(), self)

    def one(self):
        return Fp12(self.fq6.one(), self.fq6.zero(), self)

    def rand(self, rng):
        return Fp12(self.fq6.rand(rng), self.fq6.rand(rng), self)

    def __repr__(self):
        return f"QuadOverCubic({self.name})"


class Fp12:
    __slots__ = ("c0", "c1", "f")

    def __init__(self, c0: Fp6, c1: Fp6, f: QuadOverCubic):
        self.c0, self.c1, self.f = c0, c1, f

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1, self.f)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1, self.f)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1, self.f)

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        v0 = a0 * b0
        v1 = a1 * b1
        c0 = v0 + v1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1
        return Fp12(c0, c1, self.f)

    def square(self):
        # complex squaring: (a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w
        a0, a1 = self.c0, self.c1
        v0 = a0 * a1
        t = (a0 + a1) * (a0 + a1.mul_by_v())
        c0 = t - v0 - v0.mul_by_v()
        c1 = v0 + v0
        return Fp12(c0, c1, self.f)

    def inverse(self):
        # 1/(a0 + a1 w) = (a0 - a1 w) / (a0^2 - v a1^2)
        d = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()
        dinv = d.inverse()
        return Fp12(self.c0 * dinv, -(self.c1 * dinv), self.f)

    def conjugate(self):
        """Fq12/Fq6 conjugation = unitary inverse for cyclotomic elements."""
        return Fp12(self.c0, -self.c1, self.f)

    def frobenius(self, power: int):
        k = power % 12
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power)
        g = self.f.frob_c1[k]
        c1 = Fp6(c1.c0 * g, c1.c1 * g, c1.c2 * g, c1.f)
        return Fp12(c0, c1, self.f)

    def __pow__(self, e: int):
        if e < 0:
            return self.inverse() ** (-e)
        r = self.f.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def cyclotomic_square(self):
        """Granger-Scott squaring for elements of the cyclotomic subgroup
        (valid after the easy part of final exponentiation).  View Fq12 as a
        quadratic extension of Fq4 with coordinates grouped as pairs
        (z0,z1),(z2,z3),(z4,z5) where z's live in Fq2."""
        f6 = self.f.fq6
        xi = f6.xi
        z0, z4, z3 = self.c0.c0, self.c0.c1, self.c0.c2
        z2, z1, z5 = self.c1.c0, self.c1.c1, self.c1.c2

        def fq4_square(a, b):
            # (a + b y)^2 in Fq4 = Fq2[y]/(y^2 - xi):
            # = (a^2 + xi b^2) + 2ab y
            t = a * b
            return (a + b) * (a + xi * b) - t - xi * t, t + t

        t0, t1 = fq4_square(z0, z1)
        t2, t3 = fq4_square(z2, z3)
        t4, t5 = fq4_square(z4, z5)

        nz0 = ((t0 - z0).double()) + t0          # 3 t0 - 2 z0
        nz1 = ((t1 + z1).double()) + t1          # 3 t1 + 2 z1
        xt5 = xi * t5
        nz2 = ((xt5 + z2).double()) + xt5        # 3 xi t5 + 2 z2
        nz3 = ((t4 - z3).double()) + t4          # 3 t4 - 2 z3
        nz4 = ((t2 - z4).double()) + t2          # 3 t2 - 2 z4
        nz5 = ((t3 + z5).double()) + t3          # 3 t3 + 2 z5
        return Fp12(Fp6(nz0, nz4, nz3, f6), Fp6(nz2, nz1, nz5, f6), self.f)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def is_one(self):
        return self == self.f.one()

    def __eq__(self, o):
        return isinstance(o, Fp12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fp12({self.c0}, {self.c1})"

    def to_bytes_le(self) -> bytes:
        """The six Fq2 coefficients' `to_bytes_le`, c0's then c1's: the
        bytes a transcript takes of a GT element."""
        out = b""
        for c6 in (self.c0, self.c1):
            for c2 in (c6.c0, c6.c1, c6.c2):
                out += c2.to_bytes_le()
        return out
