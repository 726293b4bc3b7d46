"""Host-side quadratic extension field Fq2 = Fq[u] / (u^2 - beta).

The port's own copy of the Fq2 part of `crypto_tpu/fields/tower.py`
(arkworks' BLS12-381 tower shape, beta = -1 there).  Elements are
immutable pairs of base-field elements with the same arithmetic interface
as `host.Fp`, so the host curve code is generic over the coefficient
field.  The batched path lives in `crypto_tpu_torch.fields.ttower`.  Fq6,
Fq12 and the square root wait for the slice that ports the pairing.
"""

from __future__ import annotations

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
