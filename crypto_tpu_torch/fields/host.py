"""Host-side (Python-int) prime field arithmetic.

The port's own copy of `crypto_tpu/fields/host.py` (the port imports
nothing of the JAX package).  The one change is the limb metadata: the
port's device fields use 32-bit limbs, so `limb_bits` defaults to 32 and
`R`, `R2`, `n0inv` and `Ninv_R` follow (R = 2^384 for BLS12-381 Fq,
2^256 for Fr).  The batched path lives in `crypto_tpu_torch.fields.tfield`
and is tested bit-exact against this layer.

Elements are immutable lightweight wrappers over Python ints (canonical
representative in [0, p)).  Serialization is little-endian fixed-width bytes,
matching arkworks `CanonicalSerialize` for prime fields.
"""

from __future__ import annotations

import math
from typing import Optional


class Field:
    """A prime field GF(p). Instances act as element factories: ``Fr(5)``."""

    __slots__ = (
        "name", "p", "bits", "nbytes", "limb_bits", "num_limbs",
        "R", "R2", "R3", "n0inv", "Ninv_R", "two_adicity", "trace_odd",
        "generator", "root_of_unity", "_sqrt_exp",
    )

    def __init__(self, name: str, p: int, generator: Optional[int] = None,
                 limb_bits: int = 32):
        self.name = name
        self.p = p
        self.bits = p.bit_length()
        self.nbytes = (self.bits + 7) // 8
        # --- limb/Montgomery metadata shared with the device layer ---
        self.limb_bits = limb_bits
        self.num_limbs = (self.bits + limb_bits - 1) // limb_bits
        R = 1 << (limb_bits * self.num_limbs)
        assert R > p and math.gcd(R, p) == 1
        self.R = R % p
        self.R2 = (R * R) % p
        self.R3 = (R * R % p) * R % p
        # -p^{-1} mod 2^limb_bits (per-limb constant for CIOS)
        self.n0inv = (-pow(p, -1, 1 << limb_bits)) % (1 << limb_bits)
        # -p^{-1} mod R (full-width constant for 3-mul Montgomery)
        self.Ninv_R = (-pow(p, -1, R)) % R
        # --- 2-adic structure (for NTT) ---
        t = p - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity = s
        self.trace_odd = t
        self.generator = generator
        if generator is not None:
            self.root_of_unity = pow(generator, t, p)  # 2^s-th root of unity
        else:
            self.root_of_unity = None
        # exponent for sqrt when p % 4 == 3
        self._sqrt_exp = (p + 1) // 4 if p % 4 == 3 else None

    # -- element factory --
    def __call__(self, v: int) -> "Fp":
        return Fp(v % self.p, self)

    def zero(self) -> "Fp":
        return Fp(0, self)

    def one(self) -> "Fp":
        return Fp(1, self)

    def rand(self, rng) -> "Fp":
        """Uniform element; rng is a random.Random or numpy Generator-like."""
        return Fp(rng.randrange(self.p), self)

    def rand_nonzero(self, rng) -> "Fp":
        return Fp(1 + rng.randrange(self.p - 1), self)

    def from_bytes_le(self, b: bytes) -> "Fp":
        v = int.from_bytes(b, "little")
        if v >= self.p:
            raise ValueError(f"{self.name}: value out of range")
        return Fp(v, self)

    def from_bytes_le_mod(self, b: bytes) -> "Fp":
        """Wide reduction: interpret bytes little-endian, reduce mod p."""
        return Fp(int.from_bytes(b, "little") % self.p, self)

    def from_random_bytes(self, b: bytes) -> Optional["Fp"]:
        """arkworks `Field::from_random_bytes` semantics: read `nbytes`
        little-endian, mask bits above the modulus bit length, None if >= p.
        (Used by try-and-increment hashing, reference
        `utils/src/hashing_utils.rs:41-51`.)"""
        if len(b) < self.nbytes:
            return None
        v = int.from_bytes(b[: self.nbytes], "little")
        # mask off the flag/extra bits beyond modulus bit size
        excess = 8 * self.nbytes - self.bits
        if excess:
            v &= (1 << (8 * self.nbytes - excess)) - 1
        if v >= self.p:
            return None
        return Fp(v, self)

    def __repr__(self):
        return f"Field({self.name})"

    def __eq__(self, other):
        return isinstance(other, Field) and other.p == self.p

    def __hash__(self):
        return hash(("Field", self.p))


class Fp:
    """Element of a prime field; canonical int in [0, p)."""

    __slots__ = ("v", "f")

    def __init__(self, v: int, f: Field):
        self.v = v
        self.f = f

    # -- arithmetic --
    def __add__(self, o):
        return Fp((self.v + o.v) % self.f.p, self.f)

    def __sub__(self, o):
        return Fp((self.v - o.v) % self.f.p, self.f)

    def __neg__(self):
        return Fp(-self.v % self.f.p, self.f)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp((self.v * o) % self.f.p, self.f)
        return Fp((self.v * o.v) % self.f.p, self.f)

    __rmul__ = __mul__

    def square(self):
        return Fp((self.v * self.v) % self.f.p, self.f)

    def double(self):
        return Fp((self.v * 2) % self.f.p, self.f)

    def inverse(self):
        if self.v == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.f.name}")
        return Fp(pow(self.v, -1, self.f.p), self.f)

    def __truediv__(self, o):
        return self * o.inverse()

    def __pow__(self, e: int):
        return Fp(pow(self.v, e, self.f.p), self.f)

    def sqrt(self) -> Optional["Fp"]:
        """Square root if it exists (None otherwise). Tonelli-Shanks."""
        p = self.f.p
        if self.v == 0:
            return Fp(0, self.f)
        if pow(self.v, (p - 1) // 2, p) != 1:
            return None
        if self.f._sqrt_exp is not None:
            r = pow(self.v, self.f._sqrt_exp, p)
        else:
            r = _tonelli_shanks(self.v, p)
        return Fp(r, self.f)

    def legendre(self) -> int:
        if self.v == 0:
            return 0
        return 1 if pow(self.v, (self.f.p - 1) // 2, self.f.p) == 1 else -1

    # -- predicates --
    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def __eq__(self, o):
        return isinstance(o, Fp) and self.v == o.v and self.f.p == o.f.p

    def __hash__(self):
        return hash((self.v, self.f.p))

    def __repr__(self):
        return f"{self.f.name}({hex(self.v)})"

    def __int__(self):
        return self.v

    # -- serialization (arkworks-compatible: little-endian fixed width) --
    def to_bytes_le(self) -> bytes:
        return self.v.to_bytes(self.f.nbytes, "little")

    # "is positive" in the arkworks sense: self > p - self lexicographically,
    # i.e. self > (p-1)/2.  Used for compressed point sign flags.
    def is_gt_half(self) -> bool:
        return self.v > (self.f.p - 1) // 2


def _tonelli_shanks(a: int, p: int) -> int:
    # general Tonelli-Shanks (p % 4 == 1 case)
    q = p - 1
    s = 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r
