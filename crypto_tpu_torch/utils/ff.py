"""Host field-vector and polynomial helpers: the port's own copy of the
parts of `crypto_tpu/utils/ff.py` (reference `utils/src/ff.rs`,
`utils/src/poly.rs`) that the accumulator, SAVER and the aggregation
use, and the Bulletproofs++ range proof's `hadamard_product`."""

from __future__ import annotations

from ..fields.host import Fp


def inner_product(a, b) -> Fp:
    assert len(a) == len(b) and len(a) > 0
    acc = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        acc = acc + x * y
    return acc


def hadamard_product(a, b):
    """The entrywise product of a and b, truncated to the shorter."""
    return [x * y for x, y in zip(a, b)]


def powers(x: Fp, n: int):
    """[1, x, x^2, ..., x^(n-1)]"""
    out = [x.f.one()]
    for _ in range(n - 1):
        out.append(out[-1] * x)
    return out


def powers_starting_from(start: Fp, x: Fp, n: int):
    """[start, start x, ..., start x^(n-1)]"""
    out = [start]
    for _ in range(n - 1):
        out.append(out[-1] * x)
    return out


def scale(vec, s: Fp):
    return [v * s for v in vec]


def add_vecs(a, b):
    return [x + y for x, y in zip(a, b)]


def sum_vec(vec):
    acc = vec[0]
    for v in vec[1:]:
        acc = acc + v
    return acc


def poly_eval(coeffs, x: Fp) -> Fp:
    """Horner evaluation of a coefficient list (low degree first)."""
    acc = x.f.zero()
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


def multiply_poly(a, b):
    """Schoolbook polynomial multiplication (reference `utils/src/poly.rs:10-24`;
    large products go through the device NTT, `ops/ntt.py`)."""
    F = a[0].f
    out = [F.zero()] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = out[i + j] + x * y
    return out
