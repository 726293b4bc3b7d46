"""Host polynomial helpers: the port's own copy of the parts of
`crypto_tpu/utils/ff.py` (reference `utils/src/ff.rs`,
`utils/src/poly.rs`) that the accumulator uses."""

from __future__ import annotations

from ..fields.host import Fp


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
