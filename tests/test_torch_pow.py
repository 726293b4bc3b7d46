"""The port's fixed-exponent power (`field_kernels.mont_pow`, its plain
version on the CPU) against the reference's `JField.inv` / `pow_fixed`
on the CPU and the host field; and a host-integer model of the Fq2
product's lazy reduction (`csrc/field.cuh` `fq2_mul`) against the host
Fq2 product and the port's plain `fq2_mul_plain`.

The CUDA kernels run only on the card (`chip_smoke.py` holds them
against these plain versions); here the plain versions and the model
carry the arithmetic.  Inputs come from a numpy seed plus the edges;
every comparison is exact.
"""

import itertools

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.fields.ttower import tquad_for
from crypto_tpu_torch.ops.kernels.field_kernels import (POW_WORDS,
                                                        fq2_mul_plain,
                                                        mont_pow,
                                                        mont_pow_plain)

FIELDS = {"Fq": (jb.Fq, tb.Fq), "Fr": (jb.Fr, tb.Fr)}


def _values(p: int, n: int, seed: int) -> list:
    """n seeded values mod p with a zero at every fifth place from the
    fourth, and p - 1 and 1 where they fit."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]
    for i in range(3, n, 5):
        vals[i] = 0
    if n >= 3:
        vals[:2] = [p - 1, 1]
    return vals


def _port(J_out, p):
    return convert.jax_to_port(np.asarray(J_out), p, device="cpu")


@pytest.mark.parametrize("n", [1, 16, 1000])
@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_pow_fermat_root_vs_reference_and_host(name, n):
    """TField.inv (mont_pow with e = p - 2) equals JField.inv and the host
    inverse, 0 -> 0."""
    jf, tf = FIELDS[name]
    J, T, p = jfield_for(jf), tfield_for(tf, "cpu"), jf.p
    vals = _values(p, n, 10 + n)
    A = J.pack(vals)
    got = T.inv(_port(A, p))
    assert torch.equal(got, mont_pow(_port(A, p), p - 2, T.mod))
    assert torch.equal(got, _port(J.inv(A), p))
    want = [int(tf(v).inverse()) if v else 0 for v in vals]
    assert list(np.atleast_1d(T.unpack(got))) == want


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_pow_zero_alone(name):
    jf, tf = FIELDS[name]
    J, T, p = jfield_for(jf), tfield_for(tf, "cpu"), jf.p
    A = J.pack([0])
    got = mont_pow(_port(A, p), p - 2, T.mod)
    assert torch.equal(got, _port(J.inv(A), p))
    assert T.unpack(got) == 0


@pytest.mark.parametrize("e", [1, 2, 3, 0x1F2E3D4C5B6A, "p-1", "2^383+5"])
@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_pow_other_exponents(name, e):
    """Fixed exponents other than p - 2 against the host pow, and against
    JField.pow_fixed for one of them."""
    jf, tf = FIELDS[name]
    J, T, p = jfield_for(jf), tfield_for(tf, "cpu"), jf.p
    e = {"p-1": p - 1, "2^383+5": (1 << 383) + 5}.get(e, e)
    vals = _values(p, 12, 7)
    x = T.pack(vals)
    got = T.pow_fixed(x, e)
    assert torch.equal(got, mont_pow_plain(x, e, T.mod))
    assert list(T.unpack(got)) == [pow(v, e, p) for v in vals]
    if e == 0x1F2E3D4C5B6A:
        A = J.pack(vals)
        assert torch.equal(got, _port(J.pow_fixed(A, e), p))


def test_mont_pow_wrapper_checks():
    T = tfield_for(tb.Fq, "cpu")
    a = T.pack([1, 2, 3])
    for e in (0, -1, 1 << (32 * POW_WORDS)):
        with pytest.raises(ValueError):
            mont_pow(a, e, T.mod)
    with pytest.raises(ValueError):
        mont_pow(a[:8].contiguous(), 5, T.mod)
    with pytest.raises(ValueError):
        mont_pow(a.to(torch.int64), 5, T.mod)
    with pytest.raises(ValueError):
        mont_pow(a.to("meta"), 5, T.mod)
    assert mont_pow(a[:, :0].contiguous(), 5, T.mod).shape == (T.L, 0)
    assert torch.equal(T.pow_fixed(a, 0), T.ones((3,)))


# ---------------------------------------------------------------------------
# the lazy-reduction Fq2 product, step by step on host integers
# ---------------------------------------------------------------------------

P = tb.P
L = 12
R = 1 << (32 * L)
N0INV = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _redc(T: int) -> tuple:
    """The kernel's reduction of T < p*R: 12 rows of m_i = t_0 * n0inv mod
    2^32 and t = (t + m_i*p) / 2^32 over T's low 12 words, then T's high
    words added and p subtracted once.  Returns (result, value before the
    subtraction)."""
    assert 0 <= T < P * R
    t = T % R
    for _ in range(L):
        m = (t & 0xFFFFFFFF) * N0INV & 0xFFFFFFFF
        t = (t + m * P) >> 32
    assert t <= P
    u = t + (T >> (32 * L))
    return (u - P if u >= P else u), u


def _fq2_mul_lazy(a0, a1, b0, b1) -> tuple:
    """c0 = redc(v0 + p^2 - v1), c1 = redc(t - v0 - v1) with v0 = a0*b0,
    v1 = a1*b1, t = (a0 + a1)(b0 + b1), the sums unreduced."""
    sa, sb = a0 + a1, b0 + b1
    assert sa < R and sb < R                  # 12 words, no carry out
    v0, v1, t = a0 * b0, a1 * b1, sa * sb
    assert max(v0, v1, t) < 1 << (64 * L)     # 24 words
    T0, T1 = v0 + P * P - v1, t - v0 - v1
    assert 0 <= T0 < 2 * P * P < P * R and 0 <= T1 < 2 * P * P
    (c0, u0), (c1, u1) = _redc(T0), _redc(T1)
    assert u0 < 2 * P and u1 < 2 * P and c0 < P and c1 < P
    return c0, c1


EDGES = [0, 1, P - 1, P // 2, (1 << 380) + 7]


def _host_mont_product(a, b):
    """The canonical Montgomery limbs of the host Fq2 product of the
    elements whose Montgomery limbs are a and b."""
    rinv = pow(R, -1, P)
    x = tb.Fq2(a[0] * rinv, a[1] * rinv) * tb.Fq2(b[0] * rinv, b[1] * rinv)
    return int(x.c0) * R % P, int(x.c1) * R % P


def test_fq2_mul_lazy_model_at_edges():
    """Every pair of edge values per component: 0, 1, p - 1 (a0 + a1 >= p,
    and v0 = 0 with v1 = (p - 1)^2), p // 2 and a 381-bit value."""
    pairs = list(itertools.product(EDGES, EDGES))
    for a, b in itertools.product(pairs, pairs):
        assert _fq2_mul_lazy(*a, *b) == _host_mont_product(a, b)


def test_fq2_mul_lazy_model_random_and_plain():
    """Seeded canonical limbs: the model, the host product and the port's
    plain Karatsuba over three Montgomery products agree."""
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(4 * 40)]
    a = [tuple(vals[i:i + 2]) for i in range(0, 80, 2)]
    b = [tuple(vals[i:i + 2]) for i in range(80, 160, 2)]
    a += [(P - 1, P - 1), (0, P - 1), (P - 1, 0)]
    b += [(P - 1, P - 1), (0, P - 1), (P - 1, 0)]
    model = [_fq2_mul_lazy(*x, *y) for x, y in zip(a, b)]
    assert model == [_host_mont_product(x, y) for x, y in zip(a, b)]
    F = tquad_for(tb.Fq2, "cpu")
    ta = F.pack([tb.Fq2(*x) for x in a], mont=False)
    tbb = F.pack([tb.Fq2(*y) for y in b], mont=False)
    plain = F.unpack(fq2_mul_plain(F.base, ta, tbb), mont=False)
    assert [tuple(v) for v in plain] == model
