"""The port's TField (crypto_tpu_torch) against the reference JField and
the host field, on BLS12-381 Fq and Fr.

Inputs are made from a seed, packed by the JAX package and carried into
the port with `crypto_tpu_torch.convert`; every comparison is exact (the
canonical Montgomery forms, converted, must be equal limb for limb).
The port runs on the CPU, where `mul` takes the mont_mul kernel's plain
version.
"""

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops.kernels.field_kernels import mont_mul

FIELDS = {"Fq": (jb.Fq, tb.Fq), "Fr": (jb.Fr, tb.Fr)}


def _values(p: int, n: int, seed: int) -> list:
    """n seeded uniform values, then the edges 0, 1, p-1 and the largest
    value whose limbs below the top one are all ones."""
    words = np.random.default_rng(seed).integers(0, 1 << 62, size=(n, 7))
    vals = [sum(int(w) << (62 * k) for k, w in enumerate(row)) % p
            for row in words]
    top = 32 * ((p.bit_length() - 1) // 32)
    return vals + [0, 1, p - 1, (1 << top) - 1]


def _ctx(name):
    jf, tf = FIELDS[name]
    return jfield_for(jf), tfield_for(tf, "cpu"), jf.p


def _port(J_out, p, mont=True):
    return convert.jax_to_port(np.asarray(J_out), p, mont=mont,
                               device="cpu")


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_convert_roundtrip(name):
    J, T, p = _ctx(name)
    vals = _values(p, 24, 1)
    A = J.pack(vals)
    At = _port(A, p)
    assert torch.equal(At, T.pack(vals))
    assert list(T.unpack(At)) == vals
    assert np.array_equal(convert.port_to_jax(At, p), np.asarray(A))
    raw = J.pack(vals, mont=False)
    assert np.array_equal(
        convert.port_to_jax(_port(raw, p, mont=False), p, mont=False),
        np.asarray(raw))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_binary_ops(name, op):
    J, T, p = _ctx(name)
    xs = _values(p, 40, 2)
    ys = _values(p, 40, 3)[::-1]
    A, B = J.pack(xs), J.pack(ys)
    jop = J.mul_einsum if op == "mul" else getattr(J, op)
    got = getattr(T, op)(_port(A, p), _port(B, p))
    assert torch.equal(got, _port(jop(A, B), p))
    ref = {"add": lambda x, y: (x + y) % p, "sub": lambda x, y: (x - y) % p,
           "mul": lambda x, y: x * y % p}[op]
    assert list(T.unpack(got)) == [ref(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", ["neg", "double", "square", "inv"])
@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_unary_ops(name, op):
    J, T, p = _ctx(name)
    xs = _values(p, 6 if op == "inv" else 40, 4)
    A = J.pack(xs)
    got = getattr(T, op)(_port(A, p))
    assert torch.equal(got, _port(getattr(J, op)(A), p))
    ref = {"neg": lambda x: -x % p, "double": lambda x: 2 * x % p,
           "square": lambda x: x * x % p,
           "inv": lambda x: pow(x, -1, p) if x else 0}[op]
    assert list(T.unpack(got)) == [ref(x) for x in xs]


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_conversion_and_pow(name):
    J, T, p = _ctx(name)
    xs = _values(p, 12, 5)
    raw = J.pack(xs, mont=False)
    got = T.to_mont(_port(raw, p, mont=False))
    assert torch.equal(got, _port(J.to_mont(raw), p))
    A = J.pack(xs)
    back = T.from_mont(_port(A, p))
    assert torch.equal(back, _port(J.from_mont(A), p, mont=False))
    assert list(T.unpack(back, mont=False)) == xs
    e = 0x1F2E3D4C5B6A
    got = T.pow_fixed(_port(A, p), e)
    assert torch.equal(got, _port(J.pow_fixed(A, e), p))
    assert list(T.unpack(got)) == [pow(x, e, p) for x in xs]
    assert list(T.unpack(T.pow_fixed(_port(A, p), 0))) == [1] * len(xs)


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_predicates_select_constants(name):
    J, T, p = _ctx(name)
    xs = _values(p, 8, 6)
    ys = list(xs)
    ys[1] = (ys[1] + 1) % p
    A, B = J.pack(xs), J.pack(ys)
    At, Bt = _port(A, p), _port(B, p)
    assert torch.equal(T.is_zero(At), torch.tensor(np.asarray(J.is_zero(A))))
    assert torch.equal(T.eq(At, Bt), torch.tensor(np.asarray(J.eq(A, B))))
    mask = torch.tensor([i % 3 == 0 for i in range(len(xs))])
    got = T.select(mask, At, Bt)
    assert torch.equal(got, _port(J.select(np.asarray(mask), A, B), p))
    assert torch.equal(T.zeros((2, 3)), _port(J.zeros((2, 3)), p))
    assert torch.equal(T.ones((2, 3)), _port(J.ones((2, 3)), p))
    assert T.zeros((2, 3)).shape == (T.L, 2, 3)


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_mul_all_ones_limbs(name):
    """Operands below R but not below p (all-ones limbs): the CIOS result
    (a*b + m*p)/R, less p once if that is >= p, as the kernel computes."""
    _J, T, p = _ctx(name)
    R = 1 << (32 * T.L)
    ninv = -pow(p, -1, R) % R
    vals = [R - 1, p, p + 1, R - p, 1, 0, p - 1]
    a = torch.stack([torch.tensor([(v >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(T.L)], dtype=torch.int64)
                     for v in vals], dim=1)
    a = torch.where(a >= 2 ** 31, a - 2 ** 32, a).to(torch.int32)
    b = a.flip(1).contiguous()
    got = T.unpack(mont_mul(a, b, T.mod), mont=False)
    for x, y, g in zip(vals, vals[::-1], got):
        t = x * y
        t = (t + (t * ninv % R) * p) // R
        assert g == (t - p if t >= p else t)


def test_mont_mul_wrapper_checks():
    T = tfield_for(tb.Fq, "cpu")
    a = T.pack([1, 2, 3])
    with pytest.raises(ValueError):
        mont_mul(a, a[:, :2].contiguous(), T.mod)
    with pytest.raises(ValueError):
        mont_mul(a.to(torch.int64), a.to(torch.int64), T.mod)
    with pytest.raises(ValueError):
        mont_mul(a[:8].contiguous(), a[:8].contiguous(), T.mod)
    with pytest.raises(ValueError):
        mont_mul(a.to("meta"), a.to("meta"), T.mod)
