"""The port's Fq6 and Fq12, host and batched, against the reference.

The port's host `Fp6`/`Fp12` (`crypto_tpu_torch/fields/tower.py`) against
`crypto_tpu/fields/tower.py`: products, squares, inverses, Frobenius
powers 1, 2, 3 and 6, `cyclotomic_square` on cyclotomic elements and
`__pow__`.  `TCubicField`/`TQuadOverCubicField` on the CPU (the kernels'
plain versions) against `JCubicField`/`JQuadOverCubicField` (eager on the
CPU) and the host; the `convert` round trips of Fq6 and Fq12.  Exact on
canonical integers; the inputs are uniform elements from a numpy seed
plus 0 and 1.
"""

import numpy as np
import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jtower import jcubic_for, jfield12_for, jquad_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.ttower import tcubic_for, tfield12_for, \
    tquad_for

P = tb.P
N = 4
T6, T12 = tcubic_for(tb.Fq6, "cpu"), tfield12_for(tb.Fq12, "cpu")
J6, J12 = jcubic_for(jb.Fq6), jfield12_for(jb.Fq12)


def _ints(seed: int, k: int) -> list:
    """N tuples of k ints mod p: zero, one, then uniform values."""
    rng = np.random.default_rng(seed)
    out = [(0,) * k, (1,) + (0,) * (k - 1)]
    while len(out) < N:
        out.append(tuple(int.from_bytes(rng.bytes(48), "little") % P
                         for _ in range(k)))
    return out


def _fp6(mod, v):
    return mod.Fq6(*(mod.Fq2(v[2 * i], v[2 * i + 1]) for i in range(3)))


def _fp12(mod, v):
    return mod.Fq12(_fp6(mod, v[:6]), _fp6(mod, v[6:]))


def _cyclotomic(mod, x):
    """x^((p^6 - 1)(p^2 + 1)): the easy part, which lands in the
    cyclotomic subgroup."""
    y = x.conjugate() * x.inverse()
    return y.frobenius(2) * y


def _i6(x):
    return tuple((int(c.c0), int(c.c1)) for c in (x.c0, x.c1, x.c2))


A6, B6 = _ints(1, 6), _ints(2, 6)
A12, B12 = _ints(3, 12), _ints(4, 12)
NONZERO = slice(1, None)

HOST6 = {
    "mul": lambda m, a, b: _fp6(m, a) * _fp6(m, b),
    "square": lambda m, a, b: _fp6(m, a).square(),
    "add": lambda m, a, b: _fp6(m, a) + _fp6(m, b),
    "sub": lambda m, a, b: _fp6(m, a) - _fp6(m, b),
    "mul_by_v": lambda m, a, b: _fp6(m, a).mul_by_v(),
    "frobenius1": lambda m, a, b: _fp6(m, a).frobenius(1),
    "frobenius2": lambda m, a, b: _fp6(m, a).frobenius(2),
    "frobenius3": lambda m, a, b: _fp6(m, a).frobenius(3),
    "frobenius6": lambda m, a, b: _fp6(m, a).frobenius(6),
}
HOST12 = {
    "mul": lambda m, a, b: _fp12(m, a) * _fp12(m, b),
    "square": lambda m, a, b: _fp12(m, a).square(),
    "conjugate": lambda m, a, b: _fp12(m, a).conjugate(),
    "frobenius1": lambda m, a, b: _fp12(m, a).frobenius(1),
    "frobenius2": lambda m, a, b: _fp12(m, a).frobenius(2),
    "frobenius3": lambda m, a, b: _fp12(m, a).frobenius(3),
    "frobenius6": lambda m, a, b: _fp12(m, a).frobenius(6),
    "pow": lambda m, a, b: _fp12(m, a) ** 0xD201000000010001,
    "pow_negative": lambda m, a, b: _fp12(m, b) ** -5,
}


@pytest.mark.parametrize("op", sorted(HOST6))
def test_host_fp6_vs_reference(op):
    for a, b in zip(A6, B6):
        assert _i6(HOST6[op](tb, a, b)) == _i6(HOST6[op](jb, a, b)), op


@pytest.mark.parametrize("op", sorted(HOST12))
def test_host_fp12_vs_reference(op):
    for a, b in zip(A12[NONZERO], B12[NONZERO]):
        assert convert.fp12_ints(HOST12[op](tb, a, b)) \
            == convert.fp12_ints(HOST12[op](jb, a, b)), op


def test_host_inverses_and_cyclotomic_square_vs_reference():
    for a in A12[NONZERO]:
        x, y = _fp12(tb, a), _fp12(jb, a)
        assert convert.fp12_ints(x.inverse()) == convert.fp12_ints(y.inverse())
        assert _i6(x.c0.inverse()) == _i6(y.c0.inverse())
        cx, cy = _cyclotomic(tb, x), _cyclotomic(jb, y)
        assert convert.fp12_ints(cx) == convert.fp12_ints(cy)
        assert convert.fp12_ints(cx.cyclotomic_square()) \
            == convert.fp12_ints(cy.cyclotomic_square()) \
            == convert.fp12_ints(cx.square())
        assert (x * x.inverse()).is_one()


def _host(mod, vals, make):
    return [make(mod, v) for v in vals]


def test_tcubic_vs_jcubic_and_host():
    """Every TCubicField op on a batch of N against JCubicField on the
    same elements and the host."""
    ha, hb = _host(tb, A6, _fp6), _host(tb, B6, _fp6)
    ta, tb_ = T6.pack(ha), T6.pack(hb)
    ja, jb_ = J6.pack(_host(jb, A6, _fp6)), J6.pack(_host(jb, B6, _fp6))
    cases = {
        "mul": (T6.mul(ta, tb_), J6.mul(ja, jb_),
                [x * y for x, y in zip(ha, hb)]),
        "square": (T6.square(ta), J6.square(ja), [x.square() for x in ha]),
        "add": (T6.add(ta, tb_), J6.add(ja, jb_),
                [x + y for x, y in zip(ha, hb)]),
        "sub": (T6.sub(ta, tb_), J6.sub(ja, jb_),
                [x - y for x, y in zip(ha, hb)]),
        "neg": (T6.neg(ta), J6.neg(ja), [-x for x in ha]),
        "mul_by_v": (T6.mul_by_v(ta), J6.mul_by_v(ja),
                     [x.mul_by_v() for x in ha]),
        "inv": (T6.inv(tb_), J6.inv(jb_),
                [tb.Fq6.zero()] + [x.inverse() for x in hb[1:]]),
    }
    for pw in (1, 2, 3, 6):
        cases[f"frobenius{pw}"] = (T6.frobenius(ta, pw), J6.frobenius(ja, pw),
                                   [x.frobenius(pw) for x in ha])
    for name, (t, j, h) in cases.items():
        got = [_i6(x) for x in T6.unpack_host(t)]
        assert got == [_i6(x) for x in J6.unpack(j)], name
        assert got == [_i6(x) for x in h], name


def test_tfield12_vs_jfield12_and_host():
    """Every TQuadOverCubicField op on a batch of N against
    JQuadOverCubicField and the host; the cyclotomic square on cyclotomic
    elements, where it equals the square."""
    ha, hb = _host(tb, A12, _fp12), _host(tb, B12, _fp12)
    hb = [_fp12(tb, (1,) + (0,) * 11)] + hb[1:]
    hc = [_cyclotomic(tb, x) for x in ha[1:]]
    ja = J12.pack(_host(jb, A12, _fp12))
    jb_ = J12.pack([convert.carry_fp12(x, jb.Fq12) for x in hb])
    jc = J12.pack([convert.carry_fp12(x, jb.Fq12) for x in hc])
    ta, tb_, tc = T12.pack(ha), T12.pack(hb), T12.pack(hc)
    cases = {
        "mul": (T12.mul(ta, tb_), J12.mul(ja, jb_),
                [x * y for x, y in zip(ha, hb)]),
        "square": (T12.square(ta), J12.square(ja), [x.square() for x in ha]),
        "add": (T12.add(ta, tb_), J12.add(ja, jb_),
                [x + y for x, y in zip(ha, hb)]),
        "sub": (T12.sub(ta, tb_), J12.sub(ja, jb_),
                [x - y for x, y in zip(ha, hb)]),
        "conjugate": (T12.conjugate(ta), J12.conjugate(ja),
                      [x.conjugate() for x in ha]),
        "inv": (T12.inv(tb_), J12.inv(jb_), [x.inverse() for x in hb]),
        "cyclotomic_square": (T12.cyclotomic_square(tc),
                              J12.cyclotomic_square(jc),
                              [x.square() for x in hc]),
    }
    for pw in (1, 2, 3, 6):
        cases[f"frobenius{pw}"] = (T12.frobenius(ta, pw),
                                   J12.frobenius(ja, pw),
                                   [x.frobenius(pw) for x in ha])
    for name, (t, j, h) in cases.items():
        got = [convert.fp12_ints(x) for x in T12.unpack_host(t)]
        assert got == [convert.fp12_ints(x) for x in J12.unpack(j)], name
        assert got == [convert.fp12_ints(x) for x in h], name
    one = T12.unpack_host(T12.ones((2,)))
    assert all(x == tb.Fq12.one() for x in one)


def test_convert_fq6_fq12_round_trip():
    h6 = _host(jb, A6, _fp6)
    h12 = _host(jb, A12, _fp12)
    j6, j12 = J6.pack(h6), J12.pack(h12)
    t6 = convert.jax_to_port_fq6(j6, P, device="cpu")
    t12 = convert.jax_to_port_fq12(j12, P, device="cpu")
    assert t6.shape == (6 * 12, N) and t12.shape == (12 * 12, N)
    assert [_i6(x) for x in T6.unpack_host(t6)] == [_i6(x) for x in h6]
    assert [convert.fp12_ints(x) for x in T12.unpack_host(t12)] \
        == [convert.fp12_ints(x) for x in h12]
    assert np.array_equal(convert.port_to_jax_fq6(t6, P), np.asarray(j6))
    assert np.array_equal(convert.port_to_jax_fq12(t12, P), np.asarray(j12))
    # a single element and the host carry both ways
    one = convert.jax_to_port_fq12(j12[2], P, device="cpu")
    assert one.shape == (12 * 12,)
    assert convert.fp12_ints(T12.unpack_host(one)) \
        == convert.fp12_ints(h12[2])
    x = convert.carry_fp12(h12[3], tb.Fq12)
    assert convert.carry_fp12(x, jb.Fq12) == h12[3]


def test_tquad_mul_beta_frobenius_from_base_vs_jquad():
    """The Fq2 helpers the towers added against `JQuadField`'s."""
    T2, J2 = tquad_for(tb.Fq2, "cpu"), jquad_for(jb.Fq2)
    vals = [x[:2] for x in A6]
    t = T2.pack([tb.Fq2(*v) for v in vals])
    j = J2.pack([jb.Fq2(*v) for v in vals])
    for pw in (1, 2, 3):
        assert [tuple(v) for v in T2.unpack(T2.frobenius(t, pw))] \
            == [(int(v.c0), int(v.c1)) for v in J2.unpack(J2.frobenius(j, pw))]
    base = T2.base.pack([v[0] for v in vals])
    jbase = J2.base.pack([v[0] for v in vals])
    assert list(T2.base.unpack(T2.mul_beta(base))) \
        == [int(v) for v in J2.base.unpack(J2.mul_beta(jbase))]
    assert [tuple(v) for v in T2.unpack(T2.from_base(base))] \
        == [(int(v.c0), int(v.c1)) for v in J2.unpack(J2.from_base(jbase))]
