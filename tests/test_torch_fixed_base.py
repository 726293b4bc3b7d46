"""The port's fixed-base window tables (`crypto_tpu_torch/ops/fixed_base.py`)
and `TCurve.eq` against the reference (`crypto_tpu/ops/fixed_base.py`,
`JCurve.eq`) and the host scalar product, on the CPU.

The port is held to the host product at full width on both curves
(scalars 0 to r - 1) and to the reference's table at the reference's own
test widths, 64 bits on G1 and 16 on G2: its full-width tables take from
half a minute (G1) to minutes (G2) to compile on the CPU.  Points are
compared as points, carried across by `convert.carry_point`.
"""

import random

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.curves.jcurve import jcurve_for
from crypto_tpu.ops.fixed_base import table_for as ref_table_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
from crypto_tpu_torch.ops import fixed_base
from crypto_tpu_torch.ops.fixed_base import FixedBaseTable, table_for
from crypto_tpu_torch.utils import msm as umsm

R = tb.R
rng = random.Random(91)


def _scalars(n: int, bits: int = 255) -> list:
    top = min(1 << bits, R)
    edges = [0, 1, 2, 255, 256, top - 1, top - 2]
    if bits >= 255:
        edges += [1 << 254, (1 << 128) - 1]
    return edges + [rng.randrange(top) for _ in range(n - len(edges))]


def _base(curve):
    return curve.generator().mul_raw(rng.randrange(1, R))


# one full-width G1 table for every test that needs it (a table takes
# seconds to build on the CPU)
BASE_G1 = _base(tb.G1)


def test_g1_mul_many_matches_host_at_full_width():
    scalars = _scalars(20)
    got = table_for(tb.G1, BASE_G1, device="cpu").mul_many_host(scalars)
    assert len(got) == len(scalars)
    for s, g in zip(scalars, got):
        assert g == BASE_G1 * s, s


def test_g1_mul_many_matches_reference_at_64_bits():
    scalars = _scalars(20, bits=64)
    tab = table_for(tb.G1, BASE_G1, nbits=64, device="cpu")
    assert tab.W == 8
    got = tab.mul_many_host(scalars)
    ref = ref_table_for(rb.G1, convert.carry_point(BASE_G1, rb.G1),
                        nbits=64).mul_many_host(scalars)
    for s, g, r in zip(scalars, got, ref):
        assert g == BASE_G1 * s, s
        assert g == convert.carry_point(r, tb.G1), s


def test_g2_mul_many_matches_host_at_full_width():
    base = _base(tb.G2)
    scalars = _scalars(20)
    got = table_for(tb.G2, base, device="cpu").mul_many_host(scalars)
    for s, g in zip(scalars, got):
        assert g == base * s, s


def test_g2_mul_many_matches_reference_at_16_bits():
    base = _base(tb.G2)
    scalars = _scalars(20, bits=16)
    tab = table_for(tb.G2, base, nbits=16, device="cpu")
    assert tab.W == 2
    got = tab.mul_many_host(scalars)
    ref = ref_table_for(rb.G2, convert.carry_point(base, rb.G2), nbits=16) \
        .mul_many_host(scalars)
    for s, g, r in zip(scalars, got, ref):
        assert g == base * s, s
        assert g == convert.carry_point(r, tb.G2), s


@pytest.mark.parametrize("curve", [tb.G1, tb.G2], ids=["g1", "g2"])
def test_table_rows_are_digit_multiples(curve):
    base = _base(curve)
    tab = table_for(curve, base, nbits=24, device="cpu")
    X, Y, Z = tab.table
    assert tuple(X.shape) == (tab.tc.F.U, 3, 256)
    for w, d in ((0, 0), (0, 1), (0, 255), (1, 0), (1, 37), (2, 128),
                 (2, 255)):
        pt = tab.tc.unpack(TPoints(X[:, w, d], Y[:, w, d], Z[:, w, d]))[0]
        assert pt == base.mul_raw(d << (8 * w)), (w, d)


def test_digits_take_the_scalar_mod_2_to_the_table_width():
    """The reference's digit loop: W bytes of the scalar, little-endian,
    higher bits dropped (negative scalars in two's complement)."""
    tab = FixedBaseTable.__new__(FixedBaseTable)
    tab.W = 2
    tab.tc = tcurve_for(tb.G1, "cpu")
    scalars = [0, 0x1234, 0xABCDEF, -1, (1 << 16) - 1]
    want = []
    for s in scalars:
        row = []
        for _ in range(2):
            row.append(s & 0xFF)
            s >>= 8
        want.append(row)
    assert tab.digits(scalars).tolist() == want


def test_table_for_caches_by_base_width_and_device():
    base = _base(tb.G1)
    t1 = table_for(tb.G1, base, nbits=16, device="cpu")
    assert table_for(tb.G1, base.double() - base, nbits=16,
                     device="cpu") is t1
    assert table_for(tb.G1, base, nbits=24, device="cpu") is not t1
    assert t1.tc.F.device.type == "cpu"


def test_multiply_same_group_elem_on_host_and_device(monkeypatch):
    base = BASE_G1
    scalars = _scalars(12, bits=64)
    want = [base * s for s in scalars]
    assert umsm.multiply_field_elems_with_same_group_elem(
        base, scalars, device="cpu") == want
    monkeypatch.setattr(umsm, "DEVICE_FIXED_BASE_THRESHOLD", 4)
    calls = []
    real = fixed_base.FixedBaseTable.mul_many

    def counted(self, sc):
        calls.append(len(sc))
        return real(self, sc)

    monkeypatch.setattr(fixed_base.FixedBaseTable, "mul_many", counted)
    assert umsm.multiply_field_elems_with_same_group_elem(
        base, scalars, device="cpu") == want
    assert calls == [len(scalars)]


@pytest.mark.parametrize("curve", [tb.G1, tb.G2], ids=["g1", "g2"])
def test_tcurve_eq(curve):
    """Equal points under different Z, a point against its negation and
    against another point, infinity against itself and a point."""
    tc = tcurve_for(curve, "cpu")
    F = tc.F
    ps = [_base(curve) for _ in range(3)]
    inf = curve.infinity()
    left = [ps[0], ps[0], ps[0], ps[1], inf, inf, ps[2]]
    right = [ps[0], -ps[0], ps[1], ps[1], inf, ps[2], inf]
    want = [a == b for a, b in zip(left, right)]
    assert want == [True, False, False, True, True, False, False]
    P = tc.pack_points(left)
    Q = tc.pack_points(right)
    # the right side rescaled: (X z^2, Y z^3, Z z) is the same point
    z = F.pack([curve.K.rand(rng) for _ in right])
    z2 = F.mul(z, z)
    Qs = TPoints(F.mul(Q.X, z2), F.mul(Q.Y, F.mul(z2, z)), F.mul(Q.Z, z))
    assert tc.eq(P, Q).tolist() == want
    assert tc.eq(P, Qs).tolist() == want
    assert tc.eq(Qs, P).tolist() == want
    if curve is tb.G1:
        jc = jcurve_for(rb.G1)
        rl = jc.pack_points([convert.carry_point(p, rb.G1) for p in left])
        rr = jc.pack_points([convert.carry_point(p, rb.G1) for p in right])
        assert np.asarray(jc.eq(rl, rr)).tolist() == want
    assert tc.eq(P, Qs).dtype == torch.bool
