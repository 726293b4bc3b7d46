"""The port's TCurve (crypto_tpu_torch) against the reference JCurve and the
host curve, on BLS12-381 G1.

Both packages run the same formulas (add-2007-bl, dbl-2009-l) on canonical
field values, so their Jacobian outputs, carried across with `convert`,
must be equal limb for limb; each result is also checked against
`curves/sw.py` on the host.  The port runs on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.curves.jcurve import JPoints, jcurve_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for

rng = random.Random(41)
JC = jcurve_for(jb.G1)
TC = tcurve_for(tb.G1, "cpu")
P = jb.P


def _host_points(dlogs):
    G = tb.G1.generator()
    return [tb.G1.infinity() if d == 0 else G.mul_raw(d) for d in dlogs]


def _pair(jpts: JPoints) -> TPoints:
    return TPoints(*(convert.jax_to_port(np.asarray(t), P, device="cpu")
                     for t in jpts))


def _jax_pack(host_pts) -> JPoints:
    """Pack the port's host points through the JAX package (same ints)."""
    jpts = [jb.G1.infinity() if q.is_infinity() else
            jb.G1.point_from_affine(*(jb.Fq(int(c)) for c in q.to_affine()))
            for q in host_pts]
    return JC.pack_points(jpts)


def _dlogs(n):
    return [rng.randrange(1, tb.R) for _ in range(n)]


def _equal(tp: TPoints, jp: JPoints):
    for a, b in zip(tp, _pair(jp)):
        assert torch.equal(a, b)


def test_pack_unpack_infinity():
    pts = _host_points(_dlogs(5) + [0])
    tp = TC.pack_points(pts)
    _equal(tp, _jax_pack(pts))
    assert TC.unpack(tp) == pts
    assert TC.is_infinity(tp).tolist() == [False] * 5 + [True]
    inf = TC.infinity((3,))
    assert TC.unpack(inf) == [tb.G1.infinity()] * 3
    assert list(TC.F.unpack(inf.X)) == [1, 1, 1]
    assert list(TC.F.unpack(inf.Y)) == [1, 1, 1]


@pytest.mark.parametrize("case", ["generic", "double", "inverse", "left_inf",
                                  "right_inf", "both_inf"])
def test_add_cases(case):
    """The left operand is a doubled point (Z != 1), so the formulas see a
    general Jacobian input; the right one is affine-packed."""
    a = _host_points(_dlogs(8))
    if case in ("left_inf", "both_inf"):
        a = [tb.G1.infinity()] * 8
    a2 = [q.double() for q in a]
    b = {
        "generic": _host_points(_dlogs(8)),
        "double": a2,
        "inverse": [-q for q in a2],
        "left_inf": _host_points(_dlogs(8)),
        "right_inf": [tb.G1.infinity()] * 8,
        "both_inf": [tb.G1.infinity()] * 8,
    }[case]
    ja, ta = JC.double(_jax_pack(a)), TC.double(TC.pack_points(a))
    _equal(ta, ja)
    out = TC.add(ta, TC.pack_points(b))
    _equal(out, JC.add(ja, _jax_pack(b)))
    assert TC.unpack(out) == [x + y for x, y in zip(a2, b)]


def test_double_neg_select_to_affine():
    pts = _host_points(_dlogs(6) + [0, 0])
    tp, jp = TC.pack_points(pts), _jax_pack(pts)
    dbl = TC.double(tp)
    _equal(dbl, JC.double(jp))
    assert TC.unpack(dbl) == [q.double() for q in pts]
    ng = TC.neg(dbl)
    _equal(ng, JC.neg(JC.double(jp)))
    assert TC.unpack(ng) == [-q.double() for q in pts]
    mask = torch.tensor([i % 2 == 0 for i in range(8)])
    sel = TC.select(mask, tp, dbl)
    _equal(sel, JC.select(np.asarray(mask), jp, JC.double(jp)))
    aff = TC.to_affine(dbl)
    jaff = JC.to_affine(JC.double(jp))
    for a, b in ((aff.X, jaff.X), (aff.Y, jaff.Y)):
        assert torch.equal(a, convert.jax_to_port(np.asarray(b), P,
                                                     device="cpu"))
    assert torch.equal(aff.inf, torch.tensor(np.asarray(jaff.inf)))
    for i, q in enumerate(pts):
        if q.is_infinity():
            assert bool(aff.inf[i])
        else:
            x, y = q.double().to_affine()
            assert TC.F.unpack(aff.X[:, i]) == int(x)
            assert TC.F.unpack(aff.Y[:, i]) == int(y)
