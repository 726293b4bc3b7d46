"""The port's Fq2 (`TQuadField`, plain versions on the CPU) against the
reference's `JQuadField` on the CPU and against both host towers, the
reference's and the port's copy, exactly; the `convert` round trip of Fq2
in both directions; the port's BLS12-381 G2 constants; and `TCurve` over
G2 against the host curve.

The inputs are random Fq2 elements from a numpy seed plus the edges 0, 1,
u and (p - 1)(1 + u).
"""

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jtower import jquad_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import tcurve_for
from crypto_tpu_torch.fields.ttower import TQuadField, tquad_for
from crypto_tpu_torch.testing import cap_threads

cap_threads()

P = tb.P
F = tquad_for(tb.Fq2, "cpu")
JF = jquad_for(jb.Fq2)
N = 16


def _pairs(seed: int):
    """N (c0, c1) int pairs: the edges, then uniform values mod p."""
    rng = np.random.default_rng(seed)
    out = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)]
    while len(out) < N:
        out.append(tuple(int.from_bytes(rng.bytes(48), "little") % P
                         for _ in range(2)))
    return out


def _port(pairs):
    return F.pack([tb.Fq2(a, b) for a, b in pairs])


def _jax(pairs):
    return JF.pack([jb.Fq2(a, b) for a, b in pairs])


def _ints(t):
    return [tuple(v) for v in F.unpack(t)]


def _jints(a):
    return [(int(v.c0), int(v.c1)) for v in JF.unpack(a)]


def _host(pairs, tower):
    return [tower(a, b) for a, b in pairs]


A, B = _pairs(1), _pairs(2)

BINARY = {
    "mul": (lambda f, a, b: f.mul(a, b), lambda a, b: a * b),
    "add": (lambda f, a, b: f.add(a, b), lambda a, b: a + b),
    "sub": (lambda f, a, b: f.sub(a, b), lambda a, b: a - b),
}
UNARY = {
    "square": (lambda f, a: f.square(a), lambda a: a.square()),
    "neg": (lambda f, a: f.neg(a), lambda a: -a),
    "double": (lambda f, a: f.double(a), lambda a: a.double()),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops(op):
    dev_fn, host_fn = BINARY[op]
    got = _ints(dev_fn(F, _port(A), _port(B)))
    assert got == _jints(dev_fn(JF, _jax(A), _jax(B)))
    for tower in (jb.Fq2, tb.Fq2):
        want = [host_fn(a, b) for a, b in zip(_host(A, tower),
                                              _host(B, tower))]
        assert got == [(int(v.c0), int(v.c1)) for v in want]


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops(op):
    dev_fn, host_fn = UNARY[op]
    got = _ints(dev_fn(F, _port(A)))
    assert got == _jints(dev_fn(JF, _jax(A)))
    for tower in (jb.Fq2, tb.Fq2):
        assert got == [(int(v.c0), int(v.c1))
                       for v in map(host_fn, _host(A, tower))]


def test_inv_zero_maps_to_zero():
    got = _ints(F.inv(_port(A)))
    assert got == _jints(JF.inv(_jax(A)))
    assert got[0] == (0, 0)
    for tower in (jb.Fq2, tb.Fq2):
        assert got[1:] == [(int(v.c0), int(v.c1))
                           for v in (x.inverse() for x in _host(A[1:], tower))]
    one = F.unpack(F.mul(F.inv(_port(A)), _port(A)))
    assert [tuple(v) for v in one[1:]] == [(1, 0)] * (N - 1)


def test_conjugate_mul_base_select_predicates():
    a = _port(A)
    assert _ints(F.conjugate(a)) == [(int(v.c0), int(v.c1)) for v in
                                     (x.conjugate() for x in _host(A, tb.Fq2))]
    s = F.base.pack([7] * N)
    assert _ints(F.mul_base(a, s)) == _ints(F.mul(a, F.pack([7] * N)))
    assert F.is_zero(a).tolist() == [True] + [False] * (N - 1)
    # A and B share the four edges and differ after them
    assert F.eq(a, _port(A)).all()
    assert F.eq(a, _port(B)).tolist() == [True] * 4 + [False] * (N - 4)
    mask = torch.arange(N) % 2 == 0
    picked = _ints(F.select(mask, a, _port(B)))
    assert picked == [A[i] if i % 2 == 0 else B[i] for i in range(N)]
    assert _ints(F.ones((3,))) == [(1, 0)] * 3
    assert _ints(F.zeros((2,))) == [(0, 0)] * 2
    assert F.U == 24 and F.L == 12 and F.base.U == 12


def test_convert_round_trip_both_ways():
    ja = np.asarray(_jax(A))                          # (N, 2, L_jax)
    t = convert.jax_to_port_fq2(ja, P, device="cpu")
    assert torch.equal(t, _port(A))
    assert np.array_equal(convert.port_to_jax_fq2(t, P), ja)
    t2 = convert.jax_to_port_fq2(convert.port_to_jax_fq2(_port(B), P), P,
                                 device="cpu")
    assert torch.equal(t2, _port(B))


def test_beta_must_be_minus_one():
    from crypto_tpu_torch.fields.tower import QuadExtField
    with pytest.raises(ValueError, match="beta"):
        TQuadField(QuadExtField(tb.Fq, tb.Fq(2), "bad"), "cpu")


def test_g2_constants_match_reference():
    G = tb.G2.generator()
    assert G.is_on_curve()
    assert G.mul_raw(tb.R).is_infinity()       # mul_raw: __mul__ reduces mod r
    assert not G.mul_raw(tb.R - 1).is_infinity()
    jx, jy = jb.G2.generator().to_affine()
    x, y = G.to_affine()
    assert (int(x.c0), int(x.c1), int(y.c0), int(y.c1)) == \
        (int(jx.c0), int(jx.c1), int(jy.c0), int(jy.c1))
    assert tb.G2_COFACTOR == jb.G2_COFACTOR
    assert (int(tb.XI.c0), int(tb.XI.c1)) == (int(jb.XI.c0), int(jb.XI.c1))
    assert (int(tb.G2.b.c0), int(tb.G2.b.c1)) == (4, 4)


def test_tcurve_g2_against_host():
    """`tcurve_for(G2)` takes a `TQuadField`; its total add (generic pairs,
    a doubling, P + (-P), infinity), double and to_affine equal the host."""
    tc = tcurve_for(tb.G2, "cpu")
    assert isinstance(tc.F, TQuadField)
    G = tb.G2.generator()
    p, q = G.mul_raw(0x1234567), G.mul_raw(0xABCDEF0123)
    inf = tb.G2.infinity()
    lhs = [p, p, p, inf, p]
    rhs = [q, p, -p, q, inf]
    P1, P2 = tc.pack_points(lhs), tc.pack_points(rhs)
    assert tc.unpack(tc.add(P1, P2)) == [a + b for a, b in zip(lhs, rhs)]
    assert tc.unpack(tc.double(P1)) == [a.double() for a in lhs]
    aff = tc.to_affine(tc.add(P1, P2))
    want = [a + b for a, b in zip(lhs, rhs)]
    assert aff.inf.tolist() == [w.is_infinity() for w in want]
    for i, w in enumerate(want):
        if not w.is_infinity():
            x, y = w.to_affine()
            assert F.unpack_host(aff.X[:, i]) == x
            assert F.unpack_host(aff.Y[:, i]) == y
