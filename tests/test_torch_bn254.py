"""BN254 in the port: the host module (`crypto_tpu_torch/curves/bn254.py`)
against the reference's (`crypto_tpu/curves/bn254.py`); `TField` over
Fq and Fr at 8 limbs against the reference's `JField` and the host; the
towers (`TQuadField`, `TCubicField` with xi = 9 + u, `TQuadOverCubicField`)
against the reference's host tower and the port's copy; `TCurve` over
G1 and G2, the NTT over Fr (two-adicity 28) and the fixed-base tables
against the host; `convert` at BN254's primes.

Inputs are made from a numpy seed plus the edges; every comparison is
exact (integers, or limbs carried across with `convert`).  The port runs
on the CPU, where each kernel's wrapper takes its plain version.
"""

import random

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bn254 as jbn
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu.fields.jtower import jquad_for
from crypto_tpu.ops.ntt import domain_for as ref_domain_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.fields.ttower import tcubic_for, tfield12_for, \
    tquad_for
from crypto_tpu_torch.ops.fixed_base import table_for
from crypto_tpu_torch.ops.ntt import domain_for

P, R = tbn.P, tbn.R
FIELDS = {"Fq": (jbn.Fq, tbn.Fq), "Fr": (jbn.Fr, tbn.Fr)}


def _values(p: int, n: int, seed: int) -> list:
    """n seeded uniform values, then 0, 1, p - 1 and 2^224 - 1 (all ones
    below the top limb)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    return vals + [0, 1, p - 1, (1 << 224) - 1]


def _port(J_out, p, mont=True):
    return convert.jax_to_port(np.asarray(J_out), p, mont=mont,
                               device="cpu")


def test_host_module_matches_reference():
    """The port's copy has the reference's parameters, generators,
    twist, cofactor and Frobenius constants, and its pairing."""
    assert (tbn.X, tbn.P, tbn.R, tbn.ATE_LOOP, tbn.G2_COFACTOR) == \
        (jbn.X, jbn.P, jbn.R, jbn.ATE_LOOP, jbn.G2_COFACTOR)
    for a, b in ((tbn.XI, jbn.XI), (tbn.TWIST_B, jbn.TWIST_B),
                 (tbn.GAMMA_X, jbn.GAMMA_X), (tbn.GAMMA_Y, jbn.GAMMA_Y)):
        assert (int(a.c0), int(a.c1)) == (int(b.c0), int(b.c1))
    for tc, jc in ((tbn.G1, jbn.G1), (tbn.G2, jbn.G2)):
        assert convert.point_ints(tc.generator()) == \
            convert.point_ints(jc.generator())
    assert tbn.Fr.two_adicity == 28 and tbn.Fq.num_limbs == 8
    g1, g2 = tbn.G1.generator().mul_raw(5), tbn.G2.generator().mul_raw(7)
    jg1 = convert.carry_point(g1, jbn.G1)
    jg2 = convert.carry_point(g2, jbn.G2)
    assert convert.fp12_ints(tbn.pairing(g1, g2)) == \
        convert.fp12_ints(jbn.pairing(jg1, jg2))


def test_convert_at_bn254_primes():
    """17 JAX limbs and 8 port limbs for Fq and Fr; the round trips of
    Fq, Fq2 and Fq12 elements."""
    for jf in (jbn.Fq, jbn.Fr):
        J = jfield_for(jf)
        assert convert.jax_limbs(jf.p) == J.L == 17
        assert convert.port_limbs(jf.p) == 8
        vals = _values(jf.p, 12, 1)
        A = J.pack(vals)
        T = tfield_for(FIELDS["Fq" if jf is jbn.Fq else "Fr"][1], "cpu")
        assert torch.equal(_port(A, jf.p), T.pack(vals))
        assert np.array_equal(convert.port_to_jax(_port(A, jf.p), jf.p),
                              np.asarray(A))
    JF = jquad_for(jbn.Fq2)
    pairs = [(a, b) for a, b in zip(_values(P, 6, 2), _values(P, 6, 3))]
    A2 = JF.pack([jbn.Fq2(a, b) for a, b in pairs])
    T2 = tquad_for(tbn.Fq2, "cpu")
    t2 = convert.jax_to_port_fq2(np.asarray(A2), P, device="cpu")
    assert torch.equal(t2, T2.pack([tbn.Fq2(a, b) for a, b in pairs]))
    assert np.array_equal(convert.port_to_jax_fq2(t2, P), np.asarray(A2))
    x = jbn.Fq12.rand(random.Random(7))
    assert convert.fp12_ints(convert.carry_fp12(x, tbn.Fq12)) == \
        convert.fp12_ints(x)


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_tfield_ops_vs_reference_and_host(name):
    """add, sub, mul, neg, square and inv at 8 limbs against the
    reference's `JField` (carried across) and host integers."""
    jf, tf = FIELDS[name]
    J, T, p = jfield_for(jf), tfield_for(tf, "cpu"), jf.p
    assert T.L == 8 and T.U == 8
    xs, ys = _values(p, 24, 5), _values(p, 24, 6)[::-1]
    A, B = J.pack(xs), J.pack(ys)
    a, b = _port(A, p), _port(B, p)
    for op, ref in (("add", lambda x, y: (x + y) % p),
                    ("sub", lambda x, y: (x - y) % p),
                    ("mul", lambda x, y: x * y % p)):
        jop = J.mul_einsum if op == "mul" else getattr(J, op)
        got = getattr(T, op)(a, b)
        assert torch.equal(got, _port(jop(A, B), p))
        assert list(T.unpack(got)) == [ref(x, y) for x, y in zip(xs, ys)]
    for op, ref in (("neg", lambda x: -x % p),
                    ("square", lambda x: x * x % p)):
        got = getattr(T, op)(a)
        assert torch.equal(got, _port(getattr(J, op)(A), p))
        assert list(T.unpack(got)) == [ref(x) for x in xs]
    inv = T.inv(a[:, -8:].contiguous())
    assert torch.equal(inv, _port(J.inv(A[-8:]), p))
    assert list(T.unpack(inv)) == [pow(x, -1, p) if x else 0
                                   for x in xs[-8:]]


def _fq2(seed, n=8):
    rng = np.random.default_rng(seed)
    out = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)]
    while len(out) < n:
        out.append(tuple(int.from_bytes(rng.bytes(40), "little") % P
                         for _ in range(2)))
    return out


def _ints2(x):
    return int(x.c0), int(x.c1)


def test_tquad_vs_reference_and_both_hosts():
    """Fq2 mul, square and inv (beta = -1 at BN254's p) against the
    reference's `JQuadField`, its host Fq2 and the port's."""
    F, JF = tquad_for(tbn.Fq2, "cpu"), jquad_for(jbn.Fq2)
    assert (F.L, F.U) == (8, 16)
    A, B = _fq2(1), _fq2(2)[::-1]
    ta = F.pack([tbn.Fq2(*x) for x in A])
    tb_ = F.pack([tbn.Fq2(*x) for x in B])
    ja = JF.pack([jbn.Fq2(*x) for x in A])
    jb_ = JF.pack([jbn.Fq2(*x) for x in B])
    cases = (("mul", F.mul(ta, tb_), JF.mul(ja, jb_),
              lambda h, x, y: h(*x) * h(*y)),
             ("square", F.square(ta), JF.square(ja),
              lambda h, x, y: h(*x).square()),
             ("inv", F.inv(ta), JF.inv(ja),
              lambda h, x, y: h(*x).inverse() if any(x) else h(0, 0)))
    for name, got, jgot, host in cases:
        assert torch.equal(got, convert.jax_to_port_fq2(
            np.asarray(jgot), P, device="cpu")), name
        ints = [tuple(v) for v in F.unpack(got)]
        assert ints == [_ints2(host(jbn.Fq2, x, y)) for x, y in zip(A, B)]
        assert ints == [_ints2(host(tbn.Fq2, x, y)) for x, y in zip(A, B)]


def _fq6(mod, pairs):
    out = []
    for i in range(0, len(pairs) - 2, 3):
        out.append(mod.Fq6(*(mod.Fq2(*pairs[i + k]) for k in range(3))))
    return out


def _fp12_ints_list(xs):
    return [convert.fp12_ints(x) for x in xs]


def test_towers_xi_9_plus_u_vs_both_hosts():
    """Fq6 (v^3 = 9 + u) mul, mul_by_v, inv and mul_xi, and Fq12 mul,
    square, inv, Frobenius and the cyclotomic square, against the
    reference's host tower and the port's copy."""
    T6, T12 = tcubic_for(tbn.Fq6, "cpu"), tfield12_for(tbn.Fq12, "cpu")
    assert T6.xi_k == 9
    pairs = _fq2(3, 13) + _fq2(4, 13)[4:]
    x6, jx6 = _fq6(tbn, pairs[:12]), _fq6(jbn, pairs[:12])
    y6, jy6 = _fq6(tbn, pairs[9:21]), _fq6(jbn, pairs[9:21])
    tx, ty = T6.pack(x6), T6.pack(y6)

    def ints6(vals):
        return [tuple(_ints2(c) for c in (v.c0, v.c1, v.c2)) for v in vals]

    got = T6.unpack_host(T6.mul(tx, ty))
    assert ints6(got) == ints6([a * b for a, b in zip(jx6, jy6)])
    got = T6.unpack_host(T6.mul_by_v(tx))
    assert ints6(got) == ints6([a.mul_by_v() for a in jx6])
    got = T6.unpack_host(T6.inv(tx))
    assert ints6(got) == ints6([a.inverse() for a in jx6])
    c = tquad_for(tbn.Fq2, "cpu").pack([tbn.Fq2(*x) for x in pairs[:8]])
    xi = tquad_for(tbn.Fq2, "cpu").unpack(T6.mul_xi(c))
    assert [tuple(v) for v in xi] == [_ints2(jbn.Fq2(*x) * jbn.XI)
                                      for x in pairs[:8]]
    f = [tbn.Fq12(a, b) for a, b in zip(x6, y6)]
    jf = [jbn.Fq12(a, b) for a, b in zip(jx6, jy6)]
    g = [tbn.Fq12(b, a) for a, b in zip(x6, y6)]
    jg = [jbn.Fq12(b, a) for a, b in zip(jx6, jy6)]
    tf_, tg = T12.pack(f), T12.pack(g)
    for got, want in ((T12.mul(tf_, tg), [a * b for a, b in zip(jf, jg)]),
                      (T12.square(tf_), [a.square() for a in jf]),
                      (T12.inv(tf_), [a.inverse() for a in jf]),
                      (T12.frobenius(tf_, 1), [a.frobenius(1) for a in jf]),
                      (T12.frobenius(tf_, 3), [a.frobenius(3) for a in jf])):
        assert _fp12_ints_list(T12.unpack_host(got)) == \
            _fp12_ints_list(want)
    # the cyclotomic square on cyclotomic elements: f^((p^6 - 1)(p^2 + 1))
    cyc = [(a.conjugate() * a.inverse()) for a in f]
    cyc = [a.frobenius(2) * a for a in cyc]
    got = T12.unpack_host(T12.cyclotomic_square(T12.pack(cyc)))
    assert got.tolist() == [a.cyclotomic_square() for a in cyc] == \
        [a.square() for a in cyc]


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_tcurve_vs_host(group):
    """add (with doubling, P + (-P) and infinity), double, neg, to_affine
    and eq over BN254 G1 and G2 against both host curves."""
    curve, jcurve = getattr(tbn, group), getattr(jbn, group)
    tc = tcurve_for(curve, "cpu")
    rng = np.random.default_rng(9)
    G = curve.generator()
    logs = [int(rng.integers(1, 1 << 62)) for _ in range(6)]
    ps = [G.mul_raw(k) for k in logs] + [curve.infinity(), G.mul_raw(3)]
    qs = [G.mul_raw(k) for k in logs[::-1]] + [G.mul_raw(5),
                                               -G.mul_raw(3)]
    qs[2] = ps[2]                                        # P + P
    tp, tq = tc.pack_points(ps), tc.pack_points(qs)
    s = tc.add(tp, tq)
    assert tc.unpack(s) == [a + b for a, b in zip(ps, qs)]
    jsum = [convert.carry_point(a, jcurve) + convert.carry_point(b, jcurve)
            for a, b in zip(ps, qs)]
    assert [convert.point_ints(q.normalize()) for q in tc.unpack(s)] == \
        [convert.point_ints(q.normalize()) for q in jsum]
    assert tc.unpack(tc.double(tp)) == [a.double() for a in ps]
    assert tc.unpack(tc.neg(tp)) == [-a for a in ps]
    aff = tc.to_affine(s)
    assert aff.inf.tolist() == [q.is_infinity() for q in jsum]
    assert bool(tc.eq(s, tc.add(tq, tp)).all())


def _naive_dft(vals, w):
    n = len(vals)
    pw = [pow(w, i, R) for i in range(n)]
    return [sum(v * pw[i * j % n] for j, v in enumerate(vals)) % R
            for i in range(n)]


@pytest.mark.parametrize("n", [8, 32])
def test_ntt_over_bn254_fr(n):
    """The port's NTT over BN254 Fr against the reference's domain and a
    naive DFT; the coset transforms round trip."""
    port, ref = domain_for(tbn.Fr, n, "cpu"), ref_domain_for(jbn.Fr, n)
    assert (port.n, port.w, port.w_inv, port.n_inv) == \
        (ref.n, ref.w, ref.w_inv, ref.n_inv)
    vals = _values(R, n - 4, n)
    fwd = port.ntt_ints(vals)
    assert fwd == ref.ntt_ints(vals) == _naive_dft(vals, port.w)
    assert port.ntt_ints(fwd, inverse=True) == vals
    T = port.T
    a = T.pack(vals)
    assert torch.equal(port.coset_intt(port.coset_ntt(a)), a)
    assert torch.equal(port.intt(port.ntt(a)), a)


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_fixed_base_tables_vs_host(group):
    """The fixed-base table of a BN254 base at full width against the
    host products."""
    curve = getattr(tbn, group)
    base = curve.generator().mul_raw(11)
    rng = np.random.default_rng(12)
    scalars = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "little") % R
                               for _ in range(3)]
    got = table_for(curve, base, device="cpu").mul_many_host(scalars)
    assert got == [base.mul_raw(s) for s in scalars]


def test_packed_points_carry_across():
    """A packed BN254 G1 batch equals the reference's packed batch,
    carried across limb for limb."""
    from crypto_tpu.curves.jcurve import jcurve_for
    G = tbn.G1.generator()
    pts = [G.mul_raw(k) for k in (2, 3, 5)] + [tbn.G1.infinity()]
    jpts = [convert.carry_point(q, jbn.G1) for q in pts]
    J = jcurve_for(jbn.G1).pack_points(
        [q if q.is_infinity() else q.normalize() for q in jpts])
    T = tcurve_for(tbn.G1, "cpu").pack_points(pts)
    for a, b in zip(T, J):
        assert torch.equal(a, _port(b, P))
    assert isinstance(T, TPoints)
