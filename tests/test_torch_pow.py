"""The port's fixed-exponent power (`field_kernels.mont_pow`, its plain
version on the CPU) against the reference's `JField.inv` / `pow_fixed`
on the CPU and the host field; a host-integer model of the Fq2
product's lazy reduction (`csrc/field.cuh` `fq2_mul`) against the host
Fq2 product and the port's plain `fq2_mul_plain`; and word-by-word
models of `field.cuh`'s even/odd Montgomery product (`mont_mul_eo`), its
reduction (`redc`), the wide square (`sqr_wide`), and the Fq2 square
built on them (`fq2_sqr_karatsuba`) against the host integers,
`fq2_sqr_plain` and the host Fq2 square.  The models run at BLS12-381's
p (L = 12 limbs, 3 spare bits) and at BN254's (L = 8, 2 spare bits),
every REDC input asserted below p*R and every dropped carry 0.

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
from crypto_tpu.curves import bn254 as jbn
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.fields.ttower import tquad_for
from crypto_tpu_torch.ops.kernels.field_kernels import (POW_WORDS,
                                                        fq2_mul_plain,
                                                        fq2_sqr_plain,
                                                        mont_mul_plain,
                                                        mont_pow,
                                                        mont_pow_plain)
from crypto_tpu_torch.testing import cap_threads

cap_threads()

FIELDS = {"Fq": (jb.Fq, tb.Fq), "Fr": (jb.Fr, tb.Fr),
          "bn254.Fq": (jbn.Fq, tbn.Fq)}


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
@pytest.mark.parametrize("name", ["Fq", "Fr", "bn254.Fq"])
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


def _tensor_chain(a, e, mod):
    """`mont_pow_plain`'s chain as the card runs it: `mont_mul_plain`
    products."""
    acc = a.clone()
    for bit in bin(e)[3:]:
        acc = mont_mul_plain(acc, acc, mod)
        if bit == "1":
            acc = mont_mul_plain(acc, a, mod)
    return acc


@pytest.mark.parametrize("e", [1, 2, 0b1011011, 0x1F2E3D4C5B6A, "p-2"])
@pytest.mark.parametrize("name", ["Fq", "Fr", "bn254.Fq"])
def test_mont_pow_ints_is_the_tensor_chain(name, e):
    """On CPU tensors `mont_pow_plain` runs its chain on the host's
    integers (`mont_pow_ints`): equal to the `mont_mul_plain` chain the
    plain version runs on the card, bit for bit, on operands below R that
    are not canonical too (p, p + 1, 2p, R - p, R - 2, R - 1)."""
    from crypto_tpu_torch.ops.kernels.field_kernels import (limbs32,
                                                            mont_pow_ints)
    _, tf = FIELDS[name]
    T, p = tfield_for(tf, "cpu"), tf.p
    R = 1 << (32 * T.L)
    e = p - 2 if e == "p-2" else e
    rng = np.random.default_rng(5)
    vals = [0, 1, p - 1, p, p + 1, 2 * p, R - p, R - 2, R - 1] + [
        int.from_bytes(rng.bytes(4 * T.L), "little") for _ in range(7)]
    a = torch.tensor([limbs32(v, T.L) for v in vals], dtype=torch.int64).T
    a = torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)
    a = a.contiguous()
    got = mont_pow_ints(a, e, T.mod)
    assert torch.equal(got, _tensor_chain(a, e, T.mod))
    assert torch.equal(got, mont_pow_plain(a, e, T.mod))


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

MASK = (1 << 32) - 1


class _Model:
    """A modulus as the kernels see it: p in L 32-bit words, R = 2^(32L),
    -p^-1 mod 2^32, and the host Fq2 over it."""

    def __init__(self, mod, L: int):
        self.P, self.L, self.Fq2 = mod.P, L, mod.Fq2
        self.R = 1 << (32 * L)
        self.N0INV = (-pow(self.P, -1, 1 << 32)) % (1 << 32)
        self.PW = [(self.P >> (32 * j)) & MASK for j in range(L)]
        assert self.P < self.R // 4          # the spare bits the kernels use


MODELS = {"bls12_381": _Model(tb, 12), "bn254": _Model(tbn, 8)}
CURVES = list(MODELS)
PORT = {"bls12_381": tb, "bn254": tbn}


def _redc(m: _Model, T: int) -> tuple:
    """The value of field.cuh redc on T < p*R: L rows of m_i = t_0 * n0inv
    mod 2^32 and t = (t + m_i*p) / 2^32 over T's low L words, then T's high
    words added and p subtracted once.  Returns (result, value before the
    subtraction)."""
    P, R = m.P, m.R
    assert 0 <= T < P * R
    t = T % R
    for _ in range(m.L):
        mi = (t & MASK) * m.N0INV & MASK
        t = (t + mi * P) >> 32
    assert t <= P
    u = t + (T >> (32 * m.L))
    return (u - P if u >= P else u), u


def _fq2_mul_lazy(m: _Model, a0, a1, b0, b1) -> tuple:
    """c0 = redc(v0 + p^2 - v1), c1 = redc(t - v0 - v1) with v0 = a0*b0,
    v1 = a1*b1, t = (a0 + a1)(b0 + b1), the sums unreduced."""
    P, R = m.P, m.R
    sa, sb = a0 + a1, b0 + b1
    assert sa < R and sb < R                  # L words, no carry out
    v0, v1, t = a0 * b0, a1 * b1, sa * sb
    assert max(v0, v1, t) < 1 << (64 * m.L)   # 2L words
    T0, T1 = v0 + P * P - v1, t - v0 - v1
    assert 0 <= T0 < 2 * P * P < P * R and 0 <= T1 < 2 * P * P
    (c0, u0), (c1, u1) = _redc(m, T0), _redc(m, T1)
    assert u0 < 2 * P and u1 < 2 * P and c0 < P and c1 < P
    return c0, c1


def _edges(m: _Model) -> list:
    """0, 1, p - 1 (a0 + a1 >= p, and v0 = 0 with v1 = (p - 1)^2), p // 2
    and a value three bits below R."""
    P = m.P
    return [0, 1, P - 1, P // 2, (m.R >> 4) + 7]


def _host_mont_product(m: _Model, a, b):
    """The canonical Montgomery limbs of the host Fq2 product of the
    elements whose Montgomery limbs are a and b."""
    P, R = m.P, m.R
    rinv = pow(R, -1, P)
    x = m.Fq2(a[0] * rinv, a[1] * rinv) * m.Fq2(b[0] * rinv, b[1] * rinv)
    return int(x.c0) * R % P, int(x.c1) * R % P


@pytest.mark.parametrize("curve", CURVES)
def test_fq2_mul_lazy_model_at_edges(curve):
    """Every pair of edge values per component."""
    m = MODELS[curve]
    edges = _edges(m)
    pairs = list(itertools.product(edges, edges))
    for a, b in itertools.product(pairs, pairs):
        assert _fq2_mul_lazy(m, *a, *b) == _host_mont_product(m, a, b)


@pytest.mark.parametrize("curve", CURVES)
def test_fq2_mul_lazy_model_random_and_plain(curve):
    """Seeded canonical limbs: the model, the host product and the port's
    plain Karatsuba over three Montgomery products agree."""
    m = MODELS[curve]
    P = m.P
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(4 * 40)]
    a = [tuple(vals[i:i + 2]) for i in range(0, 80, 2)]
    b = [tuple(vals[i:i + 2]) for i in range(80, 160, 2)]
    a += [(P - 1, P - 1), (0, P - 1), (P - 1, 0)]
    b += [(P - 1, P - 1), (0, P - 1), (P - 1, 0)]
    model = [_fq2_mul_lazy(m, *x, *y) for x, y in zip(a, b)]
    assert model == [_host_mont_product(m, x, y) for x, y in zip(a, b)]
    F = tquad_for(m.Fq2, "cpu")
    ta = F.pack([m.Fq2(*x) for x in a], mont=False)
    tbb = F.pack([m.Fq2(*y) for y in b], mont=False)
    plain = F.unpack(fq2_mul_plain(F.base, ta, tbb), mont=False)
    assert [tuple(v) for v in plain] == model


# ---------------------------------------------------------------------------
# the even/odd Montgomery forms and the wide square, word by word
# ---------------------------------------------------------------------------

def _words(x: int, n: int) -> list:
    return [(x >> (32 * j)) & MASK for j in range(n)]


def _num(w) -> int:
    return sum(v << (32 * j) for j, v in enumerate(w))


class _Chain:
    """A PTX carry chain: each step adds two words and the flag."""

    def __init__(self):
        self.cf = 0

    def add(self, x, y, cin=True):
        s = x + y + (self.cf if cin else 0)
        self.cf = s >> 32
        return s & MASK


def _mad_pass(t, off, a, aoff, b, n2, ch):
    """mad_pass<n2, 0>(t + off, a + aoff, b): t[off + j], t[off + j + 1]
    += a[aoff + j]*b for j = 0, 2, ... < n2 in one chain, the first
    product without carry in; the carry out is left in ch."""
    for j in range(0, n2, 2):
        w = a[aoff + j] * b
        t[off + j] = ch.add(t[off + j], w & MASK, cin=j > 0)
        t[off + j + 1] = ch.add(t[off + j + 1], w >> 32)


def _eo_shift_chain(L, od, a_odd_top, mul, bi, ch):
    """The odd chain after a row's shift: od = (od >> 64) + a_odd*bi with
    the flag's carry in; its last high word ends the chain (no carry
    out)."""
    for j in range(0, L - 2, 2):
        w = mul[j] * bi
        od[j] = ch.add(od[j + 2], w & MASK)
        od[j + 1] = ch.add(od[j + 3], w >> 32)
    w = a_odd_top * bi
    od[L - 2] = ch.add(0, w & MASK)
    top = (w >> 32) + ch.cf
    assert top >> 32 == 0
    od[L - 1] = top


def _eo_reduce_tail(m: _Model, ev, od):
    """mi = ev[0]*n0inv; od += p_odd*mi (no carry out); ev += p_even*mi,
    its carry into od's top word."""
    L = m.L
    mi = ev[0] * m.N0INV & MASK
    ch = _Chain()
    _mad_pass(od, 0, m.PW, 1, mi, L, ch)
    assert ch.cf == 0
    _mad_pass(ev, 0, m.PW, 0, mi, L, ch)
    od[L - 1] += ch.cf
    assert od[L - 1] >> 32 == 0 and ev[0] == 0
    return mi


def _eo_final(m: _Model, ev, od) -> tuple:
    """(ev + (od >> 32) less p once, the value before)."""
    t = _num(ev) + _num(od[1:])
    assert t < m.R
    return (t - m.P if t >= m.P else t), t


def _mont_mul_eo(m: _Model, A: int, B: int) -> int:
    """field.cuh mont_mul_eo on t = ev + 2^32*od, for A < R - p."""
    L, P = m.L, m.P
    assert 0 <= A < m.R - P and 0 <= B < m.R
    a, b = _words(A, L), _words(B, L)
    ev = [0] * L
    od = [0] * L
    for j in range(0, L, 2):                  # the first row: t = a*b_0
        ev[j], ev[j + 1] = _words(a[j] * b[0], 2)
        od[j], od[j + 1] = _words(a[j + 1] * b[0], 2)
    _eo_reduce_tail(m, ev, od)
    for i in range(1, L):
        ev, od = od, ev                       # the shift swaps the roles
        ch = _Chain()
        ev[0] = ch.add(ev[0], od[1], cin=False)
        _eo_shift_chain(L, od, a[L - 1], a[1:], b[i], ch)
        ch = _Chain()
        _mad_pass(ev, 0, a, 0, b[i], L, ch)
        od[L - 1] += ch.cf
        assert od[L - 1] >> 32 == 0
        _eo_reduce_tail(m, ev, od)
    r, t = _eo_final(m, od, ev)               # roles after the last swap
    assert t < A + P
    return r


def _redc_eo(m: _Model, T: int) -> int:
    """field.cuh redc word by word: the reduction rows on even/odd
    accumulators, then T's high half, for 0 <= T < p*R."""
    L, P, PW = m.L, m.P, m.PW
    assert 0 <= T < P * m.R
    ev, od = _words(T, L), [0] * L
    mi = ev[0] * m.N0INV & MASK
    for j in range(0, L, 2):
        od[j], od[j + 1] = _words(PW[j + 1] * mi, 2)
    ch = _Chain()
    _mad_pass(ev, 0, PW, 0, mi, L, ch)
    od[L - 1] += ch.cf
    assert ev[0] == 0
    for _ in range(1, L):
        ev, od = od, ev
        ch = _Chain()
        ev[0] = ch.add(ev[0], od[1], cin=False)
        mi = ev[0] * m.N0INV & MASK
        _eo_shift_chain(L, od, PW[L - 1], PW[1:], mi, ch)
        ch = _Chain()
        _mad_pass(ev, 0, PW, 0, mi, L, ch)
        od[L - 1] += ch.cf
        assert od[L - 1] >> 32 == 0 and ev[0] == 0
    t = _num(od) + _num(ev[1:])
    assert t <= P
    t += T >> (32 * L)
    assert t < 2 * P
    return t - P if t >= P else t


def _sqr_wide(m: _Model, A: int) -> int:
    """field.cuh sqr_wide: the cross products row by row on w + 2^32*od,
    od added into w in one chain, doubled, then the squares."""
    L = m.L
    a = _words(A, L)
    w, od = [0] * (2 * L), [0] * (2 * L)
    for i in range(L - 1):
        n_a, n_b = (L - i) // 2, (L - 1 - i) // 2
        ch = _Chain()
        _mad_pass(od, 2 * i, a, i + 1, a[i], 2 * n_a, ch)
        if (L - i) % 2:
            assert od[i + L - 1] == 0
            od[i + L - 1] = ch.cf
        else:
            assert ch.cf == 0
        if n_b:
            ch = _Chain()
            _mad_pass(w, 2 * i + 2, a, i + 2, a[i], 2 * n_b, ch)
            if (L - 1 - i) % 2:
                assert w[i + L] == 0
                w[i + L] = ch.cf
            else:
                assert ch.cf == 0
    assert od[2 * L - 2] == od[2 * L - 1] == 0 and w[0] == 0
    assert w[2 * L - 2] == w[2 * L - 1] == 0
    ch = _Chain()
    for j in range(1, 2 * L - 1):
        w[j] = ch.add(w[j], od[j - 1], cin=j > 1)
    assert ch.cf == 0
    cross = _num(w)
    assert cross == sum(a[i] * a[j] << (32 * (i + j))
                        for i in range(L) for j in range(i + 1, L))
    assert cross >> (32 * (2 * L - 1)) == 0
    out = 2 * cross + sum(x * x << (64 * i) for i, x in enumerate(a))
    assert out < 1 << (64 * L)
    return out


def _word_edges(m: _Model) -> list:
    """0, 1, p - 1, all ones, a third of all ones, the top bit alone, all
    ones but one bit, and alternating nibbles."""
    R, bits = m.R, 32 * m.L
    return [0, 1, m.P - 1, R - 1, (R - 1) // 3, 1 << (bits - 1),
            R - 1 - (1 << 200), int("F0" * (bits // 8), 16)]


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sqr_wide_model_equals_square(seed, curve):
    """sqr_wide's word algorithm equals a*a at edge word patterns (0, 1,
    p - 1, all ones, alternating, sparse) and seeded L-word values."""
    m = MODELS[curve]
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(4 * m.L), "little") for _ in range(200)]
    for a in (_word_edges(m) if seed == 0 else []) + vals:
        assert _sqr_wide(m, a) == a * a


def _host_mont_mul(m: _Model, a, b):
    return a * b * pow(m.R, -1, m.P) % m.P


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("bound", ["p", "2p"])
def test_mont_mul_eo_model(bound, curve):
    """mont_mul_eo's rows on even/odd accumulators (every dropped carry
    asserted 0): the canonical Montgomery product for inputs below p, and
    below 2p, the edge of its contract; equal to mont_mul_plain."""
    m = MODELS[curve]
    P = m.P
    top = P if bound == "p" else 2 * P
    rng = np.random.default_rng(11 if bound == "p" else 12)
    vals = [int.from_bytes(rng.bytes(48), "little") % top for _ in range(400)]
    edges = [0, 1, top - 1, P - 1, top // 2]
    pairs = list(itertools.product(edges, edges)) + list(zip(vals[::2],
                                                             vals[1::2]))
    for a, b in pairs:
        assert _mont_mul_eo(m, a, b) == _host_mont_mul(m, a, b)
    if bound == "p":
        T = tfield_for(PORT[curve].Fq, "cpu")
        a = T.pack([x for x, _ in pairs], mont=False)
        b = T.pack([y for _, y in pairs], mont=False)
        got = [int(v) for v in T.unpack(mont_mul_plain(a, b, T.mod),
                                        mont=False)]
        assert got == [_mont_mul_eo(m, x, y) for x, y in pairs]


@pytest.mark.parametrize("curve", CURVES)
def test_redc_eo_and_mont_sqr_model(curve):
    """redc (on even/odd accumulators) at the ends of its range [0, p*R)
    and on squares; mont_sqr = redc(sqr_wide(a)) is mont_mul's result for
    canonical a."""
    m = MODELS[curve]
    P, R = m.P, m.R
    rng = np.random.default_rng(13)
    Ts = [0, 1, P * R - 1, P * P, 4 * P * P, (P - 1) ** 2, R * (P - 1)]
    Ts += [int.from_bytes(rng.bytes(96), "little") % (P * R)
           for _ in range(300)]
    for T in Ts:
        assert _redc_eo(m, T) == T * pow(R, -1, P) % P
    for a in [0, 1, P - 1, P // 2] + [int.from_bytes(rng.bytes(48), "little")
                                     % P for _ in range(200)]:
        assert _redc_eo(m, _sqr_wide(m, a)) == _host_mont_mul(m, a, a)


def _fq2_sqr_karatsuba(m: _Model, a0, a1) -> tuple:
    """field.cuh fq2_sqr_karatsuba: c0 = redc(v0 + p^2 - v1), c1 =
    redc(t - v0 - v1) with v0 = a0^2, v1 = a1^2, t = (a0 + a1)^2 by
    sqr_wide."""
    P = m.P
    s = a0 + a1
    assert s < m.R
    v0, v1, t = _sqr_wide(m, a0), _sqr_wide(m, a1), _sqr_wide(m, s)
    T0, T1 = v0 + P * P - v1, t - v0 - v1
    assert 0 <= T0 < 2 * P * P and 0 <= T1 < 2 * P * P
    return _redc_eo(m, T0), _redc_eo(m, T1)


def _host_mont_square(m: _Model, a):
    """The canonical Montgomery limbs of the host Fq2 square of the element
    whose Montgomery limbs are a."""
    P, R = m.P, m.R
    rinv = pow(R, -1, P)
    x = m.Fq2(a[0] * rinv, a[1] * rinv)
    x = x * x
    return int(x.c0) * R % P, int(x.c1) * R % P


def _sqr_edges(P: int) -> list:
    return [(P - 1, P - 1), (P - 1, 0), (0, P - 1), (0, 0), (1, 0), (0, 1),
            (P // 2, P // 2), (1, 1), (P - 1, 1), (1, P - 1)]


@pytest.mark.parametrize("curve", CURVES)
def test_fq2_sqr_model_at_edges_and_plain(curve):
    """The Fq2 square kernel's Karatsuba at the edges ((p-1)(1+u), (p-1) +
    0u, 0 + (p-1)u, a0 = a1, 0, 1, u) and seeded canonical limbs equals
    the host Fq2 square and the port's plain fq2_sqr_plain."""
    m = MODELS[curve]
    P = m.P
    rng = np.random.default_rng(21)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(80)]
    elems = _sqr_edges(P) + [tuple(vals[i:i + 2]) for i in range(0, 80, 2)]
    elems += [(v, v) for v in vals[:5]] + [(v, 0) for v in vals[5:10]]
    got = [_fq2_sqr_karatsuba(m, *e) for e in elems]
    assert got == [_host_mont_square(m, e) for e in elems]
    F = tquad_for(m.Fq2, "cpu")
    x = F.pack([m.Fq2(*e) for e in elems], mont=False)
    plain = F.unpack(fq2_sqr_plain(F.base, x), mont=False)
    assert [tuple(v) for v in plain] == got
