"""The port's level kernels' plain versions (the one-launch affine_level
and chunked_level prefix/down) against the reference `msm_v2.affine_pair_add`
and the host curve, on BLS12-381 G1.

One set of pairs (the eight cases of tests/test_msm_v2.py, random pairs
and dead lanes) is packed by the JAX package and carried into the port
with `convert`.  Live lanes' x3, y3 and every lane's inf3 must be equal;
dead lanes are unspecified in both packages.  The wrappers take the plain
versions here (CPU tensors).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu.ops.msm_v2 import AffinePoints, affine_pair_add
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops import msm_v2
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.testing import cap_threads

cap_threads()

rng = random.Random(23)
JF = jfield_for(jb.Fq)
F = tfield_for(tb.Fq, "cpu")
P = jb.P


def _cases(n_random: int):
    G = tb.G1.generator()
    P1, P2 = (G.mul_raw(rng.randrange(1, tb.R)) for _ in range(2))
    inf = tb.G1.infinity()
    pairs = [(P1, P2), (P1, P1), (P1, -P1), (inf, P2), (P1, inf),
             (inf, inf), (P2, P2), (P1, P2.double())]
    for _ in range(n_random):
        a, b = (G.mul_raw(rng.randrange(1, tb.R)) for _ in range(2))
        pairs.append((a, b))
    return pairs


def _pack(pts):
    """(JAX AffinePoints, port (x, y, mask)) of the same points."""
    xs, ys, infs = [], [], []
    for q in pts:
        if q.is_infinity():
            xs.append(0)
            ys.append(0)
            infs.append(True)
        else:
            x, y = q.to_affine()
            xs.append(int(x))
            ys.append(int(y))
            infs.append(False)
    J = AffinePoints(JF.pack(xs), JF.pack(ys), jnp.asarray(np.array(infs)))
    T = (convert.jax_to_port(np.asarray(J.x), P, device="cpu"),
         convert.jax_to_port(np.asarray(J.y), P, device="cpu"),
         torch.tensor(infs, dtype=torch.int32))
    return J, T


def _check(pairs, x3, y3, inf3):
    JA, _ = _pack([p[0] for p in pairs])
    JB, _ = _pack([p[1] for p in pairs])
    ref = affine_pair_add(JF, JA, JB)
    rinf = torch.tensor(np.asarray(ref.inf))
    assert torch.equal(inf3 != 0, rinf)
    live = ~rinf
    rx = convert.jax_to_port(np.asarray(ref.x), P, device="cpu")
    ry = convert.jax_to_port(np.asarray(ref.y), P, device="cpu")
    assert torch.equal(x3[:, live], rx[:, live])
    assert torch.equal(y3[:, live], ry[:, live])
    for i, (a, b) in enumerate(pairs):
        s = a + b
        assert bool(inf3[i]) == s.is_infinity()
        if not s.is_infinity():
            x, y = s.to_affine()
            assert F.unpack(x3[:, i]) == int(x)
            assert F.unpack(y3[:, i]) == int(y)


def _inputs(pairs):
    _, (x1, y1, m1) = _pack([p[0] for p in pairs])
    _, (x2, y2, m2) = _pack([p[1] for p in pairs])
    return x1, y1, m1, x2, y2, m2


@pytest.mark.parametrize("n_random", [0, 21])
def test_affine_level_vs_reference(n_random):
    pairs = _cases(n_random)
    x1, y1, m1, x2, y2, m2 = _inputs(pairs)
    d, dbl, inf3 = ck.affine_level_pre_plain(F, x1, y1, m1, x2, y2, m2)
    assert dbl.tolist()[:8] == [0, 1, 0, 0, 0, 0, 1, 0]
    assert not bool(F.is_zero(d).any())
    # the one-launch level: pre, batch_inv_t of d, post
    x3, y3, inf3_l = ck.affine_level(F, x1, y1, m1, x2, y2, m2)
    assert torch.equal(inf3_l, inf3)
    _check(pairs, x3, y3, inf3)


def _special_in_every_strip(n_pairs: int):
    """n_pairs pairs in CHUNK_K strips of T = n_pairs / CHUNK_K: strip j
    holds a fresh set of `_cases(0)`'s eight pairs (P + P, P + (-P), P1,
    P2 or both infinite among them) at threads (s + j) mod T, s the case,
    so every strip, the down pass's recomputed ones (j > 0) among them,
    holds every case, each at another thread; random pairs elsewhere."""
    T = n_pairs // ck.CHUNK_K
    pairs = _cases(n_pairs)[8:]
    for j in range(ck.CHUNK_K):
        for s, pair in enumerate(_cases(0)):
            pairs[(s + j) % T + j * T] = pair
    return pairs


@pytest.mark.parametrize("n_pairs, special_every_strip", [
    pytest.param(64, False, id="64"), pytest.param(61, False, id="61"),
    pytest.param(64, True, id="64-special-in-every-strip"),
    pytest.param(128, True, id="128-special-in-every-strip")])
def test_chunked_level_vs_reference(n_pairs, special_every_strip,
                                    monkeypatch):
    """A multiple of the chunk group, a ragged count that `pair_add_t`
    pads with dead lanes, and the special pairs in every strip."""
    pairs = _special_in_every_strip(n_pairs) if special_every_strip \
        else _cases(n_pairs - 8)
    x1, y1, m1, x2, y2, m2 = _inputs(pairs)
    if n_pairs % ck.CHUNK_K == 0:
        prefix, total, dbl, inf3 = ck.chunked_level_prefix(F, x1, y1, m1,
                                                           x2, y2, m2)
        assert total.shape == (12, n_pairs // ck.CHUNK_K)
        # the prefix's last strip holds the chunk totals
        assert torch.equal(prefix[:, -total.shape[1]:], total)
        tinv = msm_v2.batch_inv_t(F, total)
        x3, y3 = ck.chunked_level_down(F, x1, y1, m1, x2, y2, m2, prefix,
                                       tinv, dbl)
    else:
        monkeypatch.setattr(msm_v2, "CHUNK_MIN_PAIRS", 1)
        x3, y3, inf3, zero = msm_v2.pair_add_t(F, x1, y1, m1, x2, y2, m2)
        assert not bool(zero.any())
    _check(pairs, x3, y3, inf3)
    # the chunked and the one-launch level give the same values
    px3, py3, inf2 = ck.affine_level(F, x1, y1, m1, x2, y2, m2)
    live = inf2 == 0
    assert torch.equal(inf2, inf3)
    assert torch.equal(px3[:, live], x3[:, live])
    assert torch.equal(py3[:, live], y3[:, live])


def test_level_wrapper_checks():
    x1, y1, m1, x2, y2, m2 = _inputs(_cases(0))
    six = [t[..., :6].contiguous() for t in (x1, y1, m1, x2, y2, m2)]
    with pytest.raises(ValueError, match="multiple"):
        ck.chunked_level_prefix(F, *six)
    with pytest.raises(ValueError):
        ck.affine_level(F, x1, y1, m1.to(torch.int64), x2, y2, m2)
    Fr = tfield_for(tb.Fr, "cpu")
    with pytest.raises(ValueError):
        ck.affine_level_fast(Fr, x1[:8].contiguous(), y1[:8].contiguous(),
                             m1, x2[:8].contiguous(), y2[:8].contiguous(),
                             m2)


def test_batch_inv_t_odd_widths():
    for n in (1, 2, 7, 13):
        vals = [rng.randrange(1, P) for _ in range(n)]
        got = F.unpack(msm_v2.batch_inv_t(F, F.pack(vals)))
        assert list(np.atleast_1d(got)) == [pow(v, -1, P) for v in vals]
