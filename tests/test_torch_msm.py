"""The port's MSM planning and its MSM against the reference
`crypto_tpu.ops.msm_v2` and the host, at small sizes on the CPU.

Digits, bucket plans and staircase bands must equal the reference's
exactly; the MSM result must equal the reference's and the host sum.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.ops import msm_v2 as jm
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.ops import msm_v2 as tm
from crypto_tpu_torch.testing import cap_threads

cap_threads()

rng = random.Random(61)


def _digits(scalars, c, nbits):
    W = (nbits + c) // c
    sb = tm.scalars_to_bytes(scalars, (W * c + 7) // 8)
    return (tm.device_digits(torch.from_numpy(sb.copy()), c, nbits),
            jm.device_digits(jnp.asarray(sb), c, nbits))


@pytest.mark.parametrize("c,nbits", [(16, 255), (8, 32)])
def test_device_digits(c, nbits):
    scs = [rng.randrange(0, min(tb.R, 1 << nbits)) for _ in range(40)]
    scs += [0, (1 << nbits) - 1 if nbits < 255 else tb.R - 1]
    got, ref = _digits(scs, c, nbits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _plans(n=96, c=8, nbits=32):
    scs = [rng.randrange(0, 1 << nbits) for _ in range(n)]
    scs[3] = scs[4] = scs[5]                 # a shared bucket
    scs[7] = 0
    inf = np.zeros(n, dtype=bool)
    inf[9] = True
    dt, dj = _digits(scs, c, nbits)
    B = 1 << (c - 1)
    got = tm._plan_windows_sorted(dt, torch.from_numpy(inf), B)
    ref = jm._plan_windows_sorted(dj, jnp.asarray(inf), B)
    return got, ref, B


def test_plan_windows_sorted():
    got, ref, _B = _plans()
    names = ["order", "starts_p", "counts_p", "invperm", "nprofile", "occs"]
    for name, g, r in zip(names, got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r)), name


def test_build_bands_and_cover():
    got, _ref, B = _plans(n=256)
    nprof = got[4].numpy().max(axis=0)
    occ = int(got[5].max())
    for max_h, min_q in ((64, 4096), (4, 32), (2, 64)):
        bands = tm._build_bands(nprof, occ, B, max_h=max_h, min_q=min_q)
        assert bands == jm._build_bands(nprof, occ, B, max_h=max_h,
                                        min_q=min_q)
        assert tm._bands_cover(bands, nprof, occ)
        assert jm._bands_cover(bands, nprof, occ)
    short = ((B, 1, 0),)
    assert tm._bands_cover(short, nprof, occ) == \
        jm._bands_cover(short, nprof, occ)
    narrow = tuple((32, h, r) for (_q, h, r) in
                   tm._build_bands(nprof, occ, B, max_h=4, min_q=32))
    assert tm._bands_cover(narrow, nprof, occ) == \
        jm._bands_cover(narrow, nprof, occ)


@pytest.mark.parametrize("N,c", [(1 << 20, 16), (1 << 12, 8)])
def test_model_bands(N, c):
    W = (255 + c) // c
    top_keys = (min(1 << 255, tb.R) >> ((W - 1) * c)) + 1
    assert tm._model_bands(N, c, 64, top_keys) == \
        jm._model_bands(N, c, max_h=64, top_keys=top_keys)
    assert tm._model_bands(N, c) == jm._model_bands(N, c)
    assert np.array_equal(tm._poisson_profile(100, 3.5, 128)[0],
                          jm._poisson_profile(100, 3.5, 128)[0])


def test_msm_vs_reference_and_host():
    n = 64
    G = tb.G1.generator()
    dlogs = [rng.randrange(1, tb.R) for _ in range(n)]
    pts = [G.mul_raw(d) for d in dlogs]
    pts[3] = tb.G1.infinity()
    scs = [rng.randrange(0, 1 << 32) for _ in range(n)]
    scs[5] = 0
    got = tm.msm_device_scheduled(tb.G1, pts, scs, c=8, nbits=32,
                                  device="cpu")
    expect = G.mul_raw(sum(s * d for i, (s, d) in enumerate(zip(scs, dlogs))
                           if i != 3) % tb.R)
    assert got == expect
    jG = jb.G1.generator()
    jpts = [jb.G1.infinity() if i == 3 else jG.mul_raw(d)
            for i, d in enumerate(dlogs)]
    ref = jm.msm_device_scheduled(jb.G1, jpts, scs, c=8, nbits=32)
    assert [int(v) for v in ref.normalize().to_affine()] == \
        [int(v) for v in got.normalize().to_affine()]
