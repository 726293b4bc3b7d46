"""The port's doubling-free level kernels (plain versions, CPU) against the
reference: `affine_kernels_fast` run by the JAX package in Pallas
interpret mode, the JAX `affine_pair_add` and the host curve.

The reference's fast pre/post run on 512 lanes in a subprocess that sets
`CRYPTO_TPU_PALLAS_INTERPRET=1` before it imports `crypto_tpu` (the flag
is read at import time).  Canonical integers are compared: the
denominators on live lanes, x3 and y3 on lanes that did not collide, the
infinity masks everywhere, and which lanes have a zero denominator; the
port's one-launch level (`affine_level_fast`) is the pre, the inversion
and the post in one call.  The fast chunked level must agree with the
one-launch level lane for lane where its thread has no zero total; a
doubling and a P + (-P) pair must give a zero total (or d) and set
`pair_add_t`'s zero mask, and leave every other lane exact.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu.ops.msm_v2 import AffinePoints, affine_pair_add
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops import msm_v2
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = tfield_for(tb.Fq, "cpu")
G = tb.G1.generator()
INF = tb.G1.infinity()
rng = random.Random(83)

SCRIPT = r"""
import json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu.ops.pallas.curve_kernels import affine_kernels_fast
inp = json.load(open(sys.argv[1]))
F = jfield_for(jb.Fq)
pre, post = affine_kernels_fast(F.L, F.p, F.field.Ninv_R, block_b=512)
x1, y1, x2, y2 = (F.pack(inp[k]).T for k in ("x1", "y1", "x2", "y2"))
m1, m2 = (jnp.asarray(np.array([inp[k]], np.int32)) for k in ("m1", "m2"))
d, inf3 = pre(x1, y1, m1, x2, y2, m2)
dv = [int(v) for v in F.unpack(np.asarray(d).T)]
dinv = F.pack([pow(v, -1, F.p) if v else 1 for v in dv]).T
x3, y3 = post(x1, y1, x2, y2, dinv, m1, m2)
json.dump({"d": dv, "inf3": np.asarray(inf3)[0].tolist(),
           "x3": [int(v) for v in F.unpack(np.asarray(x3).T)],
           "y3": [int(v) for v in F.unpack(np.asarray(y3).T)]},
          open(sys.argv[2], "w"))
"""


def _rand_point():
    return G.mul_raw(rng.randrange(1, tb.R))


def _coords(pts):
    """Affine ints and infinity masks; an infinite point is (0, 0)."""
    xs, ys, ms = [], [], []
    for q in pts:
        if q.is_infinity():
            xs.append(0)
            ys.append(0)
            ms.append(1)
        else:
            x, y = q.to_affine()
            xs.append(int(x))
            ys.append(int(y))
            ms.append(0)
    return xs, ys, ms


def _pairs(n, collisions=True):
    """n pairs: random distinct points, an infinite operand on either or
    both sides and, with `collisions`, a doubling and a P + (-P)."""
    pairs = [(_rand_point(), _rand_point()) for _ in range(n)]
    P = _rand_point()
    pairs[1] = (INF, pairs[1][1])
    pairs[2] = (pairs[2][0], INF)
    pairs[3] = (INF, INF)
    if collisions:
        pairs[5] = (P, P)
        pairs[n - 2] = (P, -P)
    return pairs


def _port_inputs(pairs):
    x1, y1, m1 = _coords([p[0] for p in pairs])
    x2, y2, m2 = _coords([p[1] for p in pairs])
    return (F.pack(x1), F.pack(y1), torch.tensor(m1, dtype=torch.int32),
            F.pack(x2), F.pack(y2), torch.tensor(m2, dtype=torch.int32))


def _ints(t):
    return [int(v) for v in np.atleast_1d(F.unpack(t))]


def _host_sums(pairs):
    """(x3, y3, inf3) of each pair on the host."""
    out = []
    for a, b in pairs:
        s = a + b
        out.append((0, 0, True) if s.is_infinity()
                   else tuple(int(v) for v in s.to_affine()) + (False,))
    return out


def test_fast_pre_post_vs_interpret_kernels(tmp_path):
    pairs = _pairs(512)
    x1, y1, m1 = _coords([p[0] for p in pairs])
    x2, y2, m2 = _coords([p[1] for p in pairs])
    src, dst = tmp_path / "in.json", tmp_path / "out.json"
    src.write_text(json.dumps(dict(x1=x1, y1=y1, m1=m1, x2=x2, y2=y2,
                                   m2=m2)))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(dst)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(dst.read_text())

    ins = _port_inputs(pairs)
    d, inf3 = ck.affine_level_pre_fast_plain(F, *ins)
    zero = F.is_zero(d)
    assert zero.nonzero().flatten().tolist() == [5, 510]
    assert [v == 0 for v in ref["d"]] == zero.tolist()
    live = [not (a or b) for a, b in zip(m1, m2)]
    got_d = _ints(d)
    assert all(g == r for g, r, ok in zip(got_d, ref["d"], live) if ok)
    assert inf3.tolist() == ref["inf3"]
    # the one-launch level: pre, the zero substitute, batch_inv_t, post
    x3, y3, inf3_l, zero_l = ck.affine_level_fast(F, *ins)
    assert torch.equal(inf3_l, inf3) and torch.equal(zero_l, zero)
    host = _host_sums(pairs)
    gx, gy = _ints(x3), _ints(y3)
    for i in range(len(pairs)):
        if zero[i] or inf3[i]:
            continue
        assert (gx[i], gy[i]) == (ref["x3"][i], ref["y3"][i]), i
        assert (gx[i], gy[i], False) == host[i], i


def _fast_chunked(ins):
    """The fast chunked level through `pair_add_t`'s own steps, for a
    pair count that is a multiple of K."""
    prefix, total, inf3 = ck.chunked_level_prefix_fast(F, *ins)
    assert torch.equal(prefix[:, -total.shape[1]:], total)
    zt = F.is_zero(total)
    total = total.clone()
    total[0] |= zt.to(torch.int32)
    x3, y3 = ck.chunked_level_down_fast(F, *ins, prefix,
                                        msm_v2.batch_inv_t(F, total))
    return x3, y3, inf3, zt


def test_fast_chunked_vs_pre_post_reference_and_host():
    pairs = _pairs(64, collisions=False)
    ins = _port_inputs(pairs)
    x3, y3, inf3, zt = _fast_chunked(ins)
    assert not bool(zt.any())
    px, py, pinf, pzero = ck.affine_level_fast(F, *ins)
    assert not bool(pzero.any())
    assert torch.equal(inf3, pinf)
    live = inf3 == 0
    assert torch.equal(x3[:, live], px[:, live])
    assert torch.equal(y3[:, live], py[:, live])

    JF = jfield_for(jb.Fq)

    def jpack(pts):
        xs, ys, ms = _coords(pts)
        return AffinePoints(JF.pack(xs), JF.pack(ys),
                            jnp.asarray(np.array(ms, dtype=bool)))

    ref = affine_pair_add(JF, jpack([p[0] for p in pairs]),
                          jpack([p[1] for p in pairs]))
    rinf = np.asarray(ref.inf)
    assert (inf3.numpy() != 0).tolist() == rinf.tolist()
    rx, ry = JF.unpack(ref.x), JF.unpack(ref.y)
    gx, gy = _ints(x3), _ints(y3)
    for i, (hx, hy, hinf) in enumerate(_host_sums(pairs)):
        assert bool(inf3[i]) == hinf
        if not hinf:
            assert (gx[i], gy[i]) == (int(rx[i]), int(ry[i])) == (hx, hy)


@pytest.mark.parametrize("level", ["chunked", "pre_post"])
@pytest.mark.parametrize("n_pairs", [64, 61])
def test_collision_sets_zero_mask(level, n_pairs, monkeypatch):
    """A doubling (lane 5) and a P + (-P) (lane n - 2) give a zero total or
    d, and `pair_add_t` marks the lanes they spoil; every other lane is
    exact.  61 pairs make pair_add_t pad to the chunk granularity."""
    pairs = _pairs(n_pairs)
    ins = _port_inputs(pairs)
    if level == "chunked":
        monkeypatch.setattr(msm_v2, "CHUNK_MIN_PAIRS", 1)
        padded = n_pairs + (-n_pairs) % msm_v2.CHUNK_PAD
        if n_pairs % ck.CHUNK_K == 0:
            _, total, _ = ck.chunked_level_prefix_fast(F, *ins)
            assert F.is_zero(total).nonzero().flatten().tolist() == sorted(
                {5 % (n_pairs // 8), (n_pairs - 2) % (n_pairs // 8)})
        T = padded // ck.CHUNK_K
        spoiled = {lane for lane in range(n_pairs)
                   if lane % T in (5 % T, (n_pairs - 2) % T)}
    else:
        spoiled = {5, n_pairs - 2}
    trace = {}
    x3, y3, inf3, zero = msm_v2.pair_add_t(F, *ins, fast=True, trace=trace)
    assert set(zero.nonzero().flatten().tolist()) == spoiled
    assert trace["level_pairs"] == [n_pairs]
    (M, windows, K, zchunks), = trace["zero_chunks"]
    assert (M, windows, K) == (n_pairs, 1,
                               ck.CHUNK_K if level == "chunked" else 1)
    assert bool(zchunks.any())
    gx, gy = _ints(x3), _ints(y3)
    for i, (hx, hy, hinf) in enumerate(_host_sums(pairs)):
        if i in spoiled:
            continue
        assert bool(inf3[i]) == hinf
        if not hinf:
            assert (gx[i], gy[i]) == (hx, hy), i
    safe = msm_v2.pair_add_t(F, *ins)
    assert not bool(safe[3].any())
