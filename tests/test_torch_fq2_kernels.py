"""The port's Fq2 kernels' plain versions (CPU) against the reference:
`fq2_mul_t_fn` and `affine_kernels_for_fq2` run by the JAX package in
Pallas interpret mode on one 256-lane block, the generic
`affine_pair_add` over `JQuadField`, and the host G2.

The interpret run is one subprocess that sets `CRYPTO_TPU_PALLAS_INTERPRET=1`
before it imports `crypto_tpu` (the flag is read at import time).  The
pairs hold generic sums, doublings, P + (-P) and infinite operands on
either side and both.  Compared: the products, the denominators on live
lanes and their plain limb-0 1 on dead lanes, the doubling and infinity
flags, and x3, y3 wherever the result is finite.
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
from crypto_tpu.fields.jtower import jquad_for
from crypto_tpu.ops.msm_v2 import AffinePoints, affine_pair_add
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.fields.ttower import tquad_for
from crypto_tpu_torch.ops import msm_v2
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.ops.kernels import field_kernels as fk
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = tquad_for(tb.Fq2, "cpu")
P = tb.P
B = 256                 # one block of the reference's Fq2 kernels

SCRIPT = r"""
import json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jtower import jquad_for
from crypto_tpu.ops.pallas.curve_kernels import (affine_kernels_for_fq2,
                                                 fq2_mul_t_fn)
inp = json.load(open(sys.argv[1]))
F2 = jquad_for(jb.Fq2)
L, p = F2.base.L, F2.base.p
n = len(inp["m1"])


def T(vals):
    # (2L, n) transposed layout: c0's limbs in rows [:L], c1's in [L:]
    return F2.pack([jb.Fq2(a, b) for a, b in vals]).reshape(n, 2 * L).T


def ints(t):
    a = np.asarray(t).T.reshape(n, 2, L)
    return [[int(v.c0), int(v.c1)] for v in F2.unpack(jnp.asarray(a))]


def raw(t):
    a = np.asarray(t).T.reshape(n, 2, L).astype(object)
    w = np.array([1 << (15 * j) for j in range(L)], dtype=object)
    return [[int((r[0] * w).sum()), int((r[1] * w).sum())] for r in a]


mul = fq2_mul_t_fn(L, p, F2.base.field.Ninv_R)
prod = ints(mul(T(inp["a"]), T(inp["b"])))
pre, post = affine_kernels_for_fq2(L, p, F2.base.field.Ninv_R)
x1, y1, x2, y2 = (T(inp[k]) for k in ("x1", "y1", "x2", "y2"))
m1, m2 = (jnp.asarray(np.array([inp[k]], np.int32)) for k in ("m1", "m2"))
d, dbl, inf3 = pre(x1, y1, m1, x2, y2, m2)
dv = ints(d)
dinv = T([(1, 0) if a == b == 0 else
          (lambda e: (int(e.c0), int(e.c1)))(jb.Fq2(a, b).inverse())
          for a, b in dv])
x3, y3 = post(x1, y1, x2, y2, dinv, dbl, m1, m2)
json.dump({"prod": prod, "d": dv, "d_raw": raw(d),
           "dbl": np.asarray(dbl)[0].tolist(),
           "inf3": np.asarray(inf3)[0].tolist(),
           "x3": ints(x3), "y3": ints(y3)}, open(sys.argv[2], "w"))
"""


def _points(n, rng):
    """n distinct G2 points P0 + i*S (host additions only)."""
    G = tb.G2.generator()
    pt, step = G.mul_raw(rng.randrange(1, tb.R)), G.mul_raw(
        rng.randrange(1, tb.R))
    out = []
    for _ in range(n):
        out.append(pt.normalize())
        pt = pt + step
    return out


def _pairs():
    """B pairs: generic sums, then doublings, P + (-P) and infinite
    operands on either side and both, spread over the block."""
    rng = random.Random(41)
    pts = _points(B + 1, rng)
    pairs = [(pts[i], pts[i + 1]) for i in range(B)]
    inf = tb.G2.infinity()
    for i in range(0, B, 16):
        pairs[i + 1] = (pairs[i + 1][0], pairs[i + 1][0])          # 2P
        pairs[i + 2] = (pairs[i + 2][0], -pairs[i + 2][0])         # P - P
        pairs[i + 3] = (inf, pairs[i + 3][1])
        pairs[i + 4] = (pairs[i + 4][0], inf)
        pairs[i + 5] = (inf, inf)
    return pairs


def _coords(pts):
    """(x, y) as (c0, c1) int pairs and infinity masks; infinity is 0."""
    xs, ys, ms = [], [], []
    for q in pts:
        if q.is_infinity():
            xs.append((0, 0))
            ys.append((0, 0))
            ms.append(1)
        else:
            x, y = q.to_affine()
            xs.append((int(x.c0), int(x.c1)))
            ys.append((int(y.c0), int(y.c1)))
            ms.append(0)
    return xs, ys, ms


def _port(vals):
    return F.pack([tb.Fq2(a, b) for a, b in vals])


def _ints(t, mont=True):
    return [list(v) for v in F.unpack(t, mont)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The pairs, the port's inputs, and the interpret-mode outputs."""
    pairs = _pairs()
    x1, y1, m1 = _coords([p[0] for p in pairs])
    x2, y2, m2 = _coords([p[1] for p in pairs])
    rng = np.random.default_rng(7)
    rand = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(2)]
            for _ in range(2 * B)]
    a = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + rand[:B - 4]
    b = [(P - 1, P - 1), (0, 1), (1, 0), (0, 0)] + rand[B:2 * B - 4]
    tmp = tmp_path_factory.mktemp("fq2")
    src, dst = tmp / "in.json", tmp / "out.json"
    src.write_text(json.dumps(dict(x1=x1, y1=y1, m1=m1, x2=x2, y2=y2, m2=m2,
                                   a=a, b=b)))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(dst)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ins = (_port(x1), _port(y1), torch.tensor(m1, dtype=torch.int32),
           _port(x2), _port(y2), torch.tensor(m2, dtype=torch.int32))
    return dict(pairs=pairs, ins=ins, a=a, b=b,
                ref=json.loads(dst.read_text()))


def test_fq2_mul_vs_interpret_kernel(case):
    got = fk.fq2_mul_plain(F.base, _port(case["a"]), _port(case["b"]))
    assert _ints(got) == case["ref"]["prod"]
    assert _ints(fk.fq2_mul(F.base, _port(case["a"]), _port(case["b"]))) \
        == case["ref"]["prod"]
    host = [tb.Fq2(*x) * tb.Fq2(*y) for x, y in zip(case["a"], case["b"])]
    assert case["ref"]["prod"] == [[int(v.c0), int(v.c1)] for v in host]


def test_fq2_sqr_vs_reference_square(case):
    """The complex square (two base products) equals the reference's
    `JQuadField.square`, the host square and the Karatsuba product."""
    a = _port(case["a"])
    got = _ints(fk.fq2_sqr_plain(F.base, a))
    assert _ints(fk.fq2_sqr(F.base, a)) == got == _ints(F.square(a))
    assert got == _ints(fk.fq2_mul_plain(F.base, a, a))
    JF = jquad_for(jb.Fq2)
    ref = JF.unpack(JF.square(JF.pack([jb.Fq2(*v) for v in case["a"]])))
    assert got == [[int(v.c0), int(v.c1)] for v in ref]
    assert got == [[int(v.c0), int(v.c1)] for v in
                   (tb.Fq2(*v).square() for v in case["a"])]


def test_fq2_level_vs_interpret_kernels(case):
    ref = case["ref"]
    ins = case["ins"]
    d, dbl, inf3 = ck.affine_level_pre_fq2(F, *ins)
    assert dbl.tolist() == ref["dbl"] and sum(ref["dbl"]) == B // 16
    assert inf3.tolist() == ref["inf3"]
    m1, m2 = ins[2], ins[5]
    dead = (m1 != 0) | (m2 != 0) | (inf3 != 0)
    got_d, got_raw = _ints(d), _ints(d, mont=False)
    for i in range(B):
        if dead[i]:                 # a plain limb-0 1 in c0, in both
            assert got_raw[i] == ref["d_raw"][i] == [1, 0], i
        else:
            assert got_d[i] == ref["d"][i], i
    x3, y3 = ck.affine_level_post_fq2(F, ins[0], ins[1], ins[3], ins[4],
                                      msm_v2.batch_inv_t(F, d), dbl, m1, m2)
    gx, gy = _ints(x3), _ints(y3)
    for i, (p, q) in enumerate(case["pairs"]):
        s = p + q
        assert bool(inf3[i]) == s.is_infinity(), i
        if not s.is_infinity():
            x, y = s.to_affine()
            want = [[int(x.c0), int(x.c1)], [int(y.c0), int(y.c1)]]
            assert [gx[i], gy[i]] == [ref["x3"][i], ref["y3"][i]] == want, i


def test_fq2_level_vs_generic_affine_pair_add(case):
    """The reference's generic total formula over JQuadField (jnp ops)
    gives the same sums and infinity mask."""
    JF = jquad_for(jb.Fq2)

    def jpack(pts):
        xs, ys, ms = _coords(pts)
        return AffinePoints(JF.pack([jb.Fq2(*v) for v in xs]),
                            JF.pack([jb.Fq2(*v) for v in ys]),
                            jnp.asarray(np.array(ms, dtype=bool)))

    pairs = case["pairs"]
    ref = affine_pair_add(JF, jpack([p[0] for p in pairs]),
                          jpack([p[1] for p in pairs]))
    x3, y3, inf3, zero = msm_v2.pair_add_t(F, *case["ins"])
    assert not bool(zero.any())
    rinf = np.asarray(ref.inf)
    assert (inf3 != 0).tolist() == rinf.tolist()
    rx, ry = JF.unpack(ref.x), JF.unpack(ref.y)
    gx, gy = _ints(x3), _ints(y3)
    for i in range(B):
        if not rinf[i]:
            assert gx[i] == [int(rx[i].c0), int(rx[i].c1)], i
            assert gy[i] == [int(ry[i].c0), int(ry[i].c1)], i


@pytest.mark.parametrize("n", [1, 2, 7, 13, 255])
def test_batch_inv_t_fq2_odd_widths(n):
    """Every element times its inverse is one; odd tree levels are padded
    with a plain limb-0 1, a nonzero Fq2 element."""
    rng = np.random.default_rng(n)
    vals = _port([tuple(int.from_bytes(rng.bytes(48), "little") % P
                        for _ in range(2)) for _ in range(n)])
    one = F.mul(vals, msm_v2.batch_inv_t(F, vals))
    assert _ints(one) == [[1, 0]] * n


def test_fq2_wrapper_checks(case):
    x1, y1, m1, x2, y2, m2 = case["ins"]
    G1F = case["ins"][0][:12].contiguous()
    with pytest.raises(ValueError):             # Fq rows to the Fq2 kernel
        ck.affine_level_pre_fq2(F, G1F, G1F, m1, G1F, G1F, m2)
    with pytest.raises(ValueError):             # an Fq2 field to a G1 kernel
        ck.affine_level_pre(F, x1, y1, m1, x2, y2, m2)
    with pytest.raises(ValueError):
        fk.fq2_mul(F.base, x1, y1[:, :5].contiguous())
    with pytest.raises(ValueError):
        fk.fq2_sqr(F.base, G1F)
    with pytest.raises(ValueError):             # the kernel is Fq's only
        fk.fq2_sqr(tfield_for(tb.Fr, "cpu"), x1[:16].contiguous())
    with pytest.raises(ValueError):
        ck.affine_level_post_fq2(F, x1, y1, x2, y2, x1, m1.to(torch.int64),
                                 m1, m2)
