"""The port's level, Fq2 and gather kernels at 8 limbs (BN254; their plain
versions, on the CPU) against the reference and the host.

The reference's kernels take the limb count (`affine_kernels_for`,
`affine_kernels_fast`, `affine_kernels_for_fq2`, `fq2_mul_t_fn`, each
`(base.L, p, ...)`); one subprocess that sets
`CRYPTO_TPU_PALLAS_INTERPRET=1` before it imports `crypto_tpu` runs them
in Pallas interpret mode at BN254's p on one 256-lane block, as the
reference's tests run them at BLS12-381's.  The pairs hold generic sums,
doublings, P + (-P) and infinite operands on either side and both.
Compared: the Fq2 products, the denominators on live lanes, the flags,
and x3, y3 wherever the result is finite; then both chunked levels
against the pre/post and the host sums, the Fq2 square against the host,
and the gather and its tables at 8 and 16 words a row.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.fields.ttower import tquad_for
from crypto_tpu_torch.ops import msm_v2
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.ops.kernels import field_kernels as fk
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = tfield_for(tbn.Fq, "cpu")
F2 = tquad_for(tbn.Fq2, "cpu")
P = tbn.P
B = 256                 # one block of the reference's kernels

SCRIPT = r"""
import json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from crypto_tpu.curves import bn254 as jbn
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu.fields.jtower import jquad_for
from crypto_tpu.ops.pallas.curve_kernels import (
    affine_kernels_fast, affine_kernels_for, affine_kernels_for_fq2,
    fq2_mul_t_fn)
inp = json.load(open(sys.argv[1]))
F = jfield_for(jbn.Fq)
F2 = jquad_for(jbn.Fq2)
L, p, ninv = F.L, F.p, F.field.Ninv_R
n = len(inp["g1"]["m1"])
out = {}


def T2(vals):
    return F2.pack([jbn.Fq2(a, b) for a, b in vals]).reshape(n, 2 * L).T


def ints2(t):
    a = np.asarray(t).T.reshape(n, 2, L)
    return [[int(v.c0), int(v.c1)] for v in F2.unpack(jnp.asarray(a))]


def T1(vals):
    return F.pack(vals).T


def ints1(t):
    return [int(v) for v in F.unpack(np.asarray(t).T)]


def masks(g):
    return (jnp.asarray(np.array([g[k]], np.int32)) for k in ("m1", "m2"))


out["prod"] = ints2(fq2_mul_t_fn(L, p, ninv)(T2(inp["a"]), T2(inp["b"])))
g = inp["g2"]
x1, y1, x2, y2 = (T2(g[k]) for k in ("x1", "y1", "x2", "y2"))
m1, m2 = masks(g)
pre, post = affine_kernels_for_fq2(L, p, ninv)
d, dbl, inf3 = pre(x1, y1, m1, x2, y2, m2)
dv = ints2(d)
dinv = T2([(1, 0) if a == b == 0 else
           (lambda e: (int(e.c0), int(e.c1)))(jbn.Fq2(a, b).inverse())
           for a, b in dv])
x3, y3 = post(x1, y1, x2, y2, dinv, dbl, m1, m2)
out["g2"] = {"d": dv, "dbl": np.asarray(dbl)[0].tolist(),
             "inf3": np.asarray(inf3)[0].tolist(), "x3": ints2(x3),
             "y3": ints2(y3)}
g = inp["g1"]
x1, y1, x2, y2 = (T1(g[k]) for k in ("x1", "y1", "x2", "y2"))
m1, m2 = masks(g)
for name, fn in (("fast", affine_kernels_fast), ("total", affine_kernels_for)):
    pre, post = fn(L, p, ninv, block_b=n)
    res = pre(x1, y1, m1, x2, y2, m2)
    dv = ints1(res[0])
    dinv = T1([pow(v, -1, p) if v else 1 for v in dv])
    if name == "fast":
        x3, y3 = post(x1, y1, x2, y2, dinv, m1, m2)
        rec = {"inf3": np.asarray(res[1])[0].tolist()}
    else:
        x3, y3 = post(x1, y1, x2, y2, dinv, res[1], m1, m2)
        rec = {"dbl": np.asarray(res[1])[0].tolist(),
               "inf3": np.asarray(res[2])[0].tolist()}
    out[name] = dict(rec, d=dv, x3=ints1(x3), y3=ints1(y3))
json.dump(out, open(sys.argv[2], "w"))
"""


def _points(curve, n, rng):
    """n distinct points P0 + i*S (host additions only)."""
    G = curve.generator()
    pt, step = G.mul_raw(rng.randrange(1, tbn.R)), G.mul_raw(
        rng.randrange(1, tbn.R))
    out = []
    for _ in range(n):
        out.append(pt.normalize())
        pt = pt + step
    return out


def _pairs(curve, seed, special=True):
    """B pairs: generic sums, then (with `special`) doublings, P + (-P) and
    infinite operands on either side and both, spread over the block."""
    rng = random.Random(seed)
    pts = _points(curve, B + 1, rng)
    pairs = [(pts[i], pts[i + 1]) for i in range(B)]
    inf = curve.infinity()
    for i in range(0, B, 16):
        if special:
            pairs[i + 1] = (pairs[i + 1][0], pairs[i + 1][0])       # 2P
            pairs[i + 2] = (pairs[i + 2][0], -pairs[i + 2][0])      # P - P
        pairs[i + 3] = (inf, pairs[i + 3][1])
        pairs[i + 4] = (pairs[i + 4][0], inf)
        pairs[i + 5] = (inf, inf)
    return pairs


def _ints(e):
    return [int(e.c0), int(e.c1)] if hasattr(e, "c0") else int(e)


def _coords(pts, zero):
    """(x, y) ints and infinity masks; infinity is 0."""
    xs, ys, ms = [], [], []
    for q in pts:
        if q.is_infinity():
            xs.append(zero)
            ys.append(zero)
            ms.append(1)
        else:
            x, y = q.to_affine()
            xs.append(_ints(x))
            ys.append(_ints(y))
            ms.append(0)
    return xs, ys, ms


def _layout(pairs, zero):
    x1, y1, m1 = _coords([p[0] for p in pairs], zero)
    x2, y2, m2 = _coords([p[1] for p in pairs], zero)
    return dict(x1=x1, y1=y1, m1=m1, x2=x2, y2=y2, m2=m2)


def _port_ins(g, pack):
    return (pack(g["x1"]), pack(g["y1"]),
            torch.tensor(g["m1"], dtype=torch.int32), pack(g["x2"]),
            pack(g["y2"]), torch.tensor(g["m2"], dtype=torch.int32))


def _pack2(vals):
    return F2.pack([tbn.Fq2(a, b) for a, b in vals])


def _ints2(t):
    return [list(v) for v in F2.unpack(t)]


def _ints1(t):
    return [int(v) for v in np.atleast_1d(F.unpack(t))]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The pairs over both groups, the Fq2 operands, and the
    interpret-mode outputs."""
    g1, g2 = _pairs(tbn.G1, 4), _pairs(tbn.G2, 5)
    rng = np.random.default_rng(7)
    rand = [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(2)]
            for _ in range(2 * B)]
    a = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + rand[:B - 4]
    b = [(P - 1, P - 1), (0, 1), (1, 0), (0, 0)] + rand[B:2 * B - 4]
    inp = dict(a=a, b=b, g1=_layout(g1, 0), g2=_layout(g2, [0, 0]))
    tmp = tmp_path_factory.mktemp("bn254")
    src, dst = tmp / "in.json", tmp / "out.json"
    src.write_text(json.dumps(inp))
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(dst)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(inp=inp, g1=g1, g2=g2, ref=json.loads(dst.read_text()))


def test_fq2_mul_vs_interpret_kernel_and_host(case):
    a, b = case["inp"]["a"], case["inp"]["b"]
    got = fk.fq2_mul(F, _pack2(a), _pack2(b))
    assert _ints2(got) == case["ref"]["prod"]
    assert _ints2(got) == [_ints(tbn.Fq2(*x) * tbn.Fq2(*y))
                           for x, y in zip(a, b)]


def test_fq2_sqr_vs_host(case):
    """The complex square at 8 limbs, with a0 = a1, a1 = 0, (p-1) + 0u and
    0 + (p-1)u beside the products' operands."""
    a = case["inp"]["a"] + [(5, 5), (7, 0), (P - 1, 0), (0, P - 1)]
    got = fk.fq2_sqr(F, _pack2(a))
    assert _ints2(got) == [_ints(tbn.Fq2(*x).square()) for x in a]
    assert torch.equal(got, fk.fq2_mul(F, _pack2(a), _pack2(a)))


def _finite(ref_x, ref_y, inf3):
    return [[x, y] for x, y, i in zip(ref_x, ref_y, inf3) if not i]


def _host_sums(pairs):
    """[x, y] ints of each pair's sum on the host; None at infinity."""
    out = []
    for p, q in pairs:
        s = p + q
        out.append(None if s.is_infinity()
                   else [_ints(c) for c in s.to_affine()])
    return out


def test_fq2_level_vs_interpret_kernels_and_host(case):
    ref = case["ref"]["g2"]
    x1, y1, m1, x2, y2, m2 = ins = _port_ins(case["inp"]["g2"], _pack2)
    d, dbl, inf3 = ck.affine_level_pre_fq2(F2, *ins)
    assert dbl.tolist() == ref["dbl"] and inf3.tolist() == ref["inf3"]
    live = ~((m1 != 0) | (m2 != 0) | (inf3 != 0))
    dv = _ints2(d)
    assert [v for v, lv in zip(dv, live) if lv] == \
        [v for v, lv in zip(ref["d"], live) if lv]
    x3, y3 = ck.affine_level_post_fq2(F2, x1, y1, x2, y2,
                                      msm_v2.batch_inv_t(F2, d), dbl, m1, m2)
    got = _finite(_ints2(x3), _ints2(y3), inf3.tolist())
    assert got == _finite(ref["x3"], ref["y3"], ref["inf3"])
    assert got == [w for w in _host_sums(case["g2"]) if w is not None]


@pytest.mark.parametrize("formula", ["total", "fast"])
def test_g1_level_vs_interpret_kernels_and_host(case, formula):
    """The total level on every kind of pair; the fast level on the same
    pairs, where its d is 0 on exactly the doublings and P + (-P) and
    every other lane equals the reference and the host.  d and the masks
    come from the one-launch level's plain pre step."""
    ref = case["ref"][formula]
    x1, y1, m1, x2, y2, m2 = ins = _port_ins(case["inp"]["g1"], F.pack)
    if formula == "total":
        d, dbl, inf3 = ck.affine_level_pre_plain(F, *ins)
        assert dbl.tolist() == ref["dbl"]
        x3, y3, inf3_l = ck.affine_level(F, *ins)
    else:
        d, inf3 = ck.affine_level_pre_fast_plain(F, *ins)
        x3, y3, inf3_l, zero = ck.affine_level_fast(F, *ins)
        assert torch.equal(zero, F.is_zero(d))
    assert torch.equal(inf3_l, inf3)
    assert inf3.tolist() == ref["inf3"]
    # d on live lanes (dead lanes hold a plain limb-0 1, whose Montgomery
    # reading differs between the packages' radices)
    live = (~((m1 != 0) | (m2 != 0) | (inf3 != 0))).tolist()
    dv = _ints1(d)
    assert [v for v, lv in zip(dv, live) if lv] == \
        [v for v, lv in zip(ref["d"], live) if lv]
    # a fast lane that collided (d = 0) is the caller's to rerun
    keep = [not (i or (lv and v == 0)) for i, lv, v in
            zip(inf3.tolist(), live, dv)]
    got = [[x, y] for x, y, k in zip(_ints1(x3), _ints1(y3), keep) if k]
    assert got == [[x, y] for x, y, k in zip(ref["x3"], ref["y3"], keep)
                   if k]
    assert got == [w for w, k in zip(_host_sums(case["g1"]), keep) if k]
    collided = sum(lv and v == 0 for v, lv in zip(dv, live))
    assert collided == (2 * (B // 16) if formula == "fast" else 0)


@pytest.mark.parametrize("fast", [False, True], ids=["total", "fast"])
def test_chunked_levels_vs_pre_post(case, fast):
    """Both chunked levels at 8 limbs against the pre/post of the same
    formula on the same pairs (the fast one on the pairs with no
    collision), and the host sums."""
    pairs = case["g1"] if not fast else _pairs(tbn.G1, 3, special=False)
    ins = _port_ins(_layout(pairs, 0), F.pack)
    if fast:
        kq = ck.chunked_level_prefix_fast(F, *ins)
        tinv = msm_v2.batch_inv_t(F, kq[1])
        x3, y3 = ck.chunked_level_down_fast(F, *ins, kq[0], tinv)
        d, inf3 = ck.affine_level_pre_fast_plain(F, *ins)
    else:
        kq = ck.chunked_level_prefix(F, *ins)
        tinv = msm_v2.batch_inv_t(F, kq[1])
        x3, y3 = ck.chunked_level_down(F, *ins, kq[0], tinv, kq[2])
        d, dbl, inf3 = ck.affine_level_pre_plain(F, *ins)
        assert torch.equal(kq[2], dbl)
    assert torch.equal(kq[-1], inf3)
    got = [None if i else [x, y] for x, y, i in zip(_ints1(x3), _ints1(y3),
                                                    inf3.tolist())]
    assert got == _host_sums(pairs)


@pytest.mark.parametrize("rows", [8, 16])
def test_gather_and_slot_tables_at_bn254_rows(rows):
    """`slot_tables` over G1 (8 words a row) and G2 (16) against x's rows
    and y's over -y's from the host; the gather of a ragged count with
    indices past the table and below -1 and an all-dead tile."""
    Fx = F if rows == 8 else F2
    curve = tbn.G1 if rows == 8 else tbn.G2
    pts = _points(curve, 40, random.Random(rows))
    x, y, _ = _coords(pts, 0 if rows == 8 else [0, 0])
    pack = F.pack if rows == 8 else _pack2
    y[3] = 0 if rows == 8 else [0, 0]
    tx, ty = pack(x), pack(y)
    xtab, ytab = fk.slot_tables(Fx, tx, ty)
    assert xtab.shape == (40, rows) and ytab.shape == (80, rows)
    assert torch.equal(xtab, tx.t())
    assert torch.equal(ytab[40:], Fx.neg(ty).t())
    assert torch.equal(ytab[:40], ty.t())
    idx = torch.tensor([5, -1, 39, 40, 77, -5, 0, 12] + [-1] * 256 + [3],
                       dtype=torch.int64)
    got = fk.gather_rows_t(ytab, idx)
    assert got.shape == (rows, idx.numel())
    for j, i in enumerate(idx.tolist()):
        want = ytab[i] if 0 <= i < 80 else torch.zeros(rows, dtype=torch.int32)
        assert torch.equal(got[:, j], want)


def test_wrappers_take_8_and_12_limbs_only():
    """The level and Fq2 wrappers take base fields of 8 or 12 limbs with
    4p < R and the matching rows; another limb count, BLS12-381's Fr
    (r > R/4) or another row count is refused."""
    from crypto_tpu_torch.fields.host import Field
    odd = tfield_for(Field("p224", (1 << 224) - (1 << 96) + 1), "cpu")
    assert odd.L == 7
    z = odd.zeros((8,))
    m = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="limbs"):
        ck.affine_level(odd, z, z, m, z, z, m)
    with pytest.raises(ValueError, match="limbs"):
        fk.fq2_mul(odd, torch.cat([z, z]), torch.cat([z, z]))
    from crypto_tpu_torch.curves import bls12_381 as tbl
    fr = tfield_for(tbl.Fr, "cpu")
    with pytest.raises(ValueError, match="4p"):
        fk.fq2_sqr(fr, torch.cat([fr.zeros((8,))] * 2))
    z8 = F.zeros((8,))
    with pytest.raises(ValueError, match="rows"):
        ck.affine_level_pre_fq2(F, z8, z8, m, z8, z8, m)
    with pytest.raises(ValueError):
        ck.affine_level_fast(F2, *(F2.zeros((8,)),) * 2, m,
                             *(F2.zeros((8,)),) * 2, m)
