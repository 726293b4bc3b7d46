"""The port's one-launch narrow levels (`affine_level`, the total formula,
and `affine_level_fast`, the doubling-free one; their plain versions on
the CPU) against the reference's own narrow `pair_add_t` from
`DeviceMSM._fused_ctx` and the host curve, at BLS12-381's 12 limbs and
BN254's 8; and a model of the kernel's block-local inversion against
`msm_v2.batch_inv_t`.

The reference runs in a subprocess a curve, the two side by side, each
setting `CRYPTO_TPU_PALLAS_INTERPRET=1` before it imports `crypto_tpu`
(its pre, `batch_inv_t` and post in Pallas interpret mode, ~50 s a
call), once a formula on 512 pairs made from a numpy seed.  Every lane of the level is
independent of the others (an inverse is unique), so the port's level at
M = 1, 3, 129 and 512 is held against the first M lanes of that run.
The pairs hold generic sums, infinite operands on either side and both,
doublings and P + (-P).  The reference's fast level spoils every lane of
a batch with a colliding pair (its zero d zeroes the tree's root), so its
fast run takes the same pairs with the colliding lanes' first operand
set infinite; those lanes are held to the host's collision mask instead.
Canonical integers are compared on live lanes; inf3 and zero everywhere.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops import msm_v2
from crypto_tpu_torch.ops.kernels import build
from crypto_tpu_torch.ops.kernels import curve_kernels as ck
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = {"bls12_381": tb, "bn254": tbn}
N_PAIRS = 512
WIDTHS = (1, 3, 129, 512)
# special pairs by lane: each kind within the first 3 and 129 lanes, and
# again past them
INF_FIRST, INF_SECOND, INF_BOTH = (1, 150), (5, 260), (6, 400)
DOUBLE, OPPOSITE = (2, 7, 200), (4, 300, 510)

SCRIPT = r"""
import importlib, json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from crypto_tpu.curves.jcurve import jcurve_for
from crypto_tpu.ops.msm_v2 import _engine_for
lanes = json.load(open(sys.argv[1]))
jc = jcurve_for(importlib.import_module("crypto_tpu.curves." + sys.argv[3]).G1)
F = jc.F
engine = _engine_for(jc)
coords = [F.pack(lanes[k]).T for k in ("x1", "y1", "x2", "y2")]
m2 = jnp.asarray(np.array([lanes["m2"]], np.int32))
res = {}
for formula, m1 in (("total", lanes["m1"]), ("fast", lanes["m1_fast"])):
    _, pair_add_t, _, _ = engine._fused_ctx(formula == "fast")
    x3, y3, inf3, zf = pair_add_t(
        coords[0], coords[1], jnp.asarray(np.array([m1], np.int32)),
        coords[2], coords[3], m2)
    res[formula] = {"x3": [int(v) for v in F.unpack(np.asarray(x3).T)],
                    "y3": [int(v) for v in F.unpack(np.asarray(y3).T)],
                    "inf3": np.asarray(inf3)[0].tolist(), "zf": int(zf)}
json.dump(res, open(sys.argv[2], "w"))
"""


def _pairs(curve, seed):
    """N_PAIRS pairs of distinct points A + k H (two scalars from a numpy
    seed, the multiples in a numpy permutation) with the special lanes."""
    gen = np.random.default_rng(seed)
    G = curve.G1.generator()
    a, h = (int.from_bytes(gen.bytes(32), "little") % curve.R
            for _ in range(2))
    H = G.mul_raw(h)
    pts, cur = [], G.mul_raw(a)
    for _ in range(2 * N_PAIRS):
        pts.append(cur)
        cur = cur + H
    order = gen.permutation(2 * N_PAIRS)
    pairs = [(pts[order[2 * i]], pts[order[2 * i + 1]])
             for i in range(N_PAIRS)]
    inf = curve.G1.infinity()
    for i in INF_FIRST:
        pairs[i] = (inf, pairs[i][1])
    for i in INF_SECOND:
        pairs[i] = (pairs[i][0], inf)
    for i in INF_BOTH:
        pairs[i] = (inf, inf)
    for i in DOUBLE:
        pairs[i] = (pairs[i][0], pairs[i][0])
    for i in OPPOSITE:
        pairs[i] = (pairs[i][0], -pairs[i][0])
    return pairs


def _coords(pts):
    xs, ys, ms = [], [], []
    for q in pts:
        x, y = (0, 0) if q.is_infinity() else (int(c) for c in q.to_affine())
        xs.append(x)
        ys.append(y)
        ms.append(int(q.is_infinity()))
    return xs, ys, ms


def _host(pairs):
    """(x3, y3, inf3) of each pair's sum, and the fast level's collision
    mask: both operands finite with the same x."""
    sums, coll = [], []
    for p, q in pairs:
        s = p + q
        sums.append((0, 0, True) if s.is_infinity()
                    else tuple(int(c) for c in s.to_affine()) + (False,))
        coll.append(not p.is_infinity() and not q.is_infinity()
                    and p.to_affine()[0] == q.to_affine()[0])
    return sums, coll


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """{curve: (pairs, lanes)} and the reference's {curve: {formula:
    outputs}} on them."""
    data, lanes = {}, {}
    for k, (name, curve) in enumerate(CURVES.items()):
        pairs = _pairs(curve, 20261018 + k)
        x1, y1, m1 = _coords([p[0] for p in pairs])
        x2, y2, m2 = _coords([p[1] for p in pairs])
        _, coll = _host(pairs)
        lanes[name] = dict(x1=x1, y1=y1, m1=m1, x2=x2, y2=y2, m2=m2,
                           m1_fast=[int(a or c) for a, c in zip(m1, coll)])
        data[name] = pairs
    tmp = tmp_path_factory.mktemp("fused")
    procs = {}
    for name in CURVES:
        src, dst = tmp / f"{name}.in.json", tmp / f"{name}.out.json"
        src.write_text(json.dumps(lanes[name]))
        procs[name] = (dst, subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(src), str(dst), name],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=ROOT))
    ref = {}
    for name, (dst, proc) in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        ref[name] = json.loads(dst.read_text())
    return data, lanes, ref


def _ints(F, t):
    return [int(v) for v in np.atleast_1d(F.unpack(t))]


@pytest.mark.parametrize("M", WIDTHS)
@pytest.mark.parametrize("formula", ["total", "fast"])
@pytest.mark.parametrize("name", list(CURVES))
def test_level_vs_reference_pair_add_and_host(case, name, formula, M):
    data, lanes, ref = case
    curve = CURVES[name]
    F = tfield_for(curve.Fq, "cpu")
    assert F.L == (12 if name == "bls12_381" else 8)
    L = lanes[name]
    ins = (F.pack(L["x1"][:M]), F.pack(L["y1"][:M]),
           torch.tensor(L["m1"][:M], dtype=torch.int32),
           F.pack(L["x2"][:M]), F.pack(L["y2"][:M]),
           torch.tensor(L["m2"][:M], dtype=torch.int32))
    sums, coll = _host(data[name][:M])
    r = ref[name][formula]
    if formula == "total":
        x3, y3, inf3 = ck.affine_level(F, *ins)
        zero = torch.zeros(M, dtype=torch.bool)
        assert r["zf"] == 0
    else:
        x3, y3, inf3, zero = ck.affine_level_fast(F, *ins)
        assert r["zf"] == 0          # its colliding lanes were made dead
    assert zero.dtype == torch.bool and inf3.dtype == torch.int32
    want_zero = coll if formula == "fast" else [False] * M
    assert zero.tolist() == want_zero
    # the fast formula's inf3 is both operands infinite: 0 where a pair
    # collides, whatever its sum
    assert (inf3 != 0).tolist() == [s[2] and not z
                                    for s, z in zip(sums, want_zero)]
    assert inf3.tolist() == r["inf3"][:M]
    gx, gy = _ints(F, x3), _ints(F, y3)
    for i in range(M):
        if sums[i][2] or want_zero[i]:
            continue
        assert (gx[i], gy[i]) == (r["x3"][i], r["y3"][i]) == sums[i][:2], i
    if M == N_PAIRS:
        kinds = (INF_FIRST + INF_SECOND + INF_BOTH + DOUBLE + OPPOSITE)
        assert all(i < M for i in kinds)
        assert sum(want_zero) == (len(DOUBLE) + len(OPPOSITE)
                                  if formula == "fast" else 0)


def test_pair_add_t_takes_one_launch_a_narrow_level(monkeypatch):
    """`pair_add_t` below CHUNK_MIN_PAIRS calls the one-launch level once,
    on both formulas, and nothing of the split level."""
    calls = []
    for fn in ("affine_level", "affine_level_fast"):
        real = getattr(ck, fn)
        monkeypatch.setattr(ck, fn, lambda *a, _r=real, _n=fn:
                            calls.append(_n) or _r(*a))
    F = tfield_for(tb.Fq, "cpu")
    pairs = _pairs(tb, 7)[:16]
    x1, y1, m1 = _coords([p[0] for p in pairs])
    x2, y2, m2 = _coords([p[1] for p in pairs])
    ins = (F.pack(x1), F.pack(y1), torch.tensor(m1, dtype=torch.int32),
           F.pack(x2), F.pack(y2), torch.tensor(m2, dtype=torch.int32))
    trace = {}
    fast = msm_v2.pair_add_t(F, *ins, fast=True, trace=trace)
    total = msm_v2.pair_add_t(F, *ins)
    assert calls == ["affine_level_fast", "affine_level"]
    (M, windows, K, zchunks), = trace["zero_chunks"]
    assert (M, windows, K) == (16, 1, 1)
    assert torch.equal(zchunks, fast[3]) and bool(fast[3][2])
    assert not bool(total[3].any())
    sums, _ = _host(pairs)
    gx, gy = _ints(F, total[0]), _ints(F, total[1])
    assert [(x, y, bool(i)) if not i else (0, 0, True)
            for x, y, i in zip(gx, gy, total[2].tolist())] == sums


# ---------------------------------------------------------------------------
# the kernel's block-local inversion, modelled on host integers
# ---------------------------------------------------------------------------

def _kernel_constant(name: str) -> int:
    text = (build.CSRC / "affine_level.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _block_inverses(d, p, R, T, chunk):
    """1/d of Montgomery-form ints `d` as csrc/affine_level.cu computes
    them, block by block and thread by thread: thread j of block b takes
    pairs b*T*chunk + j + s*T, parks its prefix products, its chunk total
    (the Montgomery 1 for an empty chunk) goes up the block's tree, the
    root is inverted once, the tree is walked back down, then the chunk.
    It mirrors the kernel's indexing (the chunk's stride, the prefix
    offsets, the tree's node layout) and changes with it."""
    rinv = pow(R, -1, p)

    def mm(a, b):
        return a * b * rinv % p

    M = len(d)
    park, out = [None] * M, [None] * M
    for b in range(-(-M // (T * chunk))):
        node, runs = [None] * (2 * T - 1), []
        for j in range(T):
            first = b * T * chunk + j
            n = min(chunk, (M - 1 - first) // T + 1) if first < M else 0
            acc = R % p
            for s in range(n):
                i = first + s * T
                acc = d[i] if s == 0 else mm(acc, d[i])
                park[i] = acc
            node[j] = acc
            runs.append((first, n))
        off, w = 0, T // 2
        while w:                                      # up the tree
            for k in range(w):
                node[off + 2 * w + k] = mm(node[off + 2 * k],
                                           node[off + 2 * k + 1])
            off, w = off + 2 * w, w // 2
        node[off] = R * R * pow(node[off], -1, p) % p  # the root's inverse
        w = 1
        while w < T:                                  # down the tree
            off -= 2 * w
            for k in range(w):
                inv = node[off + 2 * w + k]
                left, right = node[off + 2 * k], node[off + 2 * k + 1]
                node[off + 2 * k], node[off + 2 * k + 1] = (mm(inv, right),
                                                            mm(inv, left))
            w *= 2
        for j, (first, n) in enumerate(runs):          # the walk back
            acc = node[j]
            for s in range(n - 1, -1, -1):
                i = first + s * T
                if s > 0:
                    out[i] = mm(acc, park[i - T])
                    acc = mm(acc, d[i])
                else:
                    out[i] = acc
    return out


@pytest.mark.parametrize("chunk", ["shipped", 4])
def test_block_local_inversion_equals_batch_inv_t(chunk):
    """The model at the source's T and CHUNK (and at 4 pairs a thread,
    which `time_launch_bounds.py` builds), at odd widths and about the
    block's T*CHUNK pairs, over nonzero values with the plain limb-0 1 of
    a dead lane among them, bit for bit against `batch_inv_t` (one call
    over all the widths side by side: each inverse is unique)."""
    F = tfield_for(tb.Fq, "cpu")
    p, R = tb.P, 1 << (32 * F.L)
    T = _kernel_constant("T")
    assert 1 << _kernel_constant("TREE_LOG") == T
    if chunk == "shipped":
        chunk = _kernel_constant("CHUNK")
    span = T * chunk
    widths = sorted({1, 2, 127, 129, span - 1, span, span + 1,
                     2 * span + 7})
    gen = np.random.default_rng(20261019)
    cases = []
    for M in widths:
        v = [int.from_bytes(gen.bytes(48), "little") % (p - 1) + 1
             for _ in range(M)]
        v[M // 2] = 1               # a dead lane's plain limb-0 1
        cases.append(v)
    allv = F.pack([x for v in cases for x in v], mont=False)
    inv = msm_v2.batch_inv_t(F, allv)
    got = [int(x) for x in np.atleast_1d(F.unpack(inv, mont=False))]
    at = 0
    for v in cases:
        assert _block_inverses(v, p, R, T, chunk) == got[at:at + len(v)], \
            len(v)
        at += len(v)
