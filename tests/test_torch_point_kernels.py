"""The port's Jacobian point kernels and normalize (plain versions, CPU)
against the reference `make_add_fns(jc, block_b=128)` and
`make_normalize_fn(jc, block_b=128)` run by the JAX package in Pallas
interpret mode, and against the host curve; and `make_bench_points` at
n = 2^12 against the host.

The JAX kernels run in one subprocess that sets
`CRYPTO_TPU_PALLAS_INTERPRET=1` before it imports `crypto_tpu`.  Canonical
X, Y, Z are compared lane by lane (X and Y where Z != 0: an infinite
result's X and Y are plain-1 limbs in both packages, which differ as
canonical values), and each batch's flag.  The adds' batches without a
P + P (flag 0) are held against the host only: the interpreter takes
about as long for each further call as for the first.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.bench_points import make_bench_points
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops.kernels import point_kernels as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC = tcurve_for(tb.G1, "cpu")
F = TC.F
G = tb.G1.generator()
P_MOD = tb.P
rng = random.Random(89)
LANES = 16

SCRIPT = r"""
import json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.curves.jcurve import JPoints, jcurve_for
from crypto_tpu.ops.pallas.curve_kernels import make_add_fns, make_normalize_fn
inp = json.load(open(sys.argv[1]))
jc = jcurve_for(jb.G1)
F = jc.F
add_fn, affine_add_fn, double_fn = make_add_fns(jc, block_b=128)
normalize = make_normalize_fn(jc, block_b=128)

def pts(rows):
    return JPoints(*(F.pack([r[k] for r in rows]) for k in range(3)))

def out(P):
    return [[int(v) for v in F.unpack(t)] for t in P]

res = {}
S, flag = add_fn(pts(inp["add"][0]), pts(inp["add"][1]))
res["add"] = [out(S), int(flag)]
S, flag = affine_add_fn(pts(inp["mixed"][0]), pts(inp["mixed"][1]))
res["mixed"] = [out(S), int(flag)]
res["double"] = [out(double_fn(pts(inp["double"]))), 0]
res["normalize"] = [out(normalize(pts(inp["normalize"]))), 0]
json.dump(res, open(sys.argv[2], "w"))
"""


def _jac(q):
    """Host point -> canonical Jacobian ints with a random Z; infinity is
    (1, 1, 0)."""
    if q.is_infinity():
        return [1, 1, 0]
    x, y = (int(v) for v in q.to_affine())
    z = rng.randrange(1, P_MOD)
    return [x * z * z % P_MOD, y * z ** 3 % P_MOD, z]


def _aff(q):
    x, y = (int(v) for v in q.to_affine())
    return [x, y, 1]


def _rand():
    return G.mul_raw(rng.randrange(1, tb.R))


def _cases():
    """Each kernel's input batches (LANES lanes) as canonical ints."""
    inf = tb.G1.infinity()
    P = _rand()
    pj = _jac(P)
    add = [(_rand(), _rand()) for _ in range(LANES)]
    add[3], add[4], add[5], add[6] = (P, -P), (inf, P), (P, inf), (inf, inf)
    A, B = [_jac(a) for a, _ in add], [_jac(b) for _, b in add]
    A_d, B_d = list(A), list(B)
    A[1], B[1] = pj, list(pj)                 # P + P, the same coordinates
    A[2], B[2] = pj, _jac(P)                  # P + P, another Z
    mixed = [(_rand(), _rand()) for _ in range(LANES)]
    mixed[3] = (P, -P)
    MA, MB = [_aff(a) for a, _ in mixed], [_aff(b) for _, b in mixed]
    MA_d, MB_d = list(MA), list(MB)
    MA[1], MB[1] = _aff(P), _aff(P)
    dbl = [_jac(_rand()) for _ in range(LANES)]
    dbl[2] = [1, 1, 0]
    norm = [_jac(_rand()) for _ in range(LANES)]
    norm[4] = [1, 1, 0]
    return {"add": [A, B], "add_distinct": [A_d, B_d],
            "mixed": [MA, MB], "mixed_distinct": [MA_d, MB_d],
            "double": dbl, "normalize": norm}


def _tp(rows):
    return TPoints(*(F.pack([r[k] for r in rows]) for k in range(3)))


def _ints(P):
    return [[int(v) for v in np.atleast_1d(F.unpack(t))] for t in P]


def _host_point(x, y, z):
    if z == 0:
        return tb.G1.infinity()
    zi = pow(z, -1, P_MOD)
    return tb.G1.point_from_affine(tb.Fq(x * zi * zi % P_MOD),
                                   tb.Fq(y * zi ** 3 % P_MOD))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = _cases()
    d = tmp_path_factory.mktemp("points")
    src, dst = d / "in.json", d / "out.json"
    src.write_text(json.dumps(cases))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(dst)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return cases, json.loads(dst.read_text())


def _port(name, cases):
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(TC)
    if name.startswith("add"):
        S, flag = add_fn(*map(_tp, cases[name]))
    elif name.startswith("mixed"):
        S, flag = affine_add_fn(*map(_tp, cases[name]))
    elif name == "double":
        S, flag = double_fn(_tp(cases[name])), torch.tensor(0)
    else:
        S, flag = pk.make_normalize_fn(TC)(_tp(cases[name])), torch.tensor(0)
    assert flag.dim() == 0
    return _ints(S), int(flag)


def _host_expect(name, cases, lane):
    """The host's value of a lane, or None where the kernel's contract
    leaves it open (P + P raises the flag instead)."""
    if name == "double":
        return _host_point(*cases[name][lane]).double()
    if name == "normalize":
        return _host_point(*cases[name][lane])
    a, b = (_host_point(*cases[name][k][lane]) for k in (0, 1))
    return None if a == b and not a.is_infinity() else a + b


@pytest.mark.parametrize("name", ["add", "add_distinct", "mixed",
                                  "mixed_distinct", "double", "normalize"])
def test_point_kernel_vs_interpret(reference, name):
    cases, ref = reference
    (X, Y, Z), flag = _port(name, cases)
    assert flag == (1 if name in ("add", "mixed") else 0)
    if name in ref:
        (rX, rY, rZ), rflag = ref[name]
        assert flag == rflag
        assert Z == rZ
        for i in range(LANES):
            if Z[i]:
                assert (X[i], Y[i]) == (rX[i], rY[i]), i
    for i in range(LANES):
        expect = _host_expect(name, cases, i)
        if expect is not None:
            assert _host_point(X[i], Y[i], Z[i]) == expect, i
        else:
            assert Z[i] == 0, i        # P + P: the formula gives (0, 0, 0)
    if name == "normalize":
        assert Z == [0 if z == 0 else 1 for _, _, z in cases[name]]


def test_make_bench_points_cpu():
    n = 1 << 12
    pts, dlog = make_bench_points(TC, n)
    assert pts.X.shape == (12, n)
    assert torch.equal(pts.Z, F.ones((n,)))
    sample = random.Random(3).sample(range(n), 24)
    got = TC.unpack(TPoints(*(t[:, sample] for t in pts)))
    assert all(g == G.mul_raw(dlog(i)) for g, i in zip(got, sample))
    assert len({tuple(pts.X[:, i].tolist()) for i in sample}) == len(sample)


def test_add_fns_batch_shapes():
    """Any batch shape in, the same shape out, one 0-dim flag; an empty
    batch has flag 0."""
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(TC)
    pts = [_rand() for _ in range(6)]
    A = TPoints(*(t.reshape(12, 2, 3) for t in TC.pack_points(pts)))
    S, flag = add_fn(A, A)
    assert S.X.shape == (12, 2, 3) and flag.shape == () and int(flag) == 1
    D = double_fn(A)
    norm = pk.make_normalize_fn(TC)(D)
    assert norm.Y.shape == (12, 2, 3)
    flat = TC.unpack(TPoints(*(t.reshape(12, -1) for t in norm)))
    assert flat == [p.double() for p in pts]
    empty = TPoints(*(t[:, :0] for t in TC.pack_points(pts)))
    assert int(affine_add_fn(empty, empty)[1]) == 0


def test_point_wrapper_checks():
    x = F.pack([1, 2, 3])
    with pytest.raises(ValueError):
        pk.jacobian_double(F, x, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        pk.jacobian_add_mixed(F, x, x[:, :2].contiguous(), x, x)
    Fr = tfield_for(tb.Fr, "cpu")
    y = Fr.pack([1, 2, 3])
    with pytest.raises(ValueError, match="12 limbs"):
        pk.jacobian_normalize(Fr, y, y, y)
