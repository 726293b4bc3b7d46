"""The port's Jacobian point kernels and normalize (plain versions, CPU)
against the reference `make_add_fns(jc, block_b=128)` and
`make_normalize_fn(jc, block_b=128)` run by the JAX package in Pallas
interpret mode, and against the host curve, on BLS12-381 G1 (12 limbs)
and BN254 G1 (8 limbs); and `make_bench_points` at n = 2^12 against the
host on both.

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
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.bench_points import make_bench_points
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
from crypto_tpu_torch.fields.tfield import tfield_for
from crypto_tpu_torch.ops.kernels import build
from crypto_tpu_torch.ops.kernels import point_kernels as pk
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC = tcurve_for(tb.G1, "cpu")
F = TC.F
G = tb.G1.generator()
P_MOD = tb.P
rng = random.Random(89)
LANES = 16

SCRIPT = r"""
import importlib, json, os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
from crypto_tpu.curves.jcurve import JPoints, jcurve_for
from crypto_tpu.ops.pallas.curve_kernels import make_add_fns, make_normalize_fn
inp = json.load(open(sys.argv[1]))
jb = importlib.import_module("crypto_tpu.curves." + sys.argv[3])
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


class _Curve:
    """A G1's host curve, its `TCurve` on the CPU and its primes."""

    def __init__(self, mod, name):
        self.name, self.mod, self.G1 = name, mod, mod.G1
        self.TC = tcurve_for(mod.G1, "cpu")
        self.F, self.G, self.P, self.R = (self.TC.F, mod.G1.generator(),
                                          mod.P, mod.R)


BLS, BN = _Curve(tb, "bls12_381"), _Curve(tbn, "bn254")


def _jac(q, cv=BLS):
    """Host point -> canonical Jacobian ints with a random Z; infinity is
    (1, 1, 0)."""
    if q.is_infinity():
        return [1, 1, 0]
    x, y = (int(v) for v in q.to_affine())
    z = rng.randrange(1, cv.P)
    return [x * z * z % cv.P, y * z ** 3 % cv.P, z]


def _aff(q):
    x, y = (int(v) for v in q.to_affine())
    return [x, y, 1]


def _rand(cv=BLS):
    return cv.G.mul_raw(rng.randrange(1, cv.R))


def _cases(cv=BLS):
    """Each kernel's input batches (LANES lanes) as canonical ints."""
    inf = cv.G1.infinity()
    P = _rand(cv)
    pj = _jac(P, cv)
    add = [(_rand(cv), _rand(cv)) for _ in range(LANES)]
    add[3], add[4], add[5], add[6] = (P, -P), (inf, P), (P, inf), (inf, inf)
    A, B = [_jac(a, cv) for a, _ in add], [_jac(b, cv) for _, b in add]
    A_d, B_d = list(A), list(B)
    A[1], B[1] = pj, list(pj)                 # P + P, the same coordinates
    A[2], B[2] = pj, _jac(P, cv)              # P + P, another Z
    mixed = [(_rand(cv), _rand(cv)) for _ in range(LANES)]
    mixed[3] = (P, -P)
    MA, MB = [_aff(a) for a, _ in mixed], [_aff(b) for _, b in mixed]
    MA_d, MB_d = list(MA), list(MB)
    MA[1], MB[1] = _aff(P), _aff(P)
    dbl = [_jac(_rand(cv), cv) for _ in range(LANES)]
    dbl[2] = [1, 1, 0]
    norm = [_jac(_rand(cv), cv) for _ in range(LANES)]
    norm[4] = [1, 1, 0]
    return {"add": [A, B], "add_distinct": [A_d, B_d],
            "mixed": [MA, MB], "mixed_distinct": [MA_d, MB_d],
            "double": dbl, "normalize": norm}


def _tp(rows, cv=BLS):
    return TPoints(*(cv.F.pack([r[k] for r in rows]) for k in range(3)))


def _ints(P, cv=BLS):
    return [[int(v) for v in np.atleast_1d(cv.F.unpack(t))] for t in P]


def _host_point(x, y, z, cv=BLS):
    if z == 0:
        return cv.G1.infinity()
    zi = pow(z, -1, cv.P)
    return cv.G1.point_from_affine(cv.mod.Fq(x * zi * zi % cv.P),
                                   cv.mod.Fq(y * zi ** 3 % cv.P))


def _run_reference(tmp_path_factory, cv):
    cases = _cases(cv)
    d = tmp_path_factory.mktemp("points")
    src, dst = d / "in.json", d / "out.json"
    src.write_text(json.dumps(cases))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(dst),
                          cv.name], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return cases, json.loads(dst.read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run_reference(tmp_path_factory, BLS)


@pytest.fixture(scope="module")
def reference_bn254(tmp_path_factory):
    return _run_reference(tmp_path_factory, BN)


def _port(name, cases, cv=BLS):
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(cv.TC)
    tp = [_tp(c, cv) for c in cases[name]] if name.startswith(
        ("add", "mixed")) else _tp(cases[name], cv)
    if name.startswith("add"):
        S, flag = add_fn(*tp)
    elif name.startswith("mixed"):
        S, flag = affine_add_fn(*tp)
    elif name == "double":
        S, flag = double_fn(tp), torch.tensor(0)
    else:
        S, flag = pk.make_normalize_fn(cv.TC)(tp), torch.tensor(0)
    assert flag.dim() == 0
    return _ints(S, cv), int(flag)


def _host_expect(name, cases, lane, cv=BLS):
    """The host's value of a lane, or None where the kernel's contract
    leaves it open (P + P raises the flag instead)."""
    if name == "double":
        return _host_point(*cases[name][lane], cv).double()
    if name == "normalize":
        return _host_point(*cases[name][lane], cv)
    a, b = (_host_point(*cases[name][k][lane], cv) for k in (0, 1))
    return None if a == b and not a.is_infinity() else a + b


def _check_vs_interpret(reference, name, cv):
    cases, ref = reference
    (X, Y, Z), flag = _port(name, cases, cv)
    assert flag == (1 if name in ("add", "mixed") else 0)
    if name in ref:
        (rX, rY, rZ), rflag = ref[name]
        assert flag == rflag
        assert Z == rZ
        for i in range(LANES):
            if Z[i]:
                assert (X[i], Y[i]) == (rX[i], rY[i]), i
    for i in range(LANES):
        expect = _host_expect(name, cases, i, cv)
        if expect is not None:
            assert _host_point(X[i], Y[i], Z[i], cv) == expect, i
        else:
            assert Z[i] == 0, i        # P + P: the formula gives (0, 0, 0)
    if name == "normalize":
        assert Z == [0 if z == 0 else 1 for _, _, z in cases[name]]


KERNEL_CASES = ["add", "add_distinct", "mixed", "mixed_distinct", "double",
                "normalize"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_point_kernel_vs_interpret(reference, name):
    _check_vs_interpret(reference, name, BLS)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_point_kernel_vs_interpret_bn254(reference_bn254, name):
    """The same cases at BN254's 8 limbs, against the reference's
    factories at BN254's p (which take any limb count)."""
    _check_vs_interpret(reference_bn254, name, BN)


def test_make_add_fns_bn254():
    """`make_add_fns(tcurve_for(bn254.G1))` and `make_normalize_fn` run at
    8 limbs (the wrappers took BLS12-381 Fq only and raised here): a
    batch of adds, a double and a normalize against the host."""
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(BN.TC)
    pts = [_rand(BN) for _ in range(6)]
    qts = [_rand(BN) for _ in range(6)]
    A, B = BN.TC.pack_points(pts), BN.TC.pack_points(qts)
    S, flag = add_fn(A, B)
    M, mflag = affine_add_fn(A, B)
    norm = pk.make_normalize_fn(BN.TC)
    assert S.X.shape == (8, 6) and int(flag) == 0 and int(mflag) == 0
    assert BN.TC.unpack(norm(S)) == [p + q for p, q in zip(pts, qts)]
    assert BN.TC.unpack(norm(M)) == [p + q for p, q in zip(pts, qts)]
    assert BN.TC.unpack(norm(double_fn(A))) == [p.double() for p in pts]


def test_make_bench_points_cpu():
    _check_bench_points(BLS)


def test_make_bench_points_cpu_bn254():
    """BN254 G1's bench points, now built by the point kernels at 8
    limbs."""
    _check_bench_points(BN)


def _check_bench_points(cv):
    n = 1 << 12
    pts, dlog = make_bench_points(cv.TC, n)
    assert pts.X.shape == (cv.F.L, n)
    assert torch.equal(pts.Z, cv.F.ones((n,)))
    sample = random.Random(3).sample(range(n), 24)
    got = cv.TC.unpack(TPoints(*(t[:, sample] for t in pts)))
    assert all(g == cv.G.mul_raw(dlog(i)) for g, i in zip(got, sample))
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
    with pytest.raises(ValueError, match="4p < 2"):
        pk.jacobian_normalize(Fr, y, y, y)


def _walk(n):
    """n consecutive host points Q, Q + G, ... from a random Q."""
    pts = [_rand()]
    for _ in range(n - 1):
        pts.append(pts[-1] + G)
    return pts


@pytest.mark.parametrize("infinite", ["none", "all", "first-and-last"])
@pytest.mark.parametrize("M", [1, 2, 7, 129, 1000])
def test_normalize_plain_ragged_widths(M, infinite):
    """The plain normalize that the card holds its kernel against, at
    ragged widths, against the host's affine points: (x, y, 1), and
    (0, 0, 0) where Z = 0, whatever X and Y are there."""
    rows = [_jac(q) for q in _walk(M)]
    inf = {"none": set(), "all": set(range(M)),
           "first-and-last": {0, M - 1}}[infinite]
    for i in inf:
        rows[i] = [rng.randrange(P_MOD), rng.randrange(P_MOD), 0]
    X, Y, Z = _ints(pk.jacobian_normalize(F, *_tp(rows)))
    for i, (x, y, z) in enumerate(rows):
        if i in inf:
            assert (X[i], Y[i], Z[i]) == (0, 0, 0), i
        else:
            assert (X[i], Y[i], Z[i]) == (*_aff(_host_point(x, y, z)),), i


def test_normalize_of_no_points_is_empty():
    e = F.pack([1])[:, :0].contiguous()
    out = pk.jacobian_normalize(F, e, e, e)
    assert [tuple(t.shape) for t in out] == [(12, 0)] * 3


@pytest.mark.parametrize("M", [5, 64])
def test_double_plain_y_or_z_zero(M):
    """The plain double that the card holds its kernel against, on a batch
    with Y1 = 0 lanes (no point of G1 has one: raw coordinates) and Z1 = 0
    lanes beside points: the formula's infinity, (1, 1, 0) in plain-1
    limbs, on the first two, the host's double on the points."""
    rows = [_jac(q) for q in _walk(M)]
    y0, z0 = set(range(1, M, 4)), set(range(2, M, 4))
    for i in y0:
        rows[i][1] = 0
    for i in z0:
        rows[i] = [rng.randrange(P_MOD), rng.randrange(P_MOD), 0]
    out = pk.jacobian_double(F, *_tp(rows))
    plain_one = torch.zeros(12, dtype=torch.int32)
    plain_one[0] = 1
    for i, row in enumerate(rows):
        if i in y0 | z0:
            assert torch.equal(out[0][:, i], plain_one), i
            assert torch.equal(out[1][:, i], plain_one), i
            assert not out[2][:, i].any(), i
        else:
            got = _host_point(*(int(F.unpack(t[:, i:i + 1])[0]) for t in out))
            assert got == _host_point(*row).double(), i


# ---------------------------------------------------------------------------
# a host-integer model of csrc/normalize.cu's schedule and of field.cuh's
# window chain (make_window_chain, pow_window), on Montgomery values
# ---------------------------------------------------------------------------

R_MONT = 1 << 384
ONE_M = R_MONT % P_MOD
R_INV = pow(R_MONT, -1, P_MOD)


def _mm(a, b):
    return a * b * R_INV % P_MOD


def _window_chain(e, W):
    """(first, [(squares, odd)], tail) as make_window_chain builds it."""
    def bit(b):
        return (e >> b) & 1

    sq, first, wins, i = 0, None, [], e.bit_length() - 1
    while i >= 0:
        if not bit(i):
            sq, i = sq + 1, i - 1
            continue
        j = max(i - W + 1, 0)
        while not bit(j):
            j += 1
        d = int("".join(str(bit(b)) for b in range(i, j - 1, -1)), 2)
        if first is None:
            first = d >> 1
        else:
            wins.append((sq + i - j + 1, d >> 1))
        sq, i = 0, j - 1
    return first, wins, sq


def _pow_window(a, chain, W):
    """pow_window on a Montgomery value; returns (a^e, squares, products)."""
    first, wins, tail = chain
    odd, a2 = [a], _mm(a, a)
    for _ in range(1, 1 << (W - 1)):
        odd.append(_mm(odd[-1], a2))
    acc, n_sq, n_mul = odd[first], int(W > 1), (1 << (W - 1)) - 1
    for s, o in wins:
        for _ in range(s):
            acc = _mm(acc, acc)
        acc, n_sq, n_mul = _mm(acc, odd[o]), n_sq + s, n_mul + 1
    for _ in range(tail):
        acc = _mm(acc, acc)
    return acc, n_sq + tail, n_mul


T_NORM, K_NORM = pk.NORMALIZE_THREADS, pk.NORMALIZE_CHUNK


def _normalize_model(X, Y, Z):
    """normalize_kernel block by block, thread by thread: prefixes parked
    in the x output, the block's product tree, one chain at its root, the
    walk back.  It mirrors csrc/normalize.cu's indexing line for line (the
    chunk's stride, the prefix offset, the tree's node layout) and must be
    changed with it: these cases test this copy of the schedule, and only
    the card's check holds the kernel itself."""
    M = len(Z)
    xo, yo, zo = [None] * M, [None] * M, [None] * M
    T, chunk = T_NORM, K_NORM
    chain = _window_chain(P_MOD - 2, 5)
    tree_log = T.bit_length() - 1
    for b in range(-(-M // (T * chunk))):
        node, runs = [None] * (2 * T - 1), []
        for j in range(T):
            first = b * T * chunk + j
            n = min(chunk, (M - 1 - first) // T + 1) if first < M else 0
            acc = ONE_M
            for s in range(n):
                i = first + s * T
                t = Z[i] or ONE_M
                acc = t if s == 0 else _mm(acc, t)
                xo[i] = acc
            node[j] = acc
            runs.append((first, n))
        off = 0
        for lev in range(tree_log):
            w = T >> (lev + 1)
            for j in range(w):
                node[off + 2 * w + j] = _mm(node[off + 2 * j],
                                            node[off + 2 * j + 1])
            off += 2 * w
        for j in range(T >> tree_log):
            node[off + j] = _pow_window(node[off + j], chain, 5)[0]
        for lev in range(tree_log, 0, -1):
            w = T >> lev
            off -= 2 * w
            for j in range(w):
                inv, left, right = (node[off + 2 * w + j], node[off + 2 * j],
                                    node[off + 2 * j + 1])
                node[off + 2 * j], node[off + 2 * j + 1] = (_mm(inv, right),
                                                            _mm(inv, left))
        for j, (first, n) in enumerate(runs):
            acc = node[j]
            for s in range(n - 1, -1, -1):
                i = first + s * T
                inf = Z[i] == 0
                if s > 0:
                    zi = _mm(acc, xo[i - T])
                    acc = _mm(acc, Z[i] or ONE_M)
                else:
                    zi = acc
                z2 = _mm(zi, zi)
                xo[i] = 0 if inf else _mm(X[i], z2)
                yo[i] = 0 if inf else _mm(Y[i], _mm(z2, zi))
                zo[i] = 0 if inf else ONE_M
    return xo, yo, zo


def test_window_chain_model_steps():
    """The chain normalize runs for p - 2 at width 5: 378 squares and 82
    products (460 steps against the binary chain's 380 and 228), and the
    power it computes, at widths 1 to 6 and other exponents."""
    a = rng.randrange(1, P_MOD)
    for W in range(1, 7):
        for e in (P_MOD - 2, tb.R - 2, 1, 2, 6, 1 << 100, 0b1000001000000):
            got, n_sq, n_mul = _pow_window(a * R_MONT % P_MOD,
                                           _window_chain(e, W), W)
            assert got == pow(a, e, P_MOD) * R_MONT % P_MOD, (W, e)
            if e == P_MOD - 2:
                assert (n_sq, n_mul) == {1: (380, 228), 5: (378, 82)}.get(
                    W, (n_sq, n_mul))
            assert len(_window_chain(e, W)[1]) + 1 <= 32 * 12 // W + 1


def test_normalize_shape_matches_kernel_source():
    """The shape the card's check and the model take is normalize.cu's:
    T threads a block, CHUNK points a thread, a tree over the whole
    block."""
    src = (build.CSRC / "normalize.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (T|CHUNK|TREE_LOG) = (\d+);", src)}
    assert const == {"T": T_NORM, "CHUNK": K_NORM,
                     "TREE_LOG": T_NORM.bit_length() - 1}


@pytest.mark.parametrize("M,infinite", [
    (1, "none"), (K_NORM + 1, "none"), (T_NORM + 1, "all"),
    (T_NORM * K_NORM - 1, "chunk-ends"), (T_NORM * K_NORM + 3, "chunk-ends"),
    (2 * T_NORM * K_NORM + 5, "block")])
def test_normalize_schedule_model(M, infinite):
    """The kernel's schedule (chunks strided by T, prefixes parked in the
    x output, a product tree over the block, one chain at its root, the
    walk back) gives what the plain normalize gives, on ragged widths
    about the chunk and the block, all infinities, Z = 0 at the first and
    last point of every thread's chunk, or a block of infinities."""
    T, chunk = T_NORM, K_NORM
    span = T * chunk
    rows = [_jac(q) for q in _walk(M)]
    for i in range(M):
        s, first = i % span // T, i // span * span + i % T
        last = min(chunk, (M - 1 - first) // T + 1) - 1
        if {"all": True, "none": False, "block": i // span == 1,
                "chunk-ends": s in (0, last)}[infinite]:
            rows[i] = [rng.randrange(P_MOD), rng.randrange(P_MOD), 0]
    mont = [[v * R_MONT % P_MOD for v in r] for r in rows]
    got = _normalize_model(*zip(*mont))
    want = _ints(pk.jacobian_normalize_plain(F, *_tp(rows)))
    assert [[v * R_INV % P_MOD for v in c] for c in got] == want
