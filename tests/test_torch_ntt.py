"""The port's NTT (`crypto_tpu_torch/ops/ntt.py`) and the QAP witness
map's device half (`legogroth16/snark.py` `qap_h`) against the
reference's `NTTDomain` and a naive DFT, on the CPU (the plain mont_mul).

Exact canonical integers are compared.  One case runs the reference with
its Pallas Montgomery kernel in interpret mode, in a subprocess that
sets `CRYPTO_TPU_MUL_BACKEND=pallas` and `CRYPTO_TPU_PALLAS_INTERPRET=1`
before it imports `crypto_tpu`.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.ops.ntt import domain_for as ref_domain_for
from crypto_tpu.ops.ntt import poly_mul_ntt as ref_poly_mul_ntt
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16.snark import qap_h
from crypto_tpu_torch.ops.ntt import NTTDomain, _bit_reverse_perm, \
    domain_for, poly_mul_ntt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = tb.R
SIZES = [8, 32, 1024]


def _vals(n: int, seed: int) -> list:
    rng = random.Random(seed)
    # the edges 0, 1 and r - 1, then uniform values
    return ([0, 1, R - 1] + [rng.randrange(R) for _ in range(n)])[:n]


def _naive_dft(vals: list, w: int) -> list:
    """sum_j vals[j] w^(ij), from one table of the n powers of w."""
    n = len(vals)
    pw = [pow(w, i, R) for i in range(n)]
    return [sum(v * pw[i * j % n] for j, v in enumerate(vals)) % R
            for i in range(n)]


def _naive_coset(vals: list, w: int, g: int) -> list:
    """The polynomial with coefficients vals at g w^i."""
    gj = [pow(g, j, R) for j in range(len(vals))]
    return _naive_dft([v * s % R for v, s in zip(vals, gj)], w)


def test_bit_reverse_perm():
    assert _bit_reverse_perm(8).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
    perm = _bit_reverse_perm(1024)
    assert sorted(perm.tolist()) == list(range(1024))
    assert (perm[perm] == np.arange(1024)).all()


@pytest.mark.parametrize("n", SIZES)
def test_domain_constants_match_reference(n):
    port, ref = domain_for(tb.Fr, n, "cpu"), ref_domain_for(rb.Fr, n)
    assert (port.n, port.k, port.w, port.w_inv, port.n_inv) == \
        (ref.n, ref.k, ref.w, ref.w_inv, ref.n_inv)
    assert port.z_on_coset() == ref.z_on_coset()
    assert domain_for(tb.Fr, n, "cpu") is port
    assert port.device.type == "cpu"


@pytest.mark.parametrize("n", SIZES)
def test_ntt_and_intt_match_reference_and_naive(n):
    port, ref = domain_for(tb.Fr, n, "cpu"), ref_domain_for(rb.Fr, n)
    vals = _vals(n, n)
    fwd = port.ntt_ints(vals)
    assert fwd == ref.ntt_ints(vals)
    assert fwd == _naive_dft(vals, port.w)
    inv = port.ntt_ints(vals, inverse=True)
    assert inv == ref.ntt_ints(vals, inverse=True)
    assert inv == [v * port.n_inv % R for v in _naive_dft(vals, port.w_inv)]
    assert port.ntt_ints(fwd, inverse=True) == vals


@pytest.mark.parametrize("n", SIZES)
def test_coset_ntt_and_intt_match_reference_and_naive(n):
    port, ref = domain_for(tb.Fr, n, "cpu"), ref_domain_for(rb.Fr, n)
    vals = _vals(n, n + 1)
    fwd = port.ntt_ints(vals, coset=True)
    assert fwd == ref.ntt_ints(vals, coset=True)
    assert fwd == _naive_coset(vals, port.w, tb.Fr.generator)
    inv = port.ntt_ints(vals, inverse=True, coset=True)
    assert inv == ref.ntt_ints(vals, inverse=True, coset=True)
    assert port.ntt_ints(fwd, inverse=True, coset=True) == vals


def test_batched_ntt_over_leading_axes():
    """(L, 2, 3, n): every row transformed on its own."""
    n = 16
    dom = domain_for(tb.Fr, n, "cpu")
    rows = [[_vals(n, 100 + 3 * i + j) for j in range(3)] for i in range(2)]
    out = dom.ntt(dom.T.pack(rows))
    assert tuple(out.shape) == (dom.T.L, 2, 3, n)
    got = dom.T.unpack(out)
    for i in range(2):
        for j in range(3):
            assert [int(v) for v in got[i, j]] == \
                _naive_dft(rows[i][j], dom.w)


@pytest.mark.parametrize("la,lb", [(1, 1), (8, 13), (500, 520)])
def test_poly_mul_matches_reference_and_schoolbook(la, lb):
    a, b = _vals(la, la + 7), _vals(lb, lb + 9)
    want = [0] * (la + lb - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            want[i + j] = (want[i + j] + x * y) % R
    got = poly_mul_ntt(tb.Fr, a, b, device="cpu")
    assert got == want
    assert got == ref_poly_mul_ntt(rb.Fr, a, b)


def test_domain_rejects_bad_sizes():
    with pytest.raises(ValueError):
        NTTDomain(tb.Fr, 12, "cpu")
    with pytest.raises(ValueError):
        NTTDomain(tb.Fr, 1 << 33, "cpu")


def _ref_qap_h(n: int, a: list, b: list, c: list) -> list:
    """The reference's device half of `witness_map`
    (`crypto_tpu/legogroth16/snark.py:319-330`), step for step."""
    domain = ref_domain_for(rb.Fr, n)
    J = domain.J
    pa, pb, pc = J.pack(a), J.pack(b), J.pack(c)
    ca = domain.coset_ntt(domain.intt(pa))
    cb = domain.coset_ntt(domain.intt(pb))
    cc = domain.coset_ntt(domain.intt(pc))
    ab = J.sub(J.mul(ca, cb), cc)
    zinv = pow(domain.z_on_coset(), -1, rb.R)
    ab = J.mul(ab, J.pack([zinv])[0])
    h = domain.coset_intt(ab)
    return [int(v) for v in np.atleast_1d(J.unpack(h))]


@pytest.mark.parametrize("n", [16, 64])
def test_qap_h_matches_reference_device_half(n):
    """Rows of a satisfied system (c = a b at every point) and of an
    unsatisfied one: the reference's h coefficients either way."""
    rng = random.Random(n)
    a = [rng.randrange(R) for _ in range(n)]
    b = [rng.randrange(R) for _ in range(n)]
    dom = domain_for(tb.Fr, n, "cpu")
    T = dom.T
    for satisfied in (True, False):
        c = [x * y % R for x, y in zip(a, b)] if satisfied \
            else [rng.randrange(R) for _ in range(n)]
        h = qap_h(dom, T.pack(a), T.pack(b), T.pack(c))
        got = [int(v) for v in T.unpack(h)]
        assert got == _ref_qap_h(n, a, b, c)
        if satisfied:
            # A B - C = h Z_H exactly, so h has degree below n - 1
            assert got[-1] == 0 and any(got)


SCRIPT = r"""
import json, os, sys
os.environ["CRYPTO_TPU_MUL_BACKEND"] = "pallas"
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.fields.jfield import JField
from crypto_tpu.ops.ntt import domain_for
assert JField._use_pallas_mul()
vals = json.loads(sys.argv[1])
dom = domain_for(rb.Fr, len(vals))
print(json.dumps({"ntt": dom.ntt_ints(vals),
                  "intt": dom.ntt_ints(vals, inverse=True),
                  "coset": dom.ntt_ints(vals, coset=True),
                  "coset_intt": dom.ntt_ints(vals, inverse=True,
                                             coset=True)}))
"""


def test_ntt_matches_reference_pallas_mont_mul_interpret():
    """n = 16 against the reference on its Pallas Montgomery kernel in
    interpret mode."""
    vals = _vals(16, 77)
    env = dict(os.environ, CRYPTO_TPU_MUL_BACKEND="pallas",
               CRYPTO_TPU_PALLAS_INTERPRET="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(vals)],
                         env=env, capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    dom = domain_for(tb.Fr, 16, "cpu")
    assert ref["ntt"] == dom.ntt_ints(vals)
    assert ref["intt"] == dom.ntt_ints(vals, inverse=True)
    assert ref["coset"] == dom.ntt_ints(vals, coset=True)
    assert ref["coset_intt"] == dom.ntt_ints(vals, inverse=True, coset=True)
