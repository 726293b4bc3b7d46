"""The port's batched double-and-add, `TCurve.scalar_mul`, against the
reference's `JCurve.scalar_mul` and the host.

Four G1 lanes with 16-bit rows from a `random` seed (one lane's bits all
zero, one lane's base at infinity), MSB first: the port takes the bits as
(nbits, M) rows, the reference as (M, nbits); both results equal the
host's `mul_raw` of the same integers, exactly.  The port alone also on a
(2, 2) batch and over G2 (Fq2), against the host.
"""

import random

import numpy as np
import pytest
import torch

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.curves.jcurve import jcurve_for
from crypto_tpu_torch.convert import carry_point
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import tcurve_for
from crypto_tpu_torch.testing import cap_threads

cap_threads()

NBITS = 16


def _lanes(curve, rng, n):
    """n random points of `curve` (the last at infinity) and n integers
    below 2^NBITS (the first 0, the second 2^NBITS - 1)."""
    pts = [curve.generator().mul_raw(rng.randrange(1, tb.R))
           for _ in range(n - 1)] + [curve.infinity()]
    ks = [0, (1 << NBITS) - 1] + [rng.randrange(1 << NBITS)
                                  for _ in range(n - 2)]
    return pts, ks


def _rows(ks, nbits=NBITS) -> np.ndarray:
    """(nbits, n) 0/1, MSB first."""
    return np.array([[(k >> (nbits - 1 - i)) & 1 for k in ks]
                     for i in range(nbits)], dtype=np.int32)


def test_scalar_mul_vs_reference():
    rng = random.Random(71)
    pts, ks = _lanes(tb.G1, rng, 4)
    rows = _rows(ks)
    tc = tcurve_for(tb.G1, "cpu")
    port = tc.unpack(tc.scalar_mul(tc.pack_points(pts),
                                   torch.from_numpy(rows)))
    jc = jcurve_for(jb.G1)
    ref = jc.unpack(jc.scalar_mul(
        jc.pack_points([carry_point(p, jb.G1) for p in pts]),
        np.ascontiguousarray(rows.T)))
    want = [p.mul_raw(k) for p, k in zip(pts, ks)]
    assert port == want
    assert [carry_point(r, tb.G1) for r in ref] == want
    assert port[0].is_infinity() and port[3].is_infinity()


@pytest.mark.parametrize("case", ["g1-batch-2x2", "g2"])
def test_scalar_mul_vs_host(case):
    """Batch shapes past one axis keep the row layout (nbits, *batch); G2
    runs the same steps over `TQuadField` (8-bit rows there)."""
    rng = random.Random(72)
    curve, nbits = (tb.G1, NBITS) if case.startswith("g1") else (tb.G2, 8)
    pts, _ = _lanes(curve, rng, 4)
    ks = [rng.randrange(1 << nbits) for _ in range(4)]
    tc = tcurve_for(curve, "cpu")
    packed = tc.pack_points(pts)
    rows = torch.from_numpy(_rows(ks, nbits))
    if case == "g1-batch-2x2":
        packed = type(packed)(*(t.reshape(t.shape[0], 2, 2) for t in packed))
        rows = rows.reshape(nbits, 2, 2)
    out = tc.scalar_mul(packed, rows)
    assert out.X.shape == packed.X.shape
    assert tc.unpack(out) == [p.mul_raw(k) for p, k in zip(pts, ks)]
