"""The port's batched pairing against the reference's device pairing.

One `JPairing.multi_pairing` call (`crypto_tpu/curves/jpairing.py`,
eager on the CPU, about a minute of dispatch) and the port's `TPairing`
on the CPU on the same three pairs, two random and one with G1 at
infinity, carried across by `convert`: equal on canonical integers, and
equal to the host multi-pairing.  This file holds the reference call
alone so that the test runner's file-wise spreading keeps its cost off
the other pairing tests.
"""

import random

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.curves.jpairing import jpairing_for
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tpairing import tpairing_for


def test_multi_pairing_vs_jpairing():
    rng = random.Random(21)
    ref = [(jb.G1.rand(rng).normalize(), jb.G2.rand(rng).normalize())
           for _ in range(2)] + [(jb.G1.infinity(),
                                  jb.G2.rand(rng).normalize())]
    want = jpairing_for("bls12_381").multi_pairing(ref)
    got = tpairing_for("bls12_381", "cpu").multi_pairing(
        convert.carry_pairs(ref, tb.G1, tb.G2))
    assert convert.fp12_ints(got) == convert.fp12_ints(want)
    assert convert.fp12_ints(got) == convert.fp12_ints(jb.multi_pairing(ref))
