"""The port's BN254 pairing (`curves/tpairing.py` `TPairingBN`, on the CPU
over the plain versions) against the reference's host BN254 pairing
and the port's host copy.

* The per-pair Miller values of three pairs, one with G1 at infinity,
  against the host `miller_loop` of each pair (both packages): the
  formulas are the same, so the values are equal before the final
  exponentiation, not just after it.
* Their multi-pairing against the reference's `bn254.multi_pairing`.
* Bilinearity on one pair: e(aP, bQ) e(-abP, Q) == 1.
* `tpairing_for` picks the family by the curve's name; each family
  refuses the other's curve.

The reference's `JPairingBN` is not run (its test is marked slow).  A
CPU multi-pairing here costs ~9 s (the hard part's four digits take ~254
cyclotomic squares of a 4-lane batch).
"""

import random

import pytest

from crypto_tpu.curves import bn254 as jbn
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tbl
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.curves.tpairing import TPairing, TPairingBN, \
    tpairing_for
from crypto_tpu_torch.testing import cap_threads

cap_threads()

TP = tpairing_for("bn254", "cpu")


def _pairs():
    rng = random.Random(13)
    g1, g2 = tbn.G1.generator(), tbn.G2.generator()
    pairs = [(g1.mul_raw(rng.randrange(1, tbn.R)),
              g2.mul_raw(rng.randrange(1, tbn.R))) for _ in range(2)]
    return pairs + [(tbn.G1.infinity(), g2.mul_raw(5))]


def test_miller_values_equal_host_per_pair():
    pairs = _pairs()
    got = TP.t12.unpack_host(TP.miller_loop_batch(*TP.pack_pairs(pairs)))
    assert list(got) == [tbn.miller_loop([pq]) for pq in pairs]
    jpairs = convert.carry_pairs(pairs, jbn.G1, jbn.G2)
    assert [convert.fp12_ints(f) for f in got] == \
        [convert.fp12_ints(jbn.miller_loop([pq])) for pq in jpairs]


def test_multi_pairing_vs_reference_host():
    pairs = _pairs()
    got = TP.multi_pairing(pairs)
    want = jbn.multi_pairing(convert.carry_pairs(pairs, jbn.G1, jbn.G2))
    assert convert.fp12_ints(got) == convert.fp12_ints(want)
    assert got == tbn.multi_pairing(pairs)


def test_bilinearity():
    a, b = 0x1F2E3D4C5B6A7988, 0x123456789ABCDEF
    g1, g2 = tbn.G1.generator(), tbn.G2.generator()
    out = TP.multi_pairing([(g1.mul_raw(a), g2.mul_raw(b)),
                            (-g1.mul_raw(a * b % tbn.R), g2)])
    assert out == tbn.Fq12.one()


def test_families_by_name():
    assert isinstance(TP, TPairingBN)
    assert tpairing_for("bn254", "cpu") is TP
    assert type(tpairing_for("bls12_381", "cpu")) is TPairing
    with pytest.raises(ValueError):
        TPairingBN(tbl, "cpu")
    with pytest.raises(ValueError):
        TPairing(tbn, "cpu")
    with pytest.raises(ValueError):
        tpairing_for("bn256", "cpu")
    d = (tbn.P ** 4 - tbn.P ** 2 + 1) // tbn.R
    assert sum(v * tbn.P ** i for i, v in enumerate(TP.hard_digits)) == d
    assert TP.multi_pairing([]) == tbn.Fq12.one()
