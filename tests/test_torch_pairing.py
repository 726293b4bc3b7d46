"""The port's BLS12-381 pairing, host and batched, against the reference.

The port's host `miller_loop`, `final_exponentiation`, `multi_pairing`
and `hard_part` (`crypto_tpu_torch/curves/bls12_381.py`) against the
reference's host pairing (`crypto_tpu/curves/bls12_381.py`) on the same
pairs, carried across by `convert`.  `TPairing` on the CPU (the
kernels' plain versions): `miller_loop_batch` per pair against the host
`miller_loop`, `product` at batch widths 1, 3 and 5, and `multi_pairing`
with an infinity pair against the host, in two batched pairing calls.
Exact on canonical integers; the points come from a `random` seed.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tpairing import TPairing, tpairing_for

TP = tpairing_for("bls12_381", "cpu")


def _pairs(seed: int, n: int) -> list:
    """n pairs of the reference's random G1 and G2 points (normalised)."""
    rng = random.Random(seed)
    return [(jb.G1.rand(rng).normalize(), jb.G2.rand(rng).normalize())
            for _ in range(n)]


def _port(pairs) -> list:
    return convert.carry_pairs(pairs, tb.G1, tb.G2)


def _same(x, y) -> bool:
    return convert.fp12_ints(x) == convert.fp12_ints(y)


def test_host_pairing_vs_reference():
    """Miller loops (one pair, two pairs with one infinite), the final
    exponentiation, its hard part against the generic exponent, the
    multi-pairing and bilinearity, all against the reference's host."""
    ref = _pairs(1, 2) + [(jb.G1.infinity(), jb.G2.generator())]
    port = _port(ref)
    for k in (1, 3):
        m_t, m_j = tb.miller_loop(port[:k]), jb.miller_loop(ref[:k])
        assert _same(m_t, m_j)
        assert _same(tb.final_exponentiation(m_t),
                     jb.final_exponentiation(m_j))
    assert _same(tb.multi_pairing(port), jb.multi_pairing(ref))
    f = tb.miller_loop(port[:1])
    easy = f.conjugate() * f.inverse()
    easy = easy.frobenius(2) * easy
    assert tb.hard_part(easy) == tb.hard_part_generic(easy)
    g1, g2 = tb.G1.generator(), tb.G2.generator()
    a, b = 1234567, 891011
    assert tb.pairing(g1 * a, g2 * b) == tb.pairing(g1 * (a * b), g2) \
        == tb.gt_generator() ** (a * b)
    assert tb.multi_pairing([(g1 * a, g2), (-(g1 * a), g2)]).is_one()
    assert tb.multi_pairing([]).is_one()


def test_miller_loop_batch_per_pair():
    """One batched Miller loop over three pairs, one with G1 at infinity:
    each lane equals the host Miller loop of its pair (the identity for
    the infinite one), and the lane mask is what `pack_pairs` made."""
    pairs = _port(_pairs(2, 2)) + [(tb.G1.infinity(), tb.G2.generator())]
    packed = TP.pack_pairs(pairs)
    assert packed[4].tolist() == [True, True, False]
    got = TP.t12.unpack_host(TP.miller_loop_batch(*packed))
    want = [tb.miller_loop([pq]) for pq in pairs]
    assert [convert.fp12_ints(x) for x in got] \
        == [convert.fp12_ints(x) for x in want]
    assert want[2].is_one()


@pytest.mark.parametrize("n", [1, 3, 5])
def test_product_tree(n):
    """The log-depth product (odd elements carried up) equals the host
    product at widths 1, 3 and 5."""
    rng = random.Random(10 + n)
    xs = [tb.Fq12.rand(rng) for _ in range(n)]
    want = tb.Fq12.one()
    for x in xs:
        want = want * x
    assert TP.t12.unpack_host(TP.product(TP.t12.pack(xs))) == want


def test_multi_pairing_with_infinity_vs_host():
    """The whole device path (pack, Miller loop, product, final
    exponentiation) on two random pairs and a pair with G2 at infinity
    equals the host multi-pairing, here and in the reference."""
    ref = _pairs(3, 2) + [(jb.G1.generator(), jb.G2.infinity())]
    port = _port(ref)
    got = TP.multi_pairing(port)
    assert got == tb.multi_pairing(port)
    assert _same(got, jb.multi_pairing(ref))
    assert TP.multi_pairing([]).is_one()
    assert TP.miller_product([]).is_one()


def test_tpairing_refuses_other_curves():
    with pytest.raises(ValueError):
        tpairing_for("secp256k1", "cpu")
    with pytest.raises(ValueError):
        TPairing(type("Mod", (), {"X": 5}), "cpu")
