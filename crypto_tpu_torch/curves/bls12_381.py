"""BLS12-381: the base field Fq, the scalar field Fr and the G1 curve.

The port's own copy of the Fq, Fr and G1 part of
`crypto_tpu/curves/bls12_381.py` (standard BLS12-381 constants, as in
arkworks `ark-bls12-381`).  The tower, G2 and the pairing wait for the
slice that ports them.
"""

from __future__ import annotations

from ..fields.host import Field
from .sw import SWCurve

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624_1EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D805_53BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter (negative): p, r are polynomials in x
X = -0xD201000000010000

Fq = Field("bls12_381.Fq", P, generator=2)
Fr = Field("bls12_381.Fr", R, generator=7)

assert Fr.two_adicity == 32
assert R == X ** 4 - X ** 2 + 1
assert P == (X - 1) ** 2 * (X ** 4 - X ** 2 + 1) // 3 + X

G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

G1 = SWCurve(
    "bls12_381.G1", Fq, Fq(0), Fq(4), Fr,
    cofactor=G1_COFACTOR,
    generator_xy=(
        Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
        Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    ),
)
