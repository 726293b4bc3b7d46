"""VB accumulator setup: the port's own copy of
`crypto_tpu/accumulator/setup.py` (reference `vb_accumulator/src/setup.rs`).

sk = alpha; pk = alpha * P_tilde (G2); params (P, P_tilde) hashed from a
label by try-and-increment (`crypto_tpu_torch/hashing.py`) or drawn from
an rng.  Host Python ints only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import (blake2b512, concat_slices, field_elem_from_try_and_incr,
                       group_elem_from_try_and_incr)
from ..utils.zeroize import ZeroizeMixin


@dataclass
class AccumSecretKey(ZeroizeMixin):
    alpha: Fp

    DST = b"VB-ACCUM-KEYGEN-SALT"

    @classmethod
    def generate(cls, rng) -> "AccumSecretKey":
        return cls(bls.Fr.rand_nonzero(rng))

    @classmethod
    def generate_using_seed(cls, seed: bytes) -> "AccumSecretKey":
        return cls(field_elem_from_try_and_incr(bls.Fr, cls.DST + seed))


@dataclass
class AccumPublicKey:
    Q_tilde: Point  # alpha * P_tilde

    @classmethod
    def generate(cls, sk: AccumSecretKey, params: "AccumSetupParams"):
        return cls((params.P_tilde * int(sk.alpha)).normalize())

    def is_valid(self) -> bool:
        return not self.Q_tilde.is_infinity()


@dataclass
class AccumSetupParams:
    P: Point        # G1 generator
    P_tilde: Point  # G2 generator

    @classmethod
    def new(cls, label: bytes, digest=blake2b512) -> "AccumSetupParams":
        P = group_elem_from_try_and_incr(
            bls.G1, concat_slices(label, b" : P"), digest).normalize()
        P_tilde = group_elem_from_try_and_incr(
            bls.G2, concat_slices(label, b" : P_tilde"), digest).normalize()
        return cls(P=P, P_tilde=P_tilde)

    @classmethod
    def generate_using_rng(cls, rng) -> "AccumSetupParams":
        return cls(P=bls.G1.rand(rng).normalize(),
                   P_tilde=bls.G2.rand(rng).normalize())


@dataclass
class AccumKeypair:
    secret_key: AccumSecretKey
    public_key: AccumPublicKey

    @classmethod
    def generate(cls, rng, params: AccumSetupParams) -> "AccumKeypair":
        sk = AccumSecretKey.generate(rng)
        return cls(sk, AccumPublicKey.generate(sk, params))

