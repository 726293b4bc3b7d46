"""Batch verification of BBS+ signatures and PoK proofs on the device:
the port's copy of `crypto_tpu/bbs_plus/batch.py`.

A random linear combination (reference
`utils/src/randomized_pairing_check.rs`'s accumulation, specialised to
BBS+) verifies N items under one public key:

* signatures (`batch_verify_signatures`): two G1 MSMs of N points, one
  small MSM over the signature params and one 2-pairing product:

      sig_i valid  <=>  e(A_i, pk + e_i g2) == e(b_i, g2)
      batch:  e(sum_i r^i A_i, pk) * e(sum_i r^i e_i A_i - sum_i r^i b_i, g2) == 1
      with sum_i r^i b_i = sum_j P_j (sum_i r^i c_ij), one params MSM.

* PoK proofs (`batch_verify_proofs`): each proof's two Schnorr legs go
  into one `RandomizedMultChecker` (one host MSM over the distinct
  points), and the pairing legs collapse the same way:
  e(sum r^i A'_i, pk) * e(-sum r^i Abar_i, g2) == 1.

The N-point MSMs run on the device from `DEVICE_MSM_THRESHOLD` points on
(`ops/msm_v2.py`), the 2-pairing product on the device when
`CRYPTO_TPU_PAIRING_BACKEND=device` (`curves/tpairing.py`), else on the
host.  Signatures, proofs, keys and params are read by attribute.  Both
run on `device`, CUDA unless the caller names the CPU, and raise without
a card.
"""

from __future__ import annotations

import os
import random as _random

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.tpairing import tpairing_for
from ..ops.msm_v2 import msm_device_scheduled
from ..utils.checkers import RandomizedMultChecker
from ..utils.msm import msm as msm_host
from .signature import BBSPlusError

Fr = bls.Fr
DEVICE_MSM_THRESHOLD = 256


def _msm(points, scalars, device):
    if len(points) >= DEVICE_MSM_THRESHOLD:
        return msm_device_scheduled(points[0].curve,
                                    [p.normalize() for p in points],
                                    [int(s) for s in scalars], device=device)
    return msm_host(points, scalars)


def batch_verify_signatures(sigs: list, messages_list: list, pk, params,
                            rng=None, device="cuda") -> bool:
    """Verify N (signature, messages) pairs under one public key with one
    randomized combined check."""
    dev = resolve_device(device)
    if len(sigs) != len(messages_list):
        raise BBSPlusError("sigs/messages length mismatch")
    if not sigs:
        return True
    rng = rng or _random.Random()
    n_msgs = params.supported_message_count
    for m in messages_list:
        if len(m) != n_msgs:
            raise BBSPlusError("message count incompatible with params")

    weights = [Fr.rand_nonzero(rng) for _ in sigs]
    # combined params-side scalars: c_ij over bases [g1, h_0, h_1..h_M]
    p = Fr.p
    acc_g1 = 0
    acc_h0 = 0
    acc_h = [0] * n_msgs
    for w, sig, msgs in zip(weights, sigs, messages_list):
        wi = int(w)
        acc_g1 = (acc_g1 + wi) % p
        acc_h0 = (acc_h0 + wi * int(sig.s)) % p
        for j, m in enumerate(msgs):
            acc_h[j] = (acc_h[j] + wi * int(m)) % p
    b_comb = msm_host([params.g1, params.h_0] + list(params.h),
                      [acc_g1, acc_h0] + acc_h)

    A_pts = [sig.A for sig in sigs]
    U = _msm(A_pts, weights, dev)                              # sum r^i A_i
    T = _msm(A_pts, [int(w) * int(sig.e) % p for w, sig in zip(weights, sigs)],
             dev)
    lhs = (T - b_comb).normalize()
    out = _multi_pairing([(U.normalize(), pk.w), (lhs, params.g2)], dev)
    return out.is_one()


def batch_verify_proofs(proofs: list, revealed_list: list, challenges: list,
                        pk, params, rng=None, device="cuda") -> bool:
    """Verify N PoKOfSignatureG1 proofs: Schnorr legs via ONE randomized
    MSM, pairing legs via ONE combined 2-pairing product.  As in the
    reference, `proofs`, `revealed_list` and `challenges` are zipped
    without a length check: proofs beyond the shorter lists skip their
    Schnorr legs, and only their pairing legs are checked."""
    dev = resolve_device(device)
    if not proofs:
        return True
    rng = rng or _random.Random()
    rmc = RandomizedMultChecker(Fr.rand_nonzero(rng))
    for proof, revealed, ch in zip(proofs, revealed_list, challenges):
        if proof.A_prime.is_infinity():
            return False
        proof.verify_schnorr_with_randomized_mult_checker(
            revealed, ch, params, rmc)
    if not rmc.verify():
        return False
    weights = [Fr.rand_nonzero(rng) for _ in proofs]
    U = _msm([pr.A_prime for pr in proofs], weights, dev)
    V = _msm([pr.A_bar for pr in proofs], weights, dev)
    out = _multi_pairing([(U.normalize(), pk.w),
                          ((-V).normalize(), params.g2)], dev)
    return out.is_one()


def _multi_pairing(pairs, device):
    if os.environ.get("CRYPTO_TPU_PAIRING_BACKEND") == "device":
        return tpairing_for("bls12_381", device).multi_pairing(pairs)
    return bls.multi_pairing(pairs)
