"""Batch-update polynomials for VB accumulators: the port's own copy of
`crypto_tpu/accumulator/batch_utils.py` (reference
`vb_accumulator/src/batch_utils.rs`, paper 2020/777 sections 3-4).

* d_A / d_D: `prod (y_i - x)` over the added/removed batch
* v_A(x) = sum_{s=0}^{n-1} [ prod_{i<s}(y_i + alpha) * prod_{i>s}(y_i - x) ]
* v_D(x) = sum_{s=0}^{n-1} [ 1/prod_{i<=s}(y_i + alpha) * prod_{i<s}(y_i - x) ]
* v_AD(x) = v_A(x) - v_D(x) * prod_{i}(add_i + alpha)
* Omega = [ c_i * V ]  for coefficients c_i of v_AD — public witness-update
  data (section 4.1).

Witness updates (section 3):
  after additions:  C' = d_A(y)*C + v_A(y)*V_old
  after removals:   C' = 1/d_D(y)*C - v_D(y)/d_D(y)*V_old
  both:             C' = d_A(y)/d_D(y)*C + v_AD(y)/d_D(y)*V_old
  public-info:      C' = d_A(y)/d_D(y)*C + 1/d_D(y)*<powers of y, Omega>

Host Python ints, except where a function takes `device=` (CUDA unless
the caller names the CPU; raises without a card): polynomial products
from 256 coefficients on go through the NTT (`ops/ntt.py`
`poly_mul_ntt`), and `Omega.new`'s products of V through
`utils/msm.py` `multiply_field_elems_with_same_group_elem` (the device
fixed-base table from 512 coefficients on).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..ops.ntt import poly_mul_ntt
from ..utils.ff import multiply_poly
from ..utils.msm import msm, multiply_field_elems_with_same_group_elem
from .setup import AccumSecretKey

F = bls.Fr


def _batch_inverse(values):
    """Montgomery's trick on host ints."""
    n = len(values)
    prefix = [None] * n
    acc = F.one()
    for i, v in enumerate(values):
        prefix[i] = acc
        acc = acc * v
    inv = acc.inverse()
    out = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv
        inv = inv * values[i]
    return out


def _poly_mul(a, b, device):
    """Dispatch polynomial multiplication: schoolbook for small, NTT for big."""
    if (len(a) + len(b)) < 256:
        return multiply_poly(a, b)
    ints = poly_mul_ntt(F, [int(x) for x in a], [int(y) for y in b],
                        device=device)
    return [F(v) for v in ints]


def poly_d_eval(updates, x: Fp) -> Fp:
    """d(x) = prod (y_i - x); empty batch -> 1 (`batch_utils.rs:102-106`)."""
    acc = F.one()
    for y in updates:
        acc = acc * (y - x)
    return acc


def poly_v_A_coeffs(additions, alpha: Fp, device="cuda"):
    """Coefficient form of v_A (low-first)."""
    dev = resolve_device(device)
    n = len(additions)
    if n == 0:
        return [F.zero()]
    if n == 1:
        return [F.one()]
    # factors[s] = prod_{i<s}(y_i + alpha); polys[s] = prod_{i>s}(y_i - x)
    factors = [F.one()] * n
    polys = [[F.one()]] * n
    for s in range(1, n):
        factors[s] = factors[s - 1] * (additions[s - 1] + alpha)
        polys[n - 1 - s] = _poly_mul(polys[n - s],
                                     [additions[n - s], -F.one()], dev)
    out = [F.zero()] * max(len(p) for p in polys)
    for s in range(n):
        for i, c in enumerate(polys[s]):
            out[i] = out[i] + c * factors[s]
    return out


def poly_v_A_eval(additions, alpha: Fp, x: Fp) -> Fp:
    n = len(additions)
    if n == 0:
        return F.zero()
    if n == 1:
        return F.one()
    acc = F.zero()
    factor = F.one()
    # suffix products of (y_i - x)
    suffix = [F.one()] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix[i] = suffix[i + 1] * (additions[i] - x)
    for s in range(n):
        acc = acc + factor * suffix[s + 1]
        factor = factor * (additions[s] + alpha)
    return acc


def poly_v_D_coeffs(removals, alpha: Fp, device="cuda"):
    dev = resolve_device(device)
    n = len(removals)
    if n == 0:
        return [F.zero()]
    inv = _batch_inverse([y + alpha for y in removals])
    factors = [F.one()] * n
    polys = [[F.one()]] * n
    factors[0] = inv[0]
    for s in range(1, n):
        factors[s] = factors[s - 1] * inv[s]
        polys[s] = _poly_mul(polys[s - 1], [removals[s - 1], -F.one()], dev)
    out = [F.zero()] * max(len(p) for p in polys)
    for s in range(n):
        for i, c in enumerate(polys[s]):
            out[i] = out[i] + c * factors[s]
    return out


def poly_v_D_eval(removals, alpha: Fp, x: Fp) -> Fp:
    n = len(removals)
    if n == 0:
        return F.zero()
    inv = _batch_inverse([y + alpha for y in removals])
    acc = F.zero()
    factor = F.one()
    prefix = F.one()
    for s in range(n):
        factor = factor * inv[s]
        acc = acc + factor * prefix
        prefix = prefix * (removals[s] - x)
    return acc


def poly_v_AD_coeffs(additions, removals, alpha: Fp, device="cuda"):
    p = poly_v_A_coeffs(additions, alpha, device)
    if removals:
        f = F.one()
        for a in additions:
            f = f * (a + alpha)
        q = poly_v_D_coeffs(removals, alpha, device)
        ln = max(len(p), len(q))
        p = p + [F.zero()] * (ln - len(p))
        q = q + [F.zero()] * (ln - len(q))
        p = [pc - qc * f for pc, qc in zip(p, q)]
    return p


def poly_v_AD_eval(additions, removals, alpha: Fp, x: Fp) -> Fp:
    e = poly_v_A_eval(additions, alpha, x)
    if removals:
        f = F.one()
        for a in additions:
            f = f * (a + alpha)
        e = e - poly_v_D_eval(removals, alpha, x) * f
    return e


@dataclass
class Omega:
    """Public witness-update data: [c_i * V_old] (`batch_utils.rs:480-560`)."""
    points: list

    @classmethod
    def new(cls, additions, removals, old_accumulator: Point,
            sk: AccumSecretKey, device="cuda") -> "Omega":
        coeffs = poly_v_AD_coeffs(additions, removals, sk.alpha, device)
        pts = multiply_field_elems_with_same_group_elem(
            old_accumulator, coeffs, device=device)
        return cls([p.normalize() for p in pts])

    def evaluate(self, element: Fp, scale: Fp) -> Point:
        """<powers of element, omega> * scale (one MSM)."""
        scalars = []
        acc = scale
        for _ in self.points:
            scalars.append(acc)
            acc = acc * element
        return msm(self.points, scalars)
