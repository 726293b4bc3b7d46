"""Batched pairings on tensors: the port's `JPairing` and `JPairingBN`.

Counterparts of `crypto_tpu/curves/jpairing.py` `JPairing` (the optimal
ate pairing of the host `curves/bls12_381.py`: M-type twist, negative x,
lines multiplied in by `_mul_by_014`) and `JPairingBN` (`TPairingBN`, the
host `curves/bn254.py`'s: D-type twist, positive x, a loop over the bits
of 6x + 2 closed by two Frobenius addition steps, lines multiplied in by
`_mul_by_034`, the hard part from the base-p digits of (p^4 - p^2 +
1)/r).  N pairs run as one batch along
the last axis: the Miller loop is a static loop over the bits of |x| (63
doubling steps, the addition steps where a bit is set, no selects), each
step over all pairs at once, every pair's value kept apart; `product`
multiplies them up a log-depth tree, then one final exponentiation.
`multi_pairings` takes k independent lists of pairs as one batch (one
Miller loop over all their pairs, a tree product along each list, one
final exponentiation over the k products), so the host dispatch of a
pairing is paid once for all of them; `multi_pairings_routed` sends a
call to the host pairing instead when its weight (its pairs, and
`HOST_GROUP_PAIRS` for each product's final exponentiation) stays below
`PAIRING_BATCH_THRESHOLD`.
Pairs with a point at infinity are inactive lanes whose lines are masked
to (1, 0, 0), so they contribute the identity.

All arithmetic is the port's towers (`fields/ttower.py`): Fq2 products
through the `fq2_mul` kernel, squares through `fq2_sqr`, the line
coefficients' scaling by the G1 point and the doubling's halvings
through `mont_mul`, the final exponentiation's inverse through
`mont_pow`.  The independent Fq2 products of a step run as one launch
(`_mul_by_014`'s fifteen, for one).  Every op is exact, so the values
equal the host pairing's bit for bit.  No batch is padded.

Every entry point runs on `device`: CUDA unless the caller names the CPU
(where the kernels' plain versions run); it raises without a card.
"""

from __future__ import annotations

import os

import torch

from .. import resolve_device
from ..fields.tfield import tfield_for
from ..fields.ttower import stack, tcubic_for, tfield12_for, tquad_for
from .sw import Point


class TPairing:
    """Device pairing context for a BLS12 curve module with x < 0 (the
    port's `bls12_381`) on one device."""

    def __init__(self, mod, device="cuda"):
        self._check(mod)
        dev = resolve_device(device)
        self.mod = mod
        self.device = dev
        self.tf = tfield_for(mod.Fq, dev)
        self.t2 = tquad_for(mod.Fq2, dev)
        self.t6 = tcubic_for(mod.Fq6, dev)
        self.t12 = tfield12_for(mod.Fq12, dev)
        self.two_inv = self.tf.pack(int(mod.Fq(2).inverse()))
        self._family_init(mod)

    @staticmethod
    def _check(mod):
        if mod.X >= 0:
            raise ValueError("TPairing takes a BLS12 curve with x < 0")

    def _family_init(self, mod):
        x_abs = -mod.X
        self.x_bits = [int(c) for c in bin(x_abs)[2:]]
        # (x - 1)/3 in magnitude, for the hard part's chain
        self.k_bits = [int(c) for c in bin((x_abs + 1) // 3)[2:]]
        self.twist_b = self.t2.pack(mod.XI.mul_base(4))

    # ------------------------------------------------------------------
    # the Miller loop's steps, over (2L, B) batches of G2 coordinates
    # ------------------------------------------------------------------

    def _col(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A constant element (rows,) viewed to broadcast against `like`."""
        return t.view(t.shape + (1,) * (like.dim() - 1))

    def _doubling_step(self, rx, ry, rz):
        """Costello-Lange-Naehrig doubling in homogeneous coordinates
        (host `_doubling_step`); returns the new point and the line's
        (c0, c1, c2)."""
        F2 = self.t2
        b, c, j, hh = F2.square(stack(ry, rz, rx, F2.add(ry, rz))).unbind(1)
        xy = F2.mul(rx, ry)
        cj = stack(c, j)
        c3, j3 = F2.add(F2.double(cj), cj).unbind(1)
        e = F2.mul(self._col(self.twist_b, c3), c3)
        f = F2.add(F2.double(e), e)
        bf, bc = F2.add(stack(b, b), stack(f, c)).unbind(1)
        b_f, i, h = F2.sub(stack(b, e, hh), stack(f, b, bc)).unbind(1)
        a, g = F2.mul_base(stack(xy, bf), self._col(self.two_inv, bf)
                           .unsqueeze(1)).unbind(1)
        e2, g2 = F2.square(stack(e, g)).unbind(1)
        nx, nz = F2.mul(stack(a, b), stack(b_f, h)).unbind(1)
        ny = F2.sub(g2, F2.add(F2.double(e2), e2))
        return (nx, ny, nz), (i, j3, F2.neg(h))

    def _addition_step(self, rx, ry, rz, qx, qy):
        """Mixed addition of the affine Q (host `_addition_step`)."""
        F2 = self.t2
        yz, xz = F2.mul(stack(qy, qx), stack(rz, rz)).unbind(1)
        theta, lam = F2.sub(stack(ry, rx), stack(yz, xz)).unbind(1)
        c, d = F2.square(stack(theta, lam)).unbind(1)
        e, f, g = F2.mul(stack(lam, rz, rx), stack(d, c, d)).unbind(1)
        h = F2.sub(F2.add(e, f), F2.double(g))
        p = F2.mul(stack(lam, theta, e, rz, theta, lam),
                   stack(h, F2.sub(g, h), ry, e, qx, qy))
        ny, j = F2.sub(p[:, [1, 4]], p[:, [2, 5]]).unbind(1)
        return (p[:, 0], ny, p[:, 3]), (j, F2.neg(theta), lam)

    def _mul_by_014(self, f, c0, c1, c4):
        """f * (c0 + c1 v + c4 w), the sparse line product (host
        `_mul_by_014`): with f = (x0, x1, x2) + (y0, y1, y2) w, v0 = x (c0
        + c1 v), v1 = y (c4 v) and t = (x + y)(c0 + (c1 + c4) v); their
        fifteen Fq2 products run as one `fq2_mul` launch."""
        F2, F12 = self.t2, self.t12
        z = F12.coords2(f)                               # x0 x1 x2 y0 y1 y2
        s = F2.add(torch.cat([z[:, :3], c1.unsqueeze(1)], 1),
                   torch.cat([z[:, 3:], c4.unsqueeze(1)], 1))
        ops = torch.cat([z, s[:, :3]], 1)                # x, y, x + y
        cs = stack(c0, c1, c4, s[:, 3])                  # c0 c1 c4 c1 + c4
        p = F2.mul(ops[:, [0, 2, 0, 1, 1, 2, 5, 3, 4, 6, 8, 6, 7, 7, 8]],
                   cs[:, [0, 1, 1, 0, 1, 0, 2, 2, 2, 0, 3, 3, 0, 3, 0]])
        # x2 c1, y2 c4 and (x2 + y2)(c1 + c4) carry v^3 = xi; so does
        # v1's top coordinate y1 c4 once v1 is multiplied by v
        xi = self.t6.mul_xi(p[:, [1, 6, 10, 8]])
        u = F2.add(p[:, [0, 2, 4, 9, 11, 13]],
                   torch.cat([xi[:, :1], p[:, 3:4], p[:, 5:6], xi[:, 2:3],
                              p[:, 12:13], p[:, 14:15]], 1))
        v0, t = u[:, :3], u[:, 3:]                       # v1 = xi p6, p7, p8
        v1 = torch.cat([xi[:, 1:2], p[:, 7:9]], 1)
        vv1 = torch.cat([xi[:, 3:4], xi[:, 1:2], p[:, 7:8]], 1)   # v1 * v
        out = torch.cat([F2.add(v0, vv1), F2.sub(F2.sub(t, v0), v1)], 1)
        return out.movedim(1, 0).flatten(0, 1)

    def _ell(self, f, line, px, py, active):
        """f times the line, its c1 and c2 scaled by the G1 point's x and
        y (one `mont_mul` launch); inactive pairs' lines are (1, 0, 0)."""
        F2 = self.t2
        c0, c1, c4 = line
        c0 = F2.select(active, c0, F2.ones(c0.shape[1:]))
        c14 = F2.select(active, stack(c1, c4), 0)
        c1, c4 = F2.mul_base(c14, stack(px, py)).unbind(1)
        return self._mul_by_014(f, c0, c1, c4)

    # ------------------------------------------------------------------
    # the batched Miller loop, the tree product, the final exponentiation
    # ------------------------------------------------------------------

    def pack_pairs(self, pairs):
        """Host [(G1 Point, G2 Point)] -> (px, py (L, B), qx, qy (2L, B),
        active (B,) bool) on the device; a pair with a point at infinity
        is an inactive lane of zeros."""
        Fq, Fq2 = self.mod.Fq, self.mod.Fq2
        px, py, qx, qy, act = [], [], [], [], []
        for p, q in pairs:
            live = not (p.is_infinity() or q.is_infinity())
            x1, y1 = p.to_affine() if live else (Fq(0), Fq(0))
            x2, y2 = q.to_affine() if live else (Fq2.zero(), Fq2.zero())
            px.append(int(x1))
            py.append(int(y1))
            qx.append(x2)
            qy.append(y2)
            act.append(live)
        return (self.tf.pack(px), self.tf.pack(py), self.t2.pack(qx),
                self.t2.pack(qy),
                torch.tensor(act, dtype=torch.bool, device=self.device))

    def miller_loop_batch(self, px, py, qx, qy, active):
        """Per-pair Miller values (12L, B) of packed pairs (`pack_pairs`),
        each equal to the host `miller_loop([(P, Q)])`."""
        F2, F12 = self.t2, self.t12
        shape = px.shape[1:]
        f = F12.ones(shape)
        rx, ry, rz = qx, qy, F2.ones(shape)
        for n, bit in enumerate(self.x_bits[1:]):
            if n:
                f = F12.square(f)
            (rx, ry, rz), line = self._doubling_step(rx, ry, rz)
            f = self._ell(f, line, px, py, active)
            if bit:
                (rx, ry, rz), line = self._addition_step(rx, ry, rz, qx, qy)
                f = self._ell(f, line, px, py, active)
        return F12.conjugate(f)                          # x < 0

    def product(self, fs: torch.Tensor) -> torch.Tensor:
        """The product along axis 1 of a (12L, n, ...) batch, n >= 1, up a
        log-depth tree (the odd element carried to the next level)."""
        n = fs.shape[1]
        while n > 1:
            half = n // 2
            fs = torch.cat([self.t12.mul(fs[:, :half], fs[:, half:2 * half]),
                            fs[:, 2 * half:n]], 1)
            n = fs.shape[1]
        return fs[:, 0]

    def _cyc_exp_abs(self, f, bits):
        """f^e on cyclotomic elements for a static e > 0 (its bits, most
        significant first): cyclotomic squares and products."""
        F12 = self.t12
        r = f
        for bit in bits[1:]:
            r = F12.cyclotomic_square(r)
            if bit:
                r = F12.mul(r, f)
        return r

    def _exp_by_neg_x(self, f):
        return self.t12.conjugate(self._cyc_exp_abs(f, self.x_bits))

    def final_exponentiation(self, f: torch.Tensor) -> torch.Tensor:
        """f^((p^12 - 1)/r) (host `final_exponentiation`): the easy part
        by conjugation, one inverse and a Frobenius, the hard part by
        d = ((x-1)/3)(x-1)(x+p)(x^2+p^2-1) + 1."""
        F12 = self.t12
        f = F12.mul(F12.conjugate(f), F12.inv(f))
        f = F12.mul(F12.frobenius(f, 2), f)
        a = F12.mul(self._exp_by_neg_x(f), F12.conjugate(f))     # f^(x-1)
        b = F12.conjugate(self._cyc_exp_abs(a, self.k_bits))     # ^((x-1)/3)
        c = F12.mul(self._exp_by_neg_x(b), F12.frobenius(b, 1))  # b^(x+p)
        cxx = self._exp_by_neg_x(self._exp_by_neg_x(c))
        d = F12.mul(F12.mul(cxx, F12.frobenius(c, 2)), F12.conjugate(c))
        return F12.mul(d, f)

    # ------------------------------------------------------------------
    # host pairs in, host Fp12 out
    # ------------------------------------------------------------------

    def _pack_groups(self, groups):
        """k lists of host pairs as one batch of m k lanes, m the longest
        list's length: lane j k + g holds pair j of group g, and a shorter
        group's missing pairs are inactive lanes (a pair at infinity)."""
        k, m = len(groups), max(1, max(len(g) for g in groups))
        idle = (self.mod.G1.infinity(), self.mod.G2.infinity())
        return self.pack_pairs([groups[g][j] if j < len(groups[g]) else idle
                                for j in range(m) for g in range(k)]), m, k

    def miller_products(self, groups) -> torch.Tensor:
        """The product of each group's Miller values, (12L, k), no final
        exponentiation: one Miller loop over all the groups' pairs, viewed
        as (12L, m, k) and multiplied up a tree along m."""
        packed, m, k = self._pack_groups(groups)
        return self.product(self.miller_loop_batch(*packed).unflatten(1,
                                                                       (m, k)))

    def multi_pairings(self, groups) -> list:
        """[prod e(P_i, Q_i) over each list of host pairs], host Fp12
        values, each equal to the host `multi_pairing` of its list: one
        batched Miller loop over every pair and one final exponentiation
        over the k products."""
        if not any(groups):
            return [self.mod.Fq12.one() for _ in groups]
        f = self.final_exponentiation(self.miller_products(groups))
        return list(self.t12.unpack_host(f))

    def miller_product(self, pairs):
        """The product of the pairs' Miller values as a host Fp12, no final
        exponentiation: what `RandomizedPairingChecker` accumulates."""
        if not pairs:
            return self.mod.Fq12.one()
        return self.t12.unpack_host(self.miller_products([pairs])[:, 0])

    def multi_pairing(self, pairs):
        """prod e(P_i, Q_i) over host pairs, as a host Fp12, equal to the
        host `multi_pairing`: `multi_pairings` of one group."""
        return self.multi_pairings([pairs])[0]

    def pairing(self, p: Point, q: Point):
        return self.multi_pairing([(p, q)])


class TPairingBN(TPairing):
    """Device pairing context for a BN curve module with x > 0 (the port's
    `bn254`), ported from `JPairingBN`: the D-type twist's lines embed at
    Fq12 coefficients (0, 3, 4), the ate loop runs over the bits of 6x +
    2 and ends with additions of pi(Q) and -pi^2(Q), and the final
    exponentiation's hard part is f^d = prod_i frob(f, i)^(d_i) over the
    base-p digits d_i of d = (p^4 - p^2 + 1)/r.  The doubling and
    addition steps are `TPairing`'s; only the order of a line's
    coefficients differs."""

    @staticmethod
    def _check(mod):
        if mod.X <= 0:
            raise ValueError("TPairingBN takes a BN curve with x > 0")

    def _family_init(self, mod):
        self.ate_bits = [int(c) for c in bin(mod.ATE_LOOP)[2:]]
        self.twist_b = self.t2.pack(mod.TWIST_B)
        self.gamma_x = self.t2.pack(mod.GAMMA_X)
        self.gamma_y = self.t2.pack(mod.GAMMA_Y)
        d = (mod.P ** 4 - mod.P ** 2 + 1) // mod.R
        self.hard_digits = []
        for _ in range(4):
            self.hard_digits.append(d % mod.P)
            d //= mod.P
        if d:
            raise ValueError("the hard part's exponent has more than four "
                             "base-p digits")

    def _mul_by_034(self, f, c0, c3, c4):
        """f * (c0 + c3 w + c4 v w), the D-twist's sparse line product
        (host `_mul_by_034`): with f = x + y w, a = (c0, 0, 0) and b = (c3,
        c4, 0), v0 = x a, v1 = y b and t = (x + y)(a + b); their fifteen
        Fq2 products run as one `fq2_mul` launch."""
        F2 = self.t2
        z = self.t12.coords2(f)                          # x0 x1 x2 y0 y1 y2
        s = F2.add(torch.cat([z[:, :3], c0.unsqueeze(1)], 1),
                   torch.cat([z[:, 3:], c3.unsqueeze(1)], 1))
        ops = torch.cat([z, s[:, :3]], 1)                # x, y, x + y
        cs = stack(c0, c3, c4, s[:, 3])                  # c0 c3 c4 c0 + c3
        p = F2.mul(ops[:, [0, 1, 2, 3, 5, 3, 4, 4, 5, 6, 8, 6, 7, 7, 8]],
                   cs[:, [0, 0, 0, 1, 2, 2, 1, 2, 1, 3, 2, 2, 3, 2, 3]])
        # v1 = (y0 c3 + xi y2 c4, y0 c4 + y1 c3, y1 c4 + y2 c3); t likewise
        # over x + y and c0 + c3, c4
        d12 = F2.add(p[:, [5, 7, 11, 13]], p[:, [6, 8, 12, 14]])
        xi = self.t6.mul_xi(stack(p[:, 4], p[:, 10], d12[:, 1]))
        d0, t0 = F2.add(p[:, [3, 9]], xi[:, :2]).unbind(1)
        v0 = p[:, :3]
        v1 = stack(d0, d12[:, 0], d12[:, 1])
        vv1 = stack(xi[:, 2], d0, d12[:, 0])             # v1 * v
        t = stack(t0, d12[:, 2], d12[:, 3])
        out = torch.cat([F2.add(v0, vv1), F2.sub(F2.sub(t, v0), v1)], 1)
        return out.movedim(1, 0).flatten(0, 1)

    def _ell(self, f, line, px, py, active):
        """f times the line, read in the D-twist's order: c0 = l2 y, c3 =
        l1 x (one `mont_mul` launch), c4 = l0; inactive pairs' lines are
        (1, 0, 0)."""
        F2 = self.t2
        l0, l1, l2 = line
        c0, c3 = F2.mul_base(stack(l2, l1), stack(py, px)).unbind(1)
        c0 = F2.select(active, c0, F2.ones(c0.shape[1:]))
        c3, c4 = F2.select(active, stack(c3, l0), 0).unbind(1)
        return self._mul_by_034(f, c0, c3, c4)

    def _frob_twist(self, qx, qy, power: int):
        """pi^power of affine twist points: x^p gamma_x, y^p gamma_y, each
        step one `fq2_mul` launch."""
        F2 = self.t2
        g = stack(self._col(self.gamma_x, qx), self._col(self.gamma_y, qy))
        q = stack(qx, qy)
        for _ in range(power):
            q = F2.mul(F2.conjugate(q), g)
        return q.unbind(1)

    def miller_loop_batch(self, px, py, qx, qy, active):
        """Per-pair Miller values (12L, B) of packed pairs (`pack_pairs`),
        each equal to the host `miller_loop([(P, Q)])`."""
        F2, F12 = self.t2, self.t12
        shape = px.shape[1:]
        f = F12.ones(shape)
        rx, ry, rz = qx, qy, F2.ones(shape)
        for n, bit in enumerate(self.ate_bits[1:]):
            if n:
                f = F12.square(f)
            (rx, ry, rz), line = self._doubling_step(rx, ry, rz)
            f = self._ell(f, line, px, py, active)
            if bit:
                (rx, ry, rz), line = self._addition_step(rx, ry, rz, qx, qy)
                f = self._ell(f, line, px, py, active)
        q1x, q1y = self._frob_twist(qx, qy, 1)
        (rx, ry, rz), line = self._addition_step(rx, ry, rz, q1x, q1y)
        f = self._ell(f, line, px, py, active)
        q2x, q2y = self._frob_twist(qx, qy, 2)
        _, line = self._addition_step(rx, ry, rz, q2x, F2.neg(q2y))
        return self._ell(f, line, px, py, active)    # x > 0: no conjugation

    def final_exponentiation(self, f: torch.Tensor) -> torch.Tensor:
        """f^((p^12 - 1)/r) (host `final_exponentiation`): the easy part
        by conjugation, one inverse and a Frobenius; the hard part as
        prod_i frob(f, i)^(d_i) over the nonzero base-p digits, the
        powers side by side in one batch: a square-and-multiply over the
        digits' bits, most significant first, each lane multiplied where
        its digit has the bit (`_cyc_exp_abs` of every digit at once)."""
        F12 = self.t12
        f = F12.mul(F12.conjugate(f), F12.inv(f))
        f = F12.mul(F12.frobenius(f, 2), f)
        lanes = [(i, d) for i, d in enumerate(self.hard_digits) if d]
        bases = torch.stack([F12.frobenius(f, i) if i else f
                             for i, _ in lanes], 1)
        top = max(d.bit_length() for _, d in lanes)
        r = F12.ones(bases.shape[1:])
        for b in range(top - 1, -1, -1):
            if b < top - 1:
                r = F12.cyclotomic_square(r)
            take = torch.tensor([(d >> b) & 1 for _, d in lanes],
                                dtype=torch.bool, device=self.device)
            take = take.view((-1,) + (1,) * (bases.dim() - 2))
            r = torch.where(take.unsqueeze(0), F12.mul(r, bases), r)
        return self.product(r)


_CACHE: dict = {}


def tpairing_for(mod_name: str = "bls12_381", device="cuda") -> TPairing:
    """The pairing context of a curve module, "bls12_381" (`TPairing`) or
    "bn254" (`TPairingBN`), on `device` (CUDA unless the caller names the
    CPU; raises without a card)."""
    if mod_name not in ("bls12_381", "bn254"):
        raise ValueError(f"no device pairing for {mod_name!r} in the port")
    dev = resolve_device(device)
    key = (mod_name, str(dev))
    if key not in _CACHE:
        from . import bls12_381, bn254
        _CACHE[key] = TPairing(bls12_381, dev) if mod_name == "bls12_381" \
            else TPairingBN(bn254, dev)
    return _CACHE[key]


# Where `multi_pairings_routed` sends a call.  On the card's host the host
# loop costs 0.020-0.031 s a pair (its Miller loop) and 0.085-0.113 s a
# group (its final exponentiation), so a group weighs HOST_GROUP_PAIRS
# pairs; one batched device call costs 4.4-4.7 s whatever its shape (it
# is bound by host dispatch).  From PAIRING_BATCH_THRESHOLD weighted
# pairs on the device is the faster: the weight of 32 groups of two
# pairs, where two runs of `python3 -m crypto_tpu_torch.time_pairing_route`
# found the two routes level (PERF.md).
HOST_GROUP_PAIRS = 4
PAIRING_BATCH_THRESHOLD = 192


def pairing_route(npairs: int, ngroups: int = 1) -> str:
    """"host" or "device": where `multi_pairings_routed` sends a call of
    `ngroups` products over `npairs` pairs in all.
    `CRYPTO_TPU_PAIRING_BACKEND=host` keeps every call on the host, any
    other value sends every call to the device, as in `utils/checkers.py`;
    unset, the device takes the calls whose weight, npairs +
    `HOST_GROUP_PAIRS` ngroups, reaches `PAIRING_BATCH_THRESHOLD`."""
    backend = os.environ.get("CRYPTO_TPU_PAIRING_BACKEND")
    if backend == "host" or (backend is None and npairs + HOST_GROUP_PAIRS
                             * ngroups < PAIRING_BATCH_THRESHOLD):
        return "host"
    return "device"


def multi_pairings_routed(groups, device="cuda") -> list:
    """[prod e(P_i, Q_i) over each list of BLS12-381 host pairs] as host
    Fp12 values, by `pairing_route`: through `TPairing.multi_pairings` on
    `device` (CUDA unless the caller names the CPU; raises without a
    card), or the host `multi_pairing` of each list."""
    from . import bls12_381
    dev = resolve_device(device)
    groups = [list(g) for g in groups]
    if pairing_route(sum(map(len, groups)), len(groups)) == "host":
        return [bls12_381.multi_pairing(g) for g in groups]
    return tpairing_for("bls12_381", dev).multi_pairings(groups)
