"""Radix-2 NTT / iNTT over Fr on the device (and the coset variants).

Counterpart of `crypto_tpu/ops/ntt.py`: the evaluation domain behind the
LegoGroth16 QAP witness map (3 iNTTs, 3 coset NTTs, pointwise work and a
coset iNTT) and polynomial multiplication.

Decimation in time over the port's limb-major layout `(L, ..., n)`
(the reference's is `(..., n, L)`): one bit-reversal gather on the last
axis, then log2(n) stages, each a reshape of the last axis to
`(n/m, m)`, one `TField.mul` of the odd halves by the stage's twiddles
(the mont_mul kernel on the card) and `TField.add` / `TField.sub`.  No
kernel of its own: a fused butterfly is later work.

A stage's twiddles w_m^j (w_m = w^(n/m), j < m/2) are w^(j n/m), so
every stage's table is a strided slice of the last stage's: one table of
n/2 powers a direction is packed per domain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..fields.host import Field
from ..fields.tfield import TField, tfield_for


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _powers(g: int, n: int, p: int) -> list:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * g % p
    return out


class NTTDomain:
    """Evaluation domain of size n = 2^k over the field F on a device
    (host metadata and the twiddle tables on the device)."""

    def __init__(self, F: Field, n: int, device="cuda"):
        if n < 1 or n & (n - 1):
            raise ValueError("domain size must be a power of two")
        k = n.bit_length() - 1
        if k > F.two_adicity:
            raise ValueError("field lacks the required two-adicity")
        self.F = F
        self.T: TField = tfield_for(F, device)
        self.device = self.T.device
        self.n = n
        self.k = k
        p = F.p
        self.w = pow(F.generator, (p - 1) // n, p)     # primitive n-th root
        self.w_inv = pow(self.w, -1, p)
        self.n_inv = pow(n, -1, p)
        self._perm = torch.from_numpy(_bit_reverse_perm(n)).to(self.device)
        self._tw_fwd = self._twiddle_tables(self.w)
        self._tw_inv = self._twiddle_tables(self.w_inv)
        self._n_inv_mont = self.T.pack(self.n_inv)       # (L,)

    def _twiddle_tables(self, w: int) -> list:
        """Stage s (m = 2^s) gets w_m^j for j < m/2, w_m = w^(n/m): the
        columns j n/m of the last stage's (L, n/2) table."""
        last = self.T.pack(_powers(w, max(self.n // 2, 1), self.F.p))
        return [last[:, ::self.n >> s].contiguous()
                for s in range(1, self.k + 1)]

    def _bcast(self, t: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """(L, m) table viewed to broadcast over the last axis of a."""
        return t.view((self.T.L,) + (1,) * (a.dim() - 2) + (t.shape[-1],))

    def _ntt_impl(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        """a: (L, ..., n) Montgomery limbs -> the same shape, transformed."""
        T = self.T
        n, L = self.n, T.L
        lead = tuple(a.shape[1:-1])
        a = a.index_select(-1, self._perm)
        tables = self._tw_inv if inverse else self._tw_fwd
        for s in range(1, self.k + 1):
            m = 1 << s
            half = m // 2
            a = a.reshape((L,) + lead + (n // m, m))
            even, odd = a[..., :half], a[..., half:]
            t = T.mul(odd, self._bcast(tables[s - 1], odd))
            a = torch.cat([T.add(even, t), T.sub(even, t)], dim=-1)
        a = a.reshape((L,) + lead + (n,))
        if inverse:
            a = T.mul(a, T._col(self._n_inv_mont, a.dim()))
        return a

    # -- public API --

    def ntt(self, a: torch.Tensor) -> torch.Tensor:
        return self._ntt_impl(a, inverse=False)

    def intt(self, a: torch.Tensor) -> torch.Tensor:
        return self._ntt_impl(a, inverse=True)

    def coset_scale_tables(self, g: int):
        """(L, n) powers of g and of g^-1, for the coset (i)NTT."""
        p = self.F.p
        return (self.T.pack(_powers(g, self.n, p)),
                self.T.pack(_powers(pow(g, -1, p), self.n, p)))

    @functools.cached_property
    def _coset_tables(self):
        """Default coset: the field's multiplicative generator (arkworks
        `get_coset` in the QAP reduction)."""
        return self.coset_scale_tables(self.F.generator)

    def coset_ntt(self, a: torch.Tensor) -> torch.Tensor:
        pw, _ = self._coset_tables
        return self.ntt(self.T.mul(a, self._bcast(pw, a)))

    def coset_intt(self, a: torch.Tensor) -> torch.Tensor:
        _, pwi = self._coset_tables
        out = self.intt(a)
        return self.T.mul(out, self._bcast(pwi, out))

    # -- host bridges --

    def ntt_ints(self, values: list, inverse: bool = False,
                 coset: bool = False) -> list:
        a = self.T.pack([v % self.F.p for v in values])
        if coset:
            out = self.coset_intt(a) if inverse else self.coset_ntt(a)
        else:
            out = self.intt(a) if inverse else self.ntt(a)
        return [int(v) for v in np.atleast_1d(self.T.unpack(out))]

    def z_on_coset(self) -> int:
        """Z_H(g) = g^n - 1 on the default coset (constant across it): the
        vanishing polynomial's divisor in the QAP reduction."""
        p = self.F.p
        return (pow(self.F.generator, self.n, p) - 1) % p


@functools.lru_cache(maxsize=16)
def _domain(F: Field, n: int, device: str) -> NTTDomain:
    return NTTDomain(F, n, device)


def domain_for(F: Field, n: int, device="cuda") -> NTTDomain:
    """The cached domain of size n over F on `device` (CUDA unless the
    caller names the CPU; raises without a card)."""
    return _domain(F, n, str(resolve_device(device)))


def poly_mul_ntt(F: Field, a: list, b: list, device="cuda") -> list:
    """Polynomial product by NTT on the device; coefficients as ints."""
    out_len = len(a) + len(b) - 1
    n = 1 << (out_len - 1).bit_length()
    if n > (1 << F.two_adicity):
        raise ValueError("polynomial too large for field two-adicity")
    dom = domain_for(F, n, device)
    T = dom.T
    fa = dom.ntt(T.pack(list(a) + [0] * (n - len(a))))
    fb = dom.ntt(T.pack(list(b) + [0] * (n - len(b))))
    prod = dom.intt(T.mul(fa, fb))
    return [int(v) for v in np.atleast_1d(T.unpack(prod))][:out_len]
