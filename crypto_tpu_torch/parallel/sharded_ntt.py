"""Sharded NTT over `torch.distributed`: the four-step (Bailey)
decomposition.

Counterpart of `crypto_tpu/parallel/sharded_ntt.py`.  The N inputs are
sharded contiguously over D ranks: rank n1 holds x[n1 N2 + n2], n2 < N2 =
N / D, row n1 of the (D, N2) matrix view.  With W a primitive N-th root:

    X[k1 + D k2] = NTT_{N2, n2 -> k2}(W^(k1 n2) C[k1, n2])
    C[k1, n2]    = sum_{n1} x[n1, n2] W_D^(k1 n1)          (across ranks)

One all-gather of the (D, N2) blocks gives every rank the column DFT's
inputs; rank k1 then computes C[k1, :], its twiddles and a local NTT of
size N2 over the port's `ops/ntt.py` (the mont_mul kernel on the card),
and holds the strided outputs X[k1 + D k2].  `rank_step` is that step as a
function of (gathered blocks, rank), so D ranks can run in turn on one
card; `sharded_ntt_t` gathers the outputs once more and returns them in
natural order, as the reference's `sharded_ntt` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..fields.host import Field
from ..fields.tfield import tfield_for
from ..ops.ntt import NTTDomain, _powers, domain_for


class NTTPlan:
    """The constants of an (n, d) sharded NTT on a device: the local
    domain of size n / d, the (L, d, d) powers W_D^(k1 n1) and the (L, d,
    n / d) twiddles W^(k1 n2), Montgomery form."""

    def __init__(self, F: Field, n: int, d: int, device="cuda"):
        if d < 1 or n % d:
            raise ValueError(f"{d} ranks do not divide a domain of {n}")
        dom = domain_for(F, n, device)
        self.n, self.d, self.n2 = n, d, n // d
        self.local: NTTDomain = domain_for(F, self.n2, device)
        self.T = dom.T
        p, w = F.p, dom.w
        w_d = pow(w, self.n2, p)                      # primitive d-th root
        self.wd = self.T.pack([[pow(w_d, k1 * n1 % d, p) for n1 in range(d)]
                               for k1 in range(d)])
        self.tw = self.T.pack([_powers(pow(w, k1, p), self.n2, p)
                               for k1 in range(d)])


@functools.lru_cache(maxsize=8)
def _plan(F: Field, n: int, d: int, device: str) -> NTTPlan:
    return NTTPlan(F, n, d, device)


def plan_for(F: Field, n: int, d: int, device="cuda") -> NTTPlan:
    """The cached plan of an (n, d) sharded NTT on `device`."""
    return _plan(F, n, d, str(resolve_device(device)))


def rank_step(plan: NTTPlan, gathered: torch.Tensor, k1: int) -> torch.Tensor:
    """Rank k1's step: the (L, d, n2) gathered row blocks -> its (L, n2)
    outputs X[k1 + d k2], k2 < n2, Montgomery form."""
    T = plan.T
    terms = T.mul(gathered, plan.wd[:, k1, :, None])    # (L, d, n2)
    acc = terms[:, 0]
    for i in range(1, plan.d):
        acc = T.add(acc, terms[:, i])
    return plan.local.ntt(T.mul(acc, plan.tw[:, k1]))


def natural_order(outs: torch.Tensor) -> torch.Tensor:
    """(d, L, n2) stacked rank outputs (rank k1's X[k1 + d k2]) -> (L, n)
    in natural order."""
    d, L, n2 = outs.shape
    return outs.permute(1, 2, 0).reshape(L, n2 * d)


def sharded_ntt_t(F: Field, block: torch.Tensor, group=None,
                  device="cuda") -> torch.Tensor:
    """This rank's (L, n / world) Montgomery block of inputs (rank r holds
    x[r n / world : (r + 1) n / world]) -> the (L, n) NTT in natural order,
    on every rank of `group`: two all-gathers (the blocks, the outputs)."""
    dev = resolve_device(device)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    block = block.to(dev).contiguous()
    L, n2 = block.shape
    plan = plan_for(F, n2 * d, d, dev)
    every = torch.empty((d * L, n2), dtype=block.dtype, device=dev)
    dist.all_gather_into_tensor(every, block, group=group)
    mine = rank_step(plan, every.view(d, L, n2).permute(1, 0, 2), r)
    outs = torch.empty_like(every)
    dist.all_gather_into_tensor(outs, mine.contiguous(), group=group)
    return natural_order(outs.view(d, L, n2))


def sharded_ntt(F: Field, values: list, group=None, device="cuda") -> list:
    """`values`: this rank's n / world consecutive inputs as ints; returns
    the whole NTT output as ints in natural order (the reference's
    `sharded_ntt`), on every rank of `group`."""
    dev = resolve_device(device)
    T = tfield_for(F, dev)
    out = sharded_ntt_t(F, T.pack([v % F.p for v in values]), group, dev)
    return [int(v) for v in np.atleast_1d(T.unpack(out))]
