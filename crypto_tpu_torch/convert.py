"""Carry field elements between the JAX package's arrays and the port's
tensors.

The JAX package packs an element as `(..., L_jax)` int32 with 15-bit
limbs, least significant first, in Montgomery form with R_jax =
2^(15*L_jax) (L_jax = 26 for BLS12-381 Fq, 17 for Fr).  The port packs it
as `(L, ...)` int32 with 32-bit limbs (uint32 bit patterns), R = 2^(32L).
Conversion goes through plain Python ints: unpack, multiply by
R_jax^-1 * R mod p, repack.  The limb widths and radices are constants
here, so nothing of the JAX package is needed.  An Fq2 element is
`(..., 2, L_jax)` in the JAX package and `(2L, ...)` in the port
(`jax_to_port_fq2`, `port_to_jax_fq2`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

JAX_LIMB_BITS = 15


def jax_limbs(p: int) -> int:
    return -(-p.bit_length() // JAX_LIMB_BITS)


def port_limbs(p: int) -> int:
    return -(-p.bit_length() // 32)


def _factor(p: int, to_port: bool, mont: bool) -> int:
    if not mont:
        return 1
    r_jax = 1 << (JAX_LIMB_BITS * jax_limbs(p))
    r_port = 1 << (32 * port_limbs(p))
    f = pow(r_jax, -1, p) * r_port % p
    return f if to_port else pow(f, -1, p)


def jax_to_port(arr, p: int, mont: bool = True,
                device="cuda") -> torch.Tensor:
    """(..., L_jax) 15-bit-limb array -> (L, ...) int32 tensor on `device`
    (CUDA unless the caller names the CPU)."""
    device = resolve_device(device)
    a = np.asarray(arr).astype(np.int64)
    Lj, L = a.shape[-1], port_limbs(p)
    shape = a.shape[:-1]
    rows = a.reshape(-1, Lj)
    f = _factor(p, True, mont)
    buf = bytearray()
    for row in rows:
        v = 0
        for limb in row[::-1]:
            v = (v << JAX_LIMB_BITS) | int(limb)
        buf += (v * f % p).to_bytes(4 * L, "little")
    out = np.frombuffer(bytes(buf), dtype="<u4").reshape(-1, L)
    t = torch.from_numpy(out.view(np.int32).T.copy())
    return t.reshape((L,) + shape).to(device)


def port_to_jax(t: torch.Tensor, p: int, mont: bool = True) -> np.ndarray:
    """(L, ...) int32 tensor -> (..., L_jax) 15-bit-limb int32 array."""
    a = t.detach().to("cpu").numpy()
    L, Lj = a.shape[0], jax_limbs(p)
    shape = a.shape[1:]
    rows = np.ascontiguousarray(a.reshape(L, -1).T).view("<u4")
    f = _factor(p, False, mont)
    out = np.zeros((rows.shape[0], Lj), dtype=np.int32)
    mask = (1 << JAX_LIMB_BITS) - 1
    for i, row in enumerate(rows):
        v = int.from_bytes(row.tobytes(), "little") * f % p
        for j in range(Lj):
            out[i, j] = v & mask
            v >>= JAX_LIMB_BITS
    return out.reshape(shape + (Lj,))


def jax_to_port_fq2(arr, p: int, mont: bool = True,
                    device="cuda") -> torch.Tensor:
    """Fq2 over the base prime p: (..., 2, L_jax) array (the JAX package's
    `JQuadField` layout) -> (2L, ...) tensor on `device`, c0's limbs in
    rows [:L] and c1's in [L:] (`fields/ttower.py`)."""
    a = np.asarray(arr)
    return torch.cat([jax_to_port(a[..., k, :], p, mont, device)
                      for k in (0, 1)])


def port_to_jax_fq2(t: torch.Tensor, p: int, mont: bool = True) -> np.ndarray:
    """(2L, ...) Fq2 tensor -> (..., 2, L_jax) array."""
    L = port_limbs(p)
    return np.stack([port_to_jax(t[:L], p, mont), port_to_jax(t[L:], p, mont)],
                    axis=-2)
