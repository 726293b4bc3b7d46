"""Batched Montgomery multiplication: the CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces `crypto_tpu/ops/pallas/field_kernels.py` `mont_mul_t_fn` (the
TPU kernel behind every device field mul, `_mont_mul_body`).  Same
function, a·b·R^-1 mod p over `(L, M)` limb-major batches, in the port's
representation: L 32-bit limbs (L = 12 for BLS12-381 Fq, 8 for Fr) held
in int32 tensors as uint32 bit patterns, R = 2^(32L).  The TPU kernel's
MXU one-hot columns, Toeplitz REDC and Kogge-Stone row carries are TPU
artefacts and are not carried over.

On the H100 (`csrc/mont_mul.cu`): one thread per element, CIOS Montgomery
over the L limbs in registers, the modulus passed by value (it lands in
the constant bank).  For L = 12 a mul moves 144 bytes and does 2L^2 + L =
300 32x32->64-bit products (600 32-bit multiply-adds), so at the card's
published rates it sits close to the line between the two bounds; the
design keeps every intermediate in registers so the bytes are only the
operands and the result.

The plain version computes the same CIOS result `(a·b + m·p)/R`, less p
once if that is >= p, for any operands below R, so kernel and plain agree
bit for bit (canonical operands give the canonical product).  It works in
16-bit half-limbs held in int64 so no intermediate reaches 2^63.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load_library

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF


def limbs32(v: int, L: int) -> list:
    """Python int -> L 32-bit limbs, least significant first."""
    out = []
    for _ in range(L):
        out.append(v & MASK32)
        v >>= 32
    if v:
        raise ValueError("value does not fit in the limbs")
    return out


def u32(a: torch.Tensor) -> torch.Tensor:
    """int32 limbs (uint32 bit patterns) -> their unsigned values in int64."""
    return a.to(torch.int64) & MASK32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


class Modulus:
    """A prime modulus as the kernels take it: its 32-bit limbs for the C
    entry points (with those of p - 2, the Fermat exponent, and of the
    Montgomery 1), -p^-1 mod 2^32, and per-device half-limb tensors for
    the plain version."""

    def __init__(self, p: int, L: int):
        self.p = p
        self.L = L
        self.n0inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.n0inv16 = self.n0inv & MASK16
        self.p_c = (ctypes.c_uint32 * L)(*limbs32(p, L))
        self.pm2_c = (ctypes.c_uint32 * L)(*limbs32(p - 2, L))
        self.one_c = (ctypes.c_uint32 * L)(*limbs32((1 << (32 * L)) % p, L))
        self._halves = {}

    def halves(self, device) -> torch.Tensor:
        """(2L + 1, 1) int64 16-bit half-limbs of p (top row 0)."""
        key = str(device)
        if key not in self._halves:
            hv = [(self.p >> (16 * i)) & MASK16 for i in range(2 * self.L + 1)]
            self._halves[key] = torch.tensor(hv, dtype=torch.int64,
                                             device=device).reshape(-1, 1)
        return self._halves[key]


def _halves(a: torch.Tensor) -> torch.Tensor:
    """(L, M) int32 limbs -> (2L, M) int64 16-bit half-limbs."""
    u = u32(a)
    return torch.stack([u & MASK16, u >> 16], dim=1).reshape(2 * u.shape[0],
                                                             u.shape[1])


def _join(h: torch.Tensor) -> torch.Tensor:
    """(2L, M) int64 half-limbs -> (L, M) int32 limbs."""
    return to_i32(h[0::2] + (h[1::2] << 16))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, mod: Modulus):
    """Plain PyTorch Montgomery product of (L, M) batches (any device)."""
    n = 2 * mod.L
    ah, bh = _halves(a), _halves(b)
    M = ah.shape[1]
    t = torch.zeros((2 * n + 1, M), dtype=torch.int64, device=a.device)
    for i in range(n):                         # columns < 2n * 2^32
        t[i:i + n] += ah[i] * bh
    p16 = mod.halves(a.device)
    for i in range(n):                         # REDC, one half-limb a step
        m = ((t[i] & MASK16) * mod.n0inv16) & MASK16
        t[i:i + n] += m * p16[:n]
        t[i + 1] += t[i] >> 16
    r = t[n:]
    for i in range(n):
        r[i + 1] += r[i] >> 16
        r[i] &= MASK16
    d = torch.empty_like(r)
    borrow = torch.zeros(M, dtype=torch.int64, device=a.device)
    for i in range(n + 1):
        v = r[i] - p16[i] - borrow
        borrow = (v < 0).to(torch.int64)
        d[i] = v & MASK16
    out = torch.where(borrow.bool(), r[:n], d[:n])
    return _join(out)


def check_limbs(name: str, L: int, *ts: torch.Tensor) -> int:
    """Shared wrapper checks: int32, contiguous, (L, M), one device.
    Returns M."""
    M = ts[0].shape[-1]
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != (L, M) \
                or not t.is_contiguous() or t.device != ts[0].device:
            raise ValueError(f"{name}: expected contiguous int32 ({L}, {M}) "
                             f"tensors on one device, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return M


def check_masks(name: str, M: int, device, *ms: torch.Tensor) -> None:
    for m in ms:
        if m.dtype != torch.int32 or m.shape != (M,) or m.device != device \
                or not m.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 ({M},) "
                             f"mask on {device}, got {tuple(m.shape)} "
                             f"{m.dtype} on {m.device}")


def on_card(name: str, device) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor (the kernel runs); raises for anything else."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mont_mul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """a·b·R^-1 mod p over (L, M) batches.  CUDA tensors launch
    `csrc/mont_mul.cu`; CPU tensors take `mont_mul_plain`."""
    M = check_limbs("mont_mul", mod.L, a, b)
    if not on_card("mont_mul", a.device):
        return mont_mul_plain(a, b, mod)
    out = torch.empty_like(a)
    if M == 0:
        return out
    lib = load_library()
    check(lib.crypto_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), M,
                              mod.L, ctypes.addressof(mod.p_c), mod.n0inv,
                              stream_of(a.device)), "mont_mul")
    mont_mul.launches += 1
    return out


mont_mul.launches = 0
