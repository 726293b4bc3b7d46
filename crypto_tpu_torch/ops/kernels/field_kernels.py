"""Batched field kernels: Montgomery multiplication, the fixed-exponent
power, the Fq2 Karatsuba mul and square and the row gather; each with
its CUDA kernel, its wrapper and its plain PyTorch version.

`mont_mul` replaces `crypto_tpu/ops/pallas/field_kernels.py`
`mont_mul_t_fn` (the TPU kernel behind every device field mul,
`_mont_mul_body`).  Same function, a·b·R^-1 mod p over `(L, M)`
limb-major batches, in the port's
representation: L 32-bit limbs (12 for BLS12-381 Fq, 8 for its Fr and
for BN254's Fq and Fr) held
in int32 tensors as uint32 bit patterns, R = 2^(32L).  The TPU kernel's
MXU one-hot columns, Toeplitz REDC and Kogge-Stone row carries are TPU
artefacts and are not carried over.

On the H100 (`csrc/mont_mul.cu`): one thread per element, CIOS Montgomery
over the L limbs in registers, each row's carries on PTX carry chains
(`mad.lo.cc` / `madc.hi.cc`), the modulus passed by value (it lands in
the constant bank).  For L = 12 a mul moves 144 bytes and does 2L^2 + L =
300 32x32->64-bit products (600 32-bit multiply-adds), so at the card's
published rates it sits close to the line between the two bounds, on
the bytes side; the design keeps every intermediate in registers so the
bytes are only the operands and the result.

The plain version computes the same CIOS result `(a·b + m·p)/R`, less p
once if that is >= p, for any operands below R, so kernel and plain agree
bit for bit (canonical operands give the canonical product).  It works in
16-bit half-limbs held in int64 so no intermediate reaches 2^63.

`mont_pow` computes a^e for a fixed 1 <= e < 2^384 (0^e = 0): the
reference's `JField.pow_fixed` / `JField.inv`, a `lax.scan` of
square-and-multiply steps over its mont_mul.  On the H100 the whole
chain runs in one launch (`csrc/mont_mul.cu`, one thread per element),
so `TField.inv`'s Fermat root is one launch instead of 608; its plain
version is the same square-and-multiply over `mont_mul_plain`.  At the
MSM's roots (1 to 16 elements) it is bound by the latency of one
thread's chain of dependent products; at width by the multiply rate (96
bytes against the 460 x 300 wide products of a sliding-window chain for
p - 2; the binary chain it runs takes 608 products).

`fq2_mul` replaces `crypto_tpu/ops/pallas/curve_kernels.py` `fq2_mul_t_fn`
(`Fq2Ctx.mul`, beta = -1): (2L, M) x (2L, M) -> (2L, M), c0's limbs in
rows [:L] and c1's in [L:] (`csrc/fq2_mul.cu`, over BLS12-381 Fq, L = 12,
and BN254 Fq, L = 8, as the reference's `fq2_mul_t_fn(base.L, ...)`).  The
kernel is Karatsuba with lazy reduction: three unreduced L x L-limb
products v0 = a0·b0, v1 = a1·b1, t = (a0+a1)(b0+b1), then c0 =
REDC(v0 + p² − v1) and c1 = REDC(t − v0 − v1), 744 wide products against
288 bytes at L = 12 (336 against 192 at L = 8), on the operations side of
the card's balance point.  Its contract: for canonical inputs (below p)
it returns the canonical product, so it equals the plain version, which
stays the reference's three Montgomery products, bit for bit; every path
feeds canonical inputs.  `fq2_sqr` is the reference's complex squaring (`Fq2Ctx.square`,
`JQuadField.square`): c0 = (a0+a1)(a0-a1), c1 = 2·a0·a1, two base
products, in the same source; the kernel computes the same bits as
`fq2_mul`'s Karatsuba with b = a, on three wide squares and two
reductions (546 wide products against 192 bytes).

`gather_rows_t` replaces `crypto_tpu/ops/pallas/field_kernels.py`
`gather_rows_t_fn`, the row gather that lays out the MSM's bucket slots,
with its contract: (payload (N, C) int32, point-major, idx (M,) int64) ->
(C, M) limb-major, row idx[j] of the payload in column j, a zero column
where idx[j] is outside [0, N), on both sides (`csrc/gather.cu`).  It is
bound by bytes: one thread a slot reads the slot's row as 16-byte
vectors (C = 12 or 24 over BLS12-381, 8 or 16 over BN254) and writes its
column, coalesced across the warp.
`slot_tables` builds its two payloads of an MSM from the limb-major
coordinates, once per MSM: x's rows, and y's rows over -y's (the same
source; the plain version is a transpose and `F.neg`).
"""

from __future__ import annotations

import ctypes

import numpy as np
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


def mont_pow_plain(a: torch.Tensor, e: int, mod: Modulus) -> torch.Tensor:
    """Plain PyTorch a^e of an (L, M) batch (any device), e >= 1: square
    and multiply over e's bits below the top one, left to right, on
    `mont_mul_plain`.  On CPU tensors the same chain runs on the host's
    integers (`mont_pow_ints`), whose product is exactly
    `mont_mul_plain`'s: a chain of 608 tensor products a lane costs ~2 s
    there, ~1 ms on integers.  On CUDA tensors the chain stays in
    PyTorch's tensor products: that is the plain PyTorch version the
    card's checks hold the `mont_pow` kernel to, where the integers are a
    host model of it (`test_mont_pow_ints_is_the_tensor_chain` holds the
    two to each other)."""
    if a.device.type == "cpu":
        return mont_pow_ints(a, e, mod)
    acc = a.clone()
    for bit in bin(e)[3:]:
        acc = mont_mul_plain(acc, acc, mod)
        if bit == "1":
            acc = mont_mul_plain(acc, a, mod)
    return acc


def mont_pow_ints(a: torch.Tensor, e: int, mod: Modulus) -> torch.Tensor:
    """`mont_pow_plain`'s square-and-multiply chain over the host's
    integers, lane by lane, for an (L, M) CPU batch.  Each product is
    `mont_mul_plain`'s for any operands below R = 2^(32L): its half-limb
    REDC adds m p with m = -t p^-1 mod R, so r = (t + m p) / R < R + p,
    less p once if r >= p."""
    L, p = mod.L, mod.p
    R = 1 << (32 * L)
    nq = (-pow(p, -1, R)) % R
    cols = a.numpy().view(np.uint32).T.astype("<u4")
    bits = bin(e)[3:]
    out = []
    for col in cols:
        x = acc = int.from_bytes(col.tobytes(), "little")
        for bit in bits:
            t = acc * acc
            acc = (t + (t * nq % R) * p) >> (32 * L)
            if acc >= p:
                acc -= p
            if bit == "1":
                t = acc * x
                acc = (t + (t * nq % R) * p) >> (32 * L)
                if acc >= p:
                    acc -= p
        out.append(acc.to_bytes(4 * L, "little"))
    flat = np.frombuffer(b"".join(out), dtype="<u4").reshape(len(out), L)
    return torch.from_numpy(flat.T.copy().view(np.int32)).reshape(a.shape)


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


POW_WORDS = 12     # the exponent words mont_pow passes (ctt::EXP_WORDS)


def mont_pow(a: torch.Tensor, e: int, mod: Modulus) -> torch.Tensor:
    """a^e over an (L, M) batch for a fixed 1 <= e < 2^384, 0^e = 0.  CUDA
    tensors launch `csrc/mont_mul.cu`'s power kernel (the whole
    square-and-multiply chain in one launch); CPU tensors take
    `mont_pow_plain`."""
    M = check_limbs("mont_pow", mod.L, a)
    if not 0 < e < 1 << (32 * POW_WORDS):
        raise ValueError(f"mont_pow: the exponent must lie in [1, "
                         f"2^{32 * POW_WORDS}), got {e}")
    if not on_card("mont_pow", a.device):
        return mont_pow_plain(a, e, mod)
    out = torch.empty_like(a)
    if M == 0:
        return out
    lib = load_library()
    e_c = (ctypes.c_uint32 * POW_WORDS)(*limbs32(e, POW_WORDS))
    check(lib.crypto_mont_pow(a.data_ptr(), out.data_ptr(), M, mod.L,
                              ctypes.addressof(mod.p_c), mod.n0inv,
                              ctypes.addressof(e_c), stream_of(a.device)),
          "mont_pow")
    mont_pow.launches += 1
    return out


KERNEL_LIMBS = (8, 12)     # the limb counts the level, Fq2 and table
                           # kernels are built for: BN254 Fq, BLS12-381 Fq


def check_kernel_field(name: str, mod: Modulus) -> None:
    """The level, Fq2 and table kernels take a base field of 8 or 12 limbs
    whose p leaves 2 spare bits, 4p < R = 2^(32L): the bound their lazy
    reductions and even/odd products were proved under (BN254 Fq and
    BLS12-381 Fq; not BLS12-381 Fr, whose r > R/4)."""
    if mod.L not in KERNEL_LIMBS or 4 * mod.p >= 1 << (32 * mod.L):
        raise ValueError(f"{name}: the kernel takes a base field of "
                         f"{KERNEL_LIMBS} limbs with 4p < 2^(32L), got "
                         f"{mod.L} limbs and a {mod.p.bit_length()}-bit p")


def fq2_mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Karatsuba product of (2L, M) Fq2 batches over the base
    field context F (any device): c0 = v0 - v1, c1 = (a0+a1)(b0+b1) - v0
    - v1, with v0 = a0·b0 and v1 = a1·b1."""
    L = F.L
    a0, a1, b0, b1 = a[:L], a[L:], b[:L], b[L:]
    s = F.add(torch.cat([a0, b0], 1), torch.cat([a1, b1], 1))
    M = a.shape[1]
    # the three products side by side in one call (columns are independent)
    v0, v1, t = mont_mul_plain(torch.cat([a0, a1, s[:, :M]], 1),
                               torch.cat([b0, b1, s[:, M:]], 1),
                               F.mod).split(M, 1)
    return torch.cat([F.sub(v0, v1), F.sub(F.sub(t, v0), v1)])


def fq2_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq2 product of (2L, M) batches over the base field context F.  CUDA
    tensors launch `csrc/fq2_mul.cu`; CPU tensors take `fq2_mul_plain`."""
    check_kernel_field("fq2_mul", F.mod)
    M = check_limbs("fq2_mul", 2 * F.L, a, b)
    if not on_card("fq2_mul", a.device):
        return fq2_mul_plain(F, a, b)
    out = torch.empty_like(a)
    if M == 0:
        return out
    lib = load_library()
    check(lib.crypto_fq2_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), M,
                             F.L, ctypes.addressof(F.mod.p_c), F.mod.n0inv,
                             stream_of(a.device)), "fq2_mul")
    fq2_mul.launches += 1
    return out


def fq2_sqr_plain(F, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch complex square of a (2L, M) Fq2 batch over the base
    field context F (any device): c0 = (a0+a1)(a0-a1), c1 = 2·a0·a1."""
    L = F.L
    a0, a1 = a[:L], a[L:]
    M = a.shape[1]
    t0, t1 = mont_mul_plain(torch.cat([a0, F.add(a0, a1)], 1),
                            torch.cat([a1, F.sub(a0, a1)], 1),
                            F.mod).split(M, 1)
    return torch.cat([t1, F.add(t0, t0)])


def fq2_sqr(F, a: torch.Tensor) -> torch.Tensor:
    """Fq2 square of a (2L, M) batch over the base field context F.  CUDA
    tensors launch `csrc/fq2_mul.cu`'s square; CPU tensors take
    `fq2_sqr_plain`."""
    check_kernel_field("fq2_sqr", F.mod)
    M = check_limbs("fq2_sqr", 2 * F.L, a)
    if not on_card("fq2_sqr", a.device):
        return fq2_sqr_plain(F, a)
    out = torch.empty_like(a)
    if M == 0:
        return out
    lib = load_library()
    check(lib.crypto_fq2_sqr(a.data_ptr(), out.data_ptr(), M, F.L,
                             ctypes.addressof(F.mod.p_c), F.mod.n0inv,
                             stream_of(a.device)), "fq2_sqr")
    fq2_sqr.launches += 1
    return out


GATHER_ROWS = (8, 12, 16, 24)      # an Fq or Fq2 coordinate of either curve


def gather_rows_t_plain(payload: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row gather with transposed output (any device):
    payload[idx].T, with a zero column where idx is outside [0, N)."""
    live = (idx >= 0) & (idx < payload.shape[0])
    out = payload.index_select(0, torch.where(live, idx, 0)).t()
    return torch.where(live, out, 0).contiguous()


def gather_rows_t(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C) int32 point-major payload x (M,) int64 indices -> (C, M)
    int32: row idx[j] of the payload in column j, zero where idx[j] is
    outside [0, N) (the MSM marks an empty slot with -1).  CUDA tensors
    launch `csrc/gather.cu`, for rows of 12 or 24 words (a BLS12-381 Fq
    or Fq2 coordinate) or 8 or 16 (BN254's); CPU tensors take
    `gather_rows_t_plain`."""
    if payload.dtype != torch.int32 or payload.dim() != 2 \
            or not payload.is_contiguous():
        raise ValueError(f"gather_rows_t: expected a contiguous int32 (N, C) "
                         f"payload, got {tuple(payload.shape)} "
                         f"{payload.dtype}")
    if idx.dtype != torch.int64 or idx.dim() != 1 \
            or not idx.is_contiguous() or idx.device != payload.device:
        raise ValueError(f"gather_rows_t: expected a contiguous int64 (M,) "
                         f"index on {payload.device}, got "
                         f"{tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if not on_card("gather_rows_t", payload.device):
        return gather_rows_t_plain(payload, idx)
    N, C = payload.shape
    if C not in GATHER_ROWS or payload.data_ptr() % 16:
        raise ValueError(f"gather_rows_t: the kernel takes rows of 8 or 16 "
                         f"(BN254) or 12 or 24 (BLS12-381) words on a "
                         f"16-byte boundary, got {C} words at "
                         f"{payload.data_ptr():#x}")
    M = idx.shape[0]
    out = torch.empty((C, M), dtype=torch.int32, device=payload.device)
    if C * M == 0:
        return out
    lib = load_library()
    check(lib.crypto_gather_rows_t(payload.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), N, C, M,
                                   stream_of(payload.device)),
          "gather_rows_t")
    gather_rows_t.launches += 1
    return out


def slot_tables_plain(F, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """Plain PyTorch slot tables (any device): x.T, and y.T over
    F.neg(y).T, both contiguous."""
    return x.t().contiguous(), torch.cat([y.t(), F.neg(y).t()])


def slot_tables(F, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """The row gather's payloads of an MSM from its (U, N) limb-major
    coordinates over the field context F (Fq, U = L, or Fq2 over it, U =
    2L; L = 12 or 8): (xtab (N, U), ytab (2N, U)), x's rows, and y's rows
    then -y's, so
    row src + N*neg of ytab is the slot's signed y.  CUDA tensors launch
    `csrc/gather.cu`'s table kernel; CPU tensors take
    `slot_tables_plain`."""
    M = check_limbs("slot_tables", F.U, x, y)
    if not on_card("slot_tables", x.device):
        return slot_tables_plain(F, x, y)
    check_kernel_field("slot_tables", F.mod)
    xtab = torch.empty((M, F.U), dtype=torch.int32, device=x.device)
    ytab = torch.empty((2 * M, F.U), dtype=torch.int32, device=x.device)
    if M == 0:
        return xtab, ytab
    lib = load_library()
    check(lib.crypto_slot_tables(x.data_ptr(), y.data_ptr(), xtab.data_ptr(),
                                 ytab.data_ptr(), F.U, M, F.mod.L,
                                 ctypes.addressof(F.mod.p_c), F.mod.n0inv,
                                 stream_of(x.device)), "slot_tables")
    slot_tables.launches += 1
    return xtab, ytab


mont_mul.launches = 0
mont_pow.launches = 0
fq2_mul.launches = 0
fq2_sqr.launches = 0
gather_rows_t.launches = 0
slot_tables.launches = 0
