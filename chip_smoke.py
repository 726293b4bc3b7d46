#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crypto_tpu_torch/csrc` and drives
the port's paths on the card, each with every launch count set to 0 just
before it and read just after:

* bench points: 2^20 distinct BLS12-381 G1 points with known discrete
  logs, built by the full-add and normalize kernels (`make_bench_points`);
* the 2^20 MSM (c = 16, full-range 255-bit scalars) through
  `msm_device_scheduled` on its default doubling-free levels, one timed
  run after an untimed warm-up, checked against the known discrete
  logs, none rerun, then
  one `safe=True` run on the total-formula levels, checked the same way;
* the rerun path: the same MSM with one base duplicated and the digits set
  so that the pair collides in one window's bucket; the flagged windows
  must be exactly those that share a spoiled chunk, and they are rerun
  through the total-formula kernels;
* the edge MSMs (8 duplicate bases, whose window is rerun through the
  total-formula narrow level; 300 points with one scalar, the grid path);
* the Jacobian add, mixed add and double of `make_add_fns` at 2^20 rows;
* G2 bench points: 2^20 distinct BLS12-381 G2 points with known discrete
  logs, built by the total `TCurve` add and `to_affine` over Fq2;
* the 2^20 G2 MSM (c = 16, full-range scalars), one timed run after a
  warm-up, checked against the known discrete logs, on the reference's Fq2
  configuration: the Fq2 pre/post at every level, the Fq2 mul in the
  inversions and the tail, the Fq2 square in the tail, and no G1 level
  kernel;
* the G2 edge MSMs (duplicate bases, a base and its negation, infinity,
  zero scalars; 300 points with one scalar), checked against the host
  sum with no rerun;
* the QAP witness map's device half, `qap_h`, on a 2^20 domain (random
  rows a, b and c = a b): each NTT timed, intt(ntt(a)) == a, 8 NTT
  outputs against Horner and the QAP identity at a random tau;
* BASELINE config 5's multi-GPU path on the one card: the sharded 2^20
  G1 MSM (`parallel/sharded_msm_v2.py`) on the main MSM's points and
  scalars, `msm_sharded_v2` in a world of one on NCCL (a `HashStore`: no
  address, no network), then 4 shards of 2^18 points computed in turn
  (`msm_shards_in_turn`: each shard's `shard_bucket_sums`, added by
  `combine_bucket_shards`, its first level 2 x 16 x 2^15 bucket pairs on
  the chunked total formula, and the tail), each equal to the known-dlog
  value and the main MSM's result, no window rerun; the four-step NTT of
  2^20 Fr elements
  (`parallel/sharded_ntt.py`) as 4 ranks in turn and in the world of
  one, each equal to the single-device NTT; every kernel launch of these
  paths held to its plain version on its arguments;
* the LegoGroth16 north-star workload (`benches/bench_northstar.py`):
  the setup of a 2^16 - 4 constraint chain circuit with one committed
  witness from explicit trapdoors (fixed-base tables and products on the
  card, normalisation on the card, timed apart), one warm-up and one timed
  proves (witness map and each query MSM timed), each proof checked in
  the exponent against its discrete logs and the verification equation,
  and every device MSM against its known logs;
* the pairing at `benches/bench_pairing.py`'s size: a 64-pair
  multi-pairing (plus one pair with G1 at infinity) through `TPairing`,
  once cold and once timed on fresh pairs from known logs, each
  product against its log; the first set's per-pair Miller values
  against the host Miller loop and its product against the host
  multi-pairing; e(aP, bQ) == e(abP, Q) and e(aP, Q) e(-aP, Q) == 1; a
  lazy `RandomizedPairingChecker` with 64 deferred pairs through the
  device Miller product, valid and with one spoiled pair; the BBS+ batch
  verify of 1,024 signatures over 4 messages (known logs, the pairing on
  the device), its two MSMs against their logs, valid and with one e
  spoiled;
* BASELINE config 2, BBS+ proofs of knowledge over 32 messages (4
  revealed): `batch_verify_proofs` of 256 proofs (252 from the protocol's
  algebra over known logs, 4 through the port's `SignatureG1.new` and
  `PoKOfSignatureG1Protocol`, their sign, prove and host verify timed),
  the pairing on the device, cold (both MSMs against their known logs)
  and warm (host checker, device MSMs and pairing timed apart), and two
  spoiled sets rejected (32 proofs with a response off by one, which the
  mult checker refuses; all 256 with a proof under another key, which
  passes the mult checker, runs both MSMs on the card, counted, and
  fails the pairing); one lazy
  checker on the card with 16 PoKs, 4 signatures and 2 BBS23 PoKs (44
  deferred pairs), valid and with one signature spoiled;
* BASELINE config 4, SAVER at 8-bit chunks (`saver_config4`): a BBS+
  signature over 8 messages, the SAVER CRS and keys, every message
  encrypted with a proof and both ciphertext checks passed, two
  ciphertexts decrypted on the card through the batched multi-pairing
  (each timed and equal to its message), one decryption verified, a
  changed chunk and a wrong message rejected; then SnarkPack on the router's own choice: the 8 SAVER proofs
  aggregated without D and verified with prepared inputs, a changed
  ciphertext and a wrong label rejected (`saver_aggregate_8`), and 8
  bound-check LegoGroth16 proofs aggregated with D, wrong inputs rejected
  (`legogroth16_aggregate_8`); every kernel they launched is held to its
  plain version on the arguments of each launch at a new shape;
* the VB accumulator at `benches/bench_accumulator.py`'s size: params
  hashed from a label, 2^14 elements added, the first 8,192 members'
  witnesses on the device fixed-base path, then two updates of all
  8,192 witnesses through `update_membership_batch_with_sk` on the card
  (256 additions; 256 removals), each split by phase and
  held to V_new / (y + alpha) from the fixed-base table, its d factors
  to host integers, 16 members to the host branch and two by pairing;
* the OT stack and its threshold consumers (`threshold_ot`, host work):
  one base-OT phase of 128 OTs, KOS and DKLS19 batch multiplication of
  256 products over it (the shares sum to the products), threshold
  weak-BB at 3 of 5 (signers 1, 2, 5; A = g1 / (e + x) from the dealt
  key, verified by pairing), and 2-of-3 threshold managers' membership
  witness and removal on that accumulator (each V / (y + alpha));
* the KB universal accumulator (`accumulator_kb_universal`) on the same
  params, keys and 2^14 elements as its domain: 8,192 members, the
  batch witnesses of 8,064 members and 8,064 non-members on the device
  fixed-base path, one `batch_updates` of 128 additions with 128
  removals, and each half's witnesses updated on the card through
  `kb_universal_witness` (the non-member half with the roles swapped),
  each held as the VB updates are and 8 holders a half updated through
  the published `KBUniversalOmega` to the same witnesses;
* PS, BBS23, BBDT16 and the KB statements in one composite
  (`proof_system_more`): config 2's credential under BBS+, under a PS
  signature aggregated from 3 of 5 threshold signers, under BBS23 and a
  BBDT16 MAC (its full verifier), KB membership and non-membership in
  the updated accumulator, CDH and keyed-verification (full verifiers),
  the user id linked across five statements; prove, verify with no
  checker, the lazy checker (10 deferred pairs in one device Miller
  product) and the eager one; a detached membership proof in a spec of
  its own; a spoiled PS signature (by the lazy checker's device Miller
  product), the MAC under another key and the detached proof under
  another accumulator key refused; every kernel launch of the KB and
  composite paths held to its plain version on the same arguments;
* TZ21, the split composite and the IETF suites (`proof_system_split`):
  DKGitH at N = 16, tau = 32 over 4 messages and the filler, prove and
  verify cold (7 fixed-base tables built) and warm, each a batch of
  fixed-base products on the card (mont_mul and mont_pow must launch),
  32 sampled party instances against host products, the auditor's
  decryption, a spoiled delta, opening and hidden ciphertext refused;
  one composite over a prover's and a verifier's spec: config 2's
  credential (BBS+), BBS23 under the IETF statement, VB and KB CDH
  statements on the accumulators above, a G2 Pedersen commitment,
  `VeTZ21` at (16, 32) over 4 hidden messages and `VeTZ21Robust` at 16
  parties, 12 revealed, prove and verify with no, the lazy (8 deferred
  pairs in one device Miller product) and the eager checker; a (2, 1)
  proof under the (16, 32) statement, the prover's spec, a wrong nonce
  and a broken equality refused; both IETF ciphersuites at the draft's
  fixtures, sign, verify, proof_gen and proof_verify over 32 messages;
* the composite proof system (`proof_system_composite`): one `ProofSpec`
  over a BBS+ credential of 32 messages (4 revealed), VB membership
  (CDH) of its user id in the 2^14-element accumulator above, the
  original VB membership statement on the same accumulator, a Pedersen
  commitment to the user id, SAVER encryption of it at 8-bit chunks
  under `saver_config4`'s CRS and keys, and a LegoGroth16 bound check of
  the age in [18, 128) under `legogroth16_aggregate_8`'s key, the user id
  linked across five statements; `Proof.new` timed, `Proof.verify` with
  no checker, with the lazy `RandomizedPairingChecker` (its deferred
  pairs in one device Miller product: mont_mul, fq2_mul and fq2_sqr must
  launch) and with the eager one, each timed; a wrong nonce, a broken
  witness equality, a changed SAVER ciphertext and an out-of-range age
  rejected; the auditor's decryption on the card equal to the user id;
  every kernel it launched held to its plain version on the arguments
  of each launch at a new shape;
* the range statements and the Circom statement
  (`proof_system_ranges`): one `ProofSpec` over a BBS+ credential of 32
  messages (4 revealed), a 64-bit timestamp in 64-bit bounds by the
  Bulletproofs++ bound check (base 2), by the CCS arbitrary range (base
  16, 2 x 16 digits) and by its keyed-verification form, another
  message unequal to a public value, and the 2^16 - 4 constraint chain
  circuit written as Circom's `.r1cs`, read back and proven under the
  LegoGroth16 phase's key, its committed wire a credential message;
  `Proof.new` timed (the Circom prove's witness map and its G1 and G2
  MSMs on the card), `Proof.verify` with no checker (the digits' pairings
  in one routed call), the lazy checker (one device Miller product of 34
  or more pairs) and the eager one, each timed; a wrong nonce, a broken
  witness equality, a spoiled Bulletproofs++ proof, a spoiled digit (by
  the lazy checker's device Miller product) and a timestamp out of range
  refused; every kernel launch of its paths
  held to its plain version on the same arguments;
* BN254 at the reference's sizes, every kernel at its 8-limb
  instantiation: 2^20 G1 bench points with known logs (two full adds
  and a normalize, `make_add_fns` and `make_normalize_fn` at 8 limbs),
  one timed 2^20 MSM at c = 16 on the fast levels, one
  `safe=True`, the rerun path (one duplicated base: exactly the spoiled
  windows rerun) and the G1 and G2 edge MSMs; the LegoGroth16 setup,
  warm-up and one timed prove of the 2^12 - 4 constraint
  chain circuit over BN254 Fr (each checked in the exponent), and the
  port's verifier on a proof (valid, spoiled input and C rejected, D
  opened, both rerandomisations verified); the 64-pair `TPairingBN`
  multi-pairing, once, timed, against e(G1, G2)^(sum a_i b_i) from the
  host pairing; the BN254 paths together must launch every 8-limb
  instantiation, and only the bench points a point kernel.  The
  BLS12-381 prove phase also runs the port's verifier
  (`legogroth16_verify`).

Every MSM builds its two point-major slot tables with the table kernel,
once, and lays out its bucket slots from them through the row gather
kernel.  Then it
holds every kernel against its plain PyTorch version bit for bit at the
shapes a path gave it (both chunked levels also on inputs whose every
warp holds an infinite operand, the full add also on warps that each hold
one kind of pair: P1, P2 or both infinite, P + P, P + (-P); the double
also with Y1 = 0 lanes; the normalize also at ragged widths about its
chunk and block, on infinities only and with infinities at both ends of
every thread's chunk; the Fq2 square also on a0 = a1 and a1 = 0; mont_mul
also at the 2^20 NTT's Fr shapes and the witness update's; the Fq2 mul
and square, mont_mul and mont_pow also at the pairing's narrow widths
(those three also at the PoK batch verify's 2 lanes and the PoK
checker's 44; the fast levels at every width of the PoK batch verify's
MSMs),
mont_pow also at the witness update's to_affine; the one-launch narrow
levels, both formulas, also at 1, 2, 127, 129, 2,048 and 4,095 pairs and
every narrow width of the G1 MSMs; every 8-limb
instantiation at the BN254 paths' shapes, the same way), times the
one-launch narrow levels at 16, 256, 2,048 and 4,095 pairs at 12 and 8
limbs, times the fast down pass at each of
the 2^20 MSM's level widths, and profiles one more 2^20 G1 MSM on the fast
levels for the device's busy share and each kernel's device time
against its summed bound (the bound summed by shims over the same
profiled run, its data-dependent part after the profile closes).  It
fails if a kernel of
a path was not launched on it.  One line per phase, each ending with
its time since the start (`at_s`); before the last line
the card's name and power limit and a JSON object of the kernels'
launches and times; the last line is the result object.  Exits non-zero on any failure, and when
there is no CUDA device.
"""

from __future__ import annotations

import functools
import json
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_LOG = 20
SEED = 20251016
MSM_RUNS = 1                        # timed 2^20 MSMs, fresh scalars each
G2_MSM_RUNS = 1                     # timed 2^20 G2 MSMs, fresh scalars each
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
# 32-bit integer multiply-adds: 64 per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# x 132 SMs x 1.98 GHz boost clock (H100 SXM)
H100_IMAD_PER_S = 132 * 64 * 1.98e9
FQ_LIMBS = 12                       # BLS12-381 Fq; BN254 Fq takes 8
# 32x32 -> 64-bit products, the fewest known for each function on L
# limbs: a Montgomery mul (CIOS) and a Montgomery square (a wide square,
# the cross products once and the squares, and a reduction), an Fq2
# product (three unreduced L x L products and two reductions) and an Fq2
# square (Karatsuba on three wide squares and two reductions).  Every
# square of a function is charged as a square, whatever a kernel runs.


def mul_products(L: int) -> int:
    return 2 * L * L + L


def sqr_products(L: int) -> int:
    return L * (L + 1) // 2 + L * L + L


def fq2_mul_products(L: int) -> int:
    return 3 * L * L + 2 * (L * L + L)


def fq2_sqr_products(L: int) -> int:
    return 3 * (L * (L + 1) // 2) + 2 * (L * L + L)


# CUDA kernel function -> the entry point that launches it
KERNEL_ENTRY = {
    "mont_mul_kernel": "mont_mul", "mont_pow_kernel": "mont_pow",
    "affine_level_kernel": "affine_level",
    "prefix_kernel": "chunked_level_prefix",
    "down_kernel": "chunked_level_down",
    "affine_level_fast_kernel": "affine_level_fast",
    "prefix_fast_kernel": "chunked_level_prefix_fast",
    "down_fast_kernel": "chunked_level_down_fast",
    "full_add_kernel": "jacobian_add", "mixed_add_kernel": "jacobian_add_mixed",
    "double_kernel": "jacobian_double", "normalize_kernel": "jacobian_normalize",
    "fq2_mul_kernel": "fq2_mul", "fq2_sqr_kernel": "fq2_sqr",
    "pre_fq2_kernel": "affine_level_pre_fq2",
    "post_fq2_kernel": "affine_level_post_fq2",
    "gather_rows_t_kernel": "gather_rows_t",
    "slot_tables_kernel": "slot_tables",
}


STARTED = time.monotonic()


def phase(name: str, **kv) -> None:
    """One line `[name] key=value ...`, ending with `at_s`, the seconds
    since the script started."""
    kv["at_s"] = round(time.monotonic() - STARTED, 1)
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, wide_products: float) -> tuple:
    """Least time for the work: bytes over the memory rate, or the 32x32
    -> 64-bit products (two 32-bit multiply-adds each) over the integer
    rate, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * wide_products / H100_IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def chain_ops(e: int) -> tuple:
    """(squares, products) of a short addition chain for x^e: a sliding
    window over e's bits (x^2 and the odd powers below 2^w, then a square
    per bit and a product per window), the fewest steps over widths 1 to
    8.  Width 1 is the binary chain that mont_pow runs (608 steps for p -
    2); the best width takes 460 for p - 2 (width 5, the normalize's
    chain) and 312 for r - 2, so the bound counts the chain the function
    needs, not the one it runs."""
    bits, best = bin(e)[2:], None
    for w in range(1, 9):
        sq, mul = (1, 2 ** (w - 1) - 1) if w > 1 else (0, 0)
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                sq, i = sq + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            if not first:
                sq, mul = sq + j - i, mul + 1
            i, first = j, False
        if best is None or (sq + mul, mul) < (sum(best), best[1]):
            best = (sq, mul)
    return best


def work(name: str, args: tuple) -> tuple:
    """(bytes, 32x32 -> 64-bit products) that one launch of entry point
    `name` on wrapper arguments `args` needs at least: each input read
    once, each output written once; data-dependent work (doublings,
    gathered columns) counted from these inputs."""
    if name in ("mont_mul", "mont_pow"):
        L, M = args[0].shape          # 12 limbs (BLS12-381 Fq) or 8
        if name == "mont_mul":
            return 3 * 4 * L * M, mul_products(L) * M
        sq, mul = chain_ops(args[1])
        return 2 * 4 * L * M, (sq * sqr_products(L)
                               + mul * mul_products(L)) * M
    if name == "gather_rows_t":
        payload, idx = args             # (N, C) rows, (M,) int64
        live = idx[(idx >= 0) & (idx < payload.shape[0])]
        rows = int(torch.unique(live).numel())
        return 4 * payload.shape[1] * (rows + idx.shape[0]) \
            + 8 * idx.shape[0], 0
    if name == "slot_tables":   # (F, x, y (U, N)) -> (N, U), (2N, U) rows
        return 5 * 4 * args[1].numel(), 0
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    CHUNK_K = ck.CHUNK_K
    L = args[0].L                        # args[0] is the field context
    FQ_BYTES, FQ2_BYTES = 4 * L, 8 * L   # an Fq and an Fq2 element
    MUL, SQR = mul_products(L), sqr_products(L)
    FQ2_MUL, FQ2_SQR = fq2_mul_products(L), fq2_sqr_products(L)
    M = args[1].shape[1]
    strips, totals = M - M // CHUNK_K, M // CHUNK_K * FQ_BYTES

    def chain():                  # the Fermat chain of p - 2 (Fq only)
        return chain_ops(args[0].p - 2)

    return {
        "fq2_mul": lambda: (3 * FQ2_BYTES * M, FQ2_MUL * M),
        "fq2_sqr": lambda: (2 * FQ2_BYTES * M, FQ2_SQR * M),
        # Montgomery's trick over the M denominators (a prefix product and
        # the walk back's two a pair) and one Fermat chain, then the add:
        # 2 products and lambda^2 a pair, x1^2 on the doubling lanes
        "affine_level": lambda: (
            M * (6 * FQ_BYTES + 12),
            (3 * (M - 1) + 2 * M + chain()[1]) * MUL
            + (M + chain()[0] + int(ck.affine_level_pre_plain(
                *args)[1].sum())) * SQR),
        "affine_level_fast": lambda: (
            M * (6 * FQ_BYTES + 13),
            (3 * (M - 1) + 2 * M + chain()[1]) * MUL
            + (M + chain()[0]) * SQR),
        "affine_level_pre_fq2": lambda: (M * (5 * FQ2_BYTES + 16), 0),
        "affine_level_post_fq2": lambda: (
            M * (7 * FQ2_BYTES + 12),
            (2 * FQ2_MUL + FQ2_SQR) * M + FQ2_SQR * int(args[6].sum())),
        "chunked_level_prefix": lambda: (M * (5 * FQ_BYTES + 16) + totals,
                                         strips * MUL),
        "chunked_level_down": lambda: (
            M * (7 * FQ_BYTES + 12) + totals,
            (2 * strips + 2 * M) * MUL + (M + int(args[9].sum())) * SQR),
        "chunked_level_prefix_fast": lambda: (
            M * (3 * FQ_BYTES + 12) + totals, strips * MUL),
        "chunked_level_down_fast": lambda: (M * (7 * FQ_BYTES + 8) + totals,
                                            (2 * strips + 2 * M) * MUL
                                            + M * SQR),
        "jacobian_add": lambda: (M * (9 * FQ_BYTES + 4),
                                 M * (11 * MUL + 5 * SQR)),
        "jacobian_add_mixed": lambda: (M * (7 * FQ_BYTES + 4),
                                       M * (4 * MUL + 2 * SQR)),
        "jacobian_double": lambda: (M * 6 * FQ_BYTES,
                                    M * (2 * MUL + 5 * SQR)),
        # Montgomery's trick: a point's prefix product, the two products
        # of the walk back, z^-2 (a square), z^-3, x z^-2 and y z^-3; one
        # Fermat chain for the whole batch
        "jacobian_normalize": lambda: (
            M * 6 * FQ_BYTES, M * (6 * MUL + SQR)
            + chain()[0] * SQR + chain()[1] * MUL),
    }[name]()


def normalize_cases(z, k: int, T: int) -> dict:
    """{case: Z} over the columns of z, a (12, n) batch of Z coordinates,
    for the normalize kernel with chunks of k points and blocks of T
    threads (a thread's chunk strides by T over the block's k*T points):
    ragged widths about k and k*T, a batch of infinities, and, at n - 5,
    Z = 0 at the first and the last point of every thread's chunk and
    over the whole of one block."""
    n = z.shape[1]
    span = k * T
    widths = sorted({1, 2, k - 1, k + 1, T - 1, T + 1, span - 1, span + 3,
                     n - 5} - {0})
    zs = {f"M={M}": z[:, :M].contiguous() for M in widths}
    zs["all infinite"] = torch.zeros_like(z)
    M = n - 5
    lane = torch.arange(M, device=z.device)
    first = lane // span * span + lane % T          # the chunk's first point
    step = lane % span // T
    last = torch.clamp((M - 1 - first) // T + 1, max=k) - 1
    ends = (step == 0) | (step == last) | (lane // span == 3)
    zs["chunk ends infinite"] = torch.where(ends[None], 0, z[:, :M])
    return zs


def jacobian_inputs(F, pairs, z) -> tuple:
    """(X1, Y1, Z1) Jacobian with the random Z `z`, (x2, y2, Z2) affine,
    and the affine (x1, y1, x2, y2), over `pairs` = (x1, y1, m1, x2, y2,
    m2) of level inputs (P + P gives the degenerate flag), with Z = 0
    where a mask says infinity."""
    x1, y1, m1, x2, y2, m2 = pairs
    M = x1.shape[1]
    zz = F.mul(z, z)
    one, zero = F.ones((M,)), F.zeros((M,))
    J = (F.mul(x1, zz), F.mul(y1, F.mul(zz, z)),
         torch.where((m1 != 0)[None], zero, z))
    Q = (x2, y2, torch.where((m2 != 0)[None], zero, one))
    return J, Q, (x1, y1, x2, y2)


def check_full_add_warps(F, J, Q, agree) -> float:
    """The full add on warps of one kind each, in turn: P1 infinite, P2
    infinite, both, P + P, P + (-P), then J and Q's own mixed lanes; held
    to the plain version, the flag and P + (-P)'s infinity checked;
    returns the kernel's ms."""
    from crypto_tpu_torch.ops.kernels import point_kernels as pk
    (X1, Y1, Z1), (X2, Y2, Z2) = J, Q
    n = X1.shape[1]
    kind = torch.arange(n, device=X1.device) // 32 % 6
    zero, one = F.zeros((n,)), F.ones((n,))
    Zf = torch.where(F.is_zero(Z1)[None], one, Z1)          # finite Z1
    same = ((kind == 3) | (kind == 4))[None]
    Z1w = torch.where(((kind == 0) | (kind == 2))[None], zero, Zf)
    Z1w = torch.where((kind == 5)[None], Z1, Z1w)
    Z2w = torch.where(((kind == 1) | (kind == 2))[None], zero,
                      torch.where(same, Zf, one))
    Z2w = torch.where((kind == 5)[None], Z2, Z2w)
    X2w = torch.where(same, X1, X2)
    Y2w = torch.where((kind == 3)[None], Y1,
                      torch.where((kind == 4)[None], F.neg(Y1), Y2))
    w_args = (X1, Y1, Z1w, X2w, Y2w, Z2w)
    pw = pk.jacobian_add_plain(F, *w_args)
    agree("jacobian_add", pk.jacobian_add(F, *w_args), pw,
          f"on warps of one kind at L={F.L}")
    if not (bool(pw[3][kind == 3].all()) and not bool(pw[3][kind < 3].any())
            and bool(F.is_zero(pw[2])[kind == 4].all())):
        raise AssertionError("full-add warp inputs: P + P without the flag "
                             "or P + (-P) not at infinity")
    return cuda_ms(lambda: pk.jacobian_add(F, *w_args))


def check_normalize_cases(F, J, pn, agree) -> list:
    """The normalize at ragged widths about the kernel's chunk k and block
    T, on a batch of infinities, and with infinities at the first and the
    last point of every thread's chunk and one block's chunks all
    infinite (`normalize_cases`).  A ragged width is a prefix of J, so its
    plain outputs are the prefix of `pn`, the full width's (a lane's
    affine coordinates are unique, whatever the batch: `_inverse_plain`);
    the two infinite cases run the plain version.  Returns the cases."""
    from crypto_tpu_torch.ops.kernels import point_kernels as pk
    zs = normalize_cases(J[2], pk.NORMALIZE_CHUNK, pk.NORMALIZE_THREADS)
    for where, z in zs.items():
        M = z.shape[1]
        ins = tuple(t[:, :M].contiguous() for t in J[:2]) + (z,)
        plain = tuple(t[:, :M] for t in pn) if where == f"M={M}" \
            else pk.jacobian_normalize_plain(F, *ins)
        agree("jacobian_normalize", pk.jacobian_normalize(F, *ins), plain,
              f"{where} at L={F.L}")
    return list(zs)


# widths at which each one-launch narrow level is held to its plain
# version beside its paths' own: one and two pairs, a block's 128 threads
# either side, a width of the prove's levels and the widest narrow level
LEVEL_WIDTHS = (1, 2, 127, 129, 2048, 4095)
# widths of the one-launch levels' timing lines
TIMED_LEVEL_WIDTHS = (16, 256, 2048, 4095)


def check_narrow_level(row, agree, F, ins, fast: bool, path=None) -> list:
    """The one-launch level (`affine_level_fast` when `fast`, else
    `affine_level`) held bit for bit to its plain version on the pairs
    `ins`; with a `path`, its kernels-line row (`row`) there, the kernel
    timed."""
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    name = "affine_level_fast" if fast else "affine_level"
    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    M = ins[0].shape[1]
    want, plain_ms = timed_call(lambda: plain(F, *ins))
    err = agree(name, kernel(F, *ins), want, f"at L={F.L} M={M}")
    if path is None:
        return []
    src, rep = KERNEL_SOURCE[name]
    return [row(name, "crypto_tpu_torch/csrc/" + src, "crypto_tpu/" + rep,
                path, err, cuda_ms(lambda: kernel(F, *ins)), plain_ms,
                (F,) + ins, [F.L, M])]


def check_narrow_levels(row, agree, F, inputs, fast: bool, path: str,
                        width: int, more=()) -> list:
    """`check_narrow_level` on `inputs(M)` (generic pairs, doublings,
    P + (-P) and infinite operands) at `path`'s `width` (its row), at the
    widths `more` and at LEVEL_WIDTHS; prints the widths and the kernel's
    time at one pair (a launch and one Fermat chain: the level's latency
    floor).  Returns the row."""
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    widths = sorted({width, *more, *LEVEL_WIDTHS})
    rows = []
    for M in widths:
        rows += check_narrow_level(row, agree, F, inputs(M), fast,
                                   path if M == width else None)
    kernel = ck.affine_level_fast if fast else ck.affine_level
    one = inputs(1)
    phase(f"check_{kernel.__name__}", L=F.L, path=path, pairs=widths,
          one_pair_ms=cuda_ms(lambda: kernel(F, *one)), bit_exact=True)
    return rows


def profile_launches(fn, tries: int = 3) -> tuple:
    """(device operations, their summed device ms) of one fn() call, from
    the profiler's raw events: the fullest of `tries` traces, since a
    short trace on that machine sometimes comes back short of events or
    empty ((0, 0.0) if every one is)."""
    from torch.profiler import ProfilerActivity, profile
    best = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if len(events) > len(best):
            best = events
    return len(best), sum(end - start for _, start, end in best) / 1e6


def level_timings(F, inputs, reps: int = 3) -> None:
    """At each width of TIMED_LEVEL_WIDTHS, on both formulas: the
    one-launch level on `inputs(M)`, timed as one call by CUDA events
    (`reps` times; the median), profiled once (device operations and ms),
    and its bound.  One line a width."""
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    for M in TIMED_LEVEL_WIDTHS:
        ins = inputs(M)
        line = {}
        for fast in (True, False):
            tag = "fast" if fast else "total"
            one = ck.affine_level_fast if fast else ck.affine_level
            ms = [timed_call(lambda: one(F, *ins))[1] for _ in range(reps)]
            n_ops, dev_ms = profile_launches(lambda: one(F, *ins))
            line.update({f"{tag}_one_ms": statistics.median(ms),
                         f"{tag}_one_launches": n_ops,
                         f"{tag}_one_device_ms": dev_ms,
                         f"{tag}_bound_ms": bound_ms(*work(
                             one.__name__, (F,) + ins))[0]})
        phase("affine_level_widths", L=F.L, pairs=M, **line)


def max_err(a, b) -> int:
    """Largest |kernel - plain| over the outputs' int32 words."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


# (path, total formula) -> the level kernels it dispatches to
LEVEL_KERNELS = {
    ("chunked", False): ("chunked_level_prefix_fast",
                         "chunked_level_down_fast"),
    ("narrow", False): ("affine_level_fast",),
    ("chunked", True): ("chunked_level_prefix", "chunked_level_down"),
    ("narrow", True): ("affine_level",),
}
SAFE_KERNELS = LEVEL_KERNELS[("chunked", True)] \
    + LEVEL_KERNELS[("narrow", True)]
G1_LEVEL_KERNELS = sum(LEVEL_KERNELS.values(), ())
# what a G2 MSM launches: the gather, the Fq2 level, mul and square, and
# mont_mul and mont_pow (the norm and the base-field Fermat root of every
# Fq2 inversion)
G2_KERNELS = ("gather_rows_t", "affine_level_pre_fq2",
              "affine_level_post_fq2", "fq2_mul", "fq2_sqr", "mont_mul",
              "mont_pow", "slot_tables")
FQ2_KERNELS = G2_KERNELS[1:5]


def level_kernels(fast_widths, safe_widths, threshold: int) -> set:
    """The kernels a G1 run dispatches to: the gather, mont_mul and
    mont_pow (the Fermat roots) always, the chunked level for calls of at
    least `threshold` pairs, the one-launch narrow level for the narrower
    ones; the fast variants for the fast calls, the total formula for the
    rerun's."""
    names = {"slot_tables", "gather_rows_t", "mont_mul", "mont_pow"}
    for widths, safe in ((fast_widths, False), (safe_widths, True)):
        if any(w >= threshold for w in widths):
            names.update(LEVEL_KERNELS[("chunked", safe)])
        if any(w < threshold for w in widths):
            names.update(LEVEL_KERNELS[("narrow", safe)])
    return names


def rerun_widths(timings: dict) -> list:
    return (timings["rerun_trace"] or {}).get("level_pairs", [])


def spoiled_windows(timings: dict) -> list:
    """The windows that a run's zero denominators touched, from the level
    calls' records: a zero at chunk t of a call of M pairs in K strips
    spoils pairs t + j*(M/K), and pair l lies in window l // (M/windows)."""
    out = set()
    for M, windows, K, zero in timings.get("zero_chunks", []):
        T = zero.numel()
        for t in torch.nonzero(zero).flatten().tolist():
            out.update((t + j * T) // (M // windows) for j in range(K)
                       if t + j * T < M)
    return sorted(out)


def drive(counted, fn):
    """fn() with every launch count set to 0 just before it; returns its
    result and the counts read just after."""
    for f in counted:
        f.launches = 0
    out = fn()
    return out, {f.__name__: f.launches for f in counted}


def require(path: str, launches: dict, names) -> None:
    missing = sorted(k for k in names if launches[k] == 0)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def floats(timings: dict) -> dict:
    return {k: v for k, v in timings.items() if isinstance(v, float)}


# the wrapper argument whose values (not only its shape) a launch's
# `work` reads: the gather's index, the posts' and down passes' doubling
# flags
DATA_ARG = {"gather_rows_t": (1,), "affine_level": (1, 2, 3, 4, 5, 6),
            "affine_level_post_fq2": (6,), "chunked_level_down": (9,)}


def with_shims(counted, on_launch, fn):
    """fn() with every counted wrapper replaced, in each module of the
    port that holds it, by a shim that calls on_launch(name, args) after
    each call that launched.  A wrapper counts its launches into the name
    it is called by, the shim, meanwhile; the counts go back to the
    wrappers after."""
    shims = {}
    for f in counted:
        def shim(*args, _f=f):
            before = shims[_f].launches
            out = _f(*args)
            if shims[_f].launches > before:
                on_launch(_f.__name__, args)
            return out
        shim.launches = 0
        shim.__name__ = f.__name__
        shims[f] = shim
    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("crypto_tpu_torch"):
            continue
        for k, v in list(vars(mod).items()):
            if callable(v) and v in shims:
                patched.append((mod, k, v))
                setattr(mod, k, shims[v])
    try:
        return fn()
    finally:
        for mod, k, v in patched:
            setattr(mod, k, v)
        for f, shim in shims.items():
            f.launches += shim.launches


def record_work(counted, fn):
    """fn() with every counted wrapper shimmed (`with_shims`) to sum `work`
    over the calls that launched; returns fn()'s result and {name:
    [launches, summed bound ms]}.  A shim runs nothing on the card: a
    launch whose work depends on data keeps that one argument (the rest as
    shapes on the meta device) and its work is summed once fn() has
    returned, so a profile in fn() sees the wrappers' own launches only."""
    totals = {f.__name__: [0, 0.0] for f in counted}
    pending = []

    def on_launch(name, args):
        totals[name][0] += 1
        if name in DATA_ARG:
            keep = DATA_ARG[name]
            pending.append((name, tuple(
                torch.empty(a.shape, device="meta")
                if i not in keep and isinstance(a, torch.Tensor) else a
                for i, a in enumerate(args))))
        else:
            totals[name][1] += bound_ms(*work(name, args))[0]

    def run():
        out = fn()
        torch.cuda.synchronize()
        return out

    out = with_shims(counted, on_launch, run)
    for name, args in pending:
        totals[name][1] += bound_ms(*work(name, args))[0]
    return out, totals


def device_events(prof) -> list:
    """(name, start ns, end ns) of every device event of a finished
    profile, read from its raw kineto results: the profiler's own event
    tree (`events()`, `key_averages()`) takes minutes to build for the
    half a million launches of a witness update."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def device_ms_by_entry(events: list) -> dict:
    """{entry point: (kernels, device ms)} from `device_events`, summed
    over each entry point's kernel functions."""
    out = {}
    for key, start, end in events:
        hit = re.search(r"(\w+_kernel)\b", key)
        name = KERNEL_ENTRY.get(hit.group(1)) if hit else None
        if name is None:
            continue
        cnt, ms = out.get(name, (0, 0.0))
        out[name] = (cnt + 1, ms + (end - start) / 1e6)
    return out


def timed_call(fn):
    """(fn(), milliseconds of that one call on the card)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def device_profile(name: str, fn, cpu: bool = True) -> dict:
    """fn() under the profiler: prints its wall time, the device's busy
    time and idle share and the six kernels with the most device time;
    returns `device_ms_by_entry` of the profile.  `cpu=False` traces the
    device alone (a run of many host ops, whose trace takes long to
    read)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events, by_name = device_events(prof), {}
    for key, start, end in events:
        k = by_name.setdefault(key[:48], [0, 0])
        k[0] += 1
        k[1] += (end - start) / 1e3
    busy_ns, reach = 0, None          # union of the kernels' intervals
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    busy = busy_ns / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    phase(name, wall_s=round(wall, 4),
          device_busy_s=round(busy, 4) if busy else "not measured",
          idle_share=round(1 - busy / wall, 4) if busy
          else "not measured",
          device_launches=len(events),
          top_ms=[(k, cnt, round(us / 1e3, 3))
                  for k, (cnt, us) in top])
    return device_ms_by_entry(events)


QAP_LOG = 20                        # the G2 cell's circuit: 2^20 variables
LEGO_LOG = 16                       # BASELINE.json: the prove at 2^16
BN254_LEGO_LOG = 12                 # BN254's prove, cut from 2^16 for time
PROVE_RUNS = 1                      # timed proves after one warm-up
# what a LegoGroth16 prove launches: the NTTs' mont_mul; the G1 query
# MSMs' fast chunked levels, gather, slot tables and Fermat roots; the
# b_g2 MSM's Fq2 level, mul and square.  The setup's fixed-base tables
# run the total TCurve ops: mont_mul on G1, the Fq2 mul and square on G2.
PROVE_KERNELS = ("mont_mul", "mont_pow", "chunked_level_prefix_fast",
                 "chunked_level_down_fast", "affine_level_pre_fq2",
                 "affine_level_post_fq2", "fq2_mul", "fq2_sqr",
                 "gather_rows_t", "slot_tables")
SETUP_KERNELS = ("mont_mul", "fq2_mul", "fq2_sqr")
POINT_KERNELS = ("jacobian_add", "jacobian_add_mixed", "jacobian_double",
                 "jacobian_normalize")


def chain_circuit(nc: int, x_val=None, F=None):
    """`benches/bench_northstar.py` `chain_circuit` on the port's R1CS:
    x_{i+1} = x_i^2 + x_i + i over nc constraints of the scalar field F
    (BLS12-381's by default), x the first witness, the last value the one
    public input."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.r1cs.cs import LinearCombination as LC
    F = F or bls.Fr

    def circuit(cs):
        vals = None
        if x_val is not None:
            vals = [x_val]
            for i in range(nc):
                v = vals[-1]
                vals.append(v * v + v + F(i))
        out = cs.new_input(None if vals is None else vals[-1])
        cur = cs.new_witness(x_val)
        for i in range(nc):
            if i == nc - 1:
                nxt, nxt_lc = None, out.lc()
            else:
                nxt = cs.new_witness(None if vals is None else vals[i + 1])
                nxt_lc = nxt.lc()
            cs.enforce(cur.lc(), cur.lc() + LC.constant(F, 1),
                       nxt_lc + LC.constant(F, -i % F.p))
            if nxt is not None:
                cur = nxt
    return circuit


def horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def qap_h_phase(counted, dev) -> dict:
    """`qap_h` on a 2^20 domain: random rows a, b and c = a b from the
    seed, each NTT timed on its own, checked on the host (intt(ntt(a)) ==
    a exactly, 8 ntt outputs against Horner at w^j, and A(tau) B(tau) -
    C(tau) = h(tau) (tau^n - 1) at a random tau, A(tau) from the Lagrange
    coefficients).  Returns the path's launches."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    from crypto_tpu_torch.ops.ntt import domain_for
    n, R = 1 << QAP_LOG, bls.R
    hr = random.Random(SEED + 80)
    t0 = time.perf_counter()
    a = [hr.randrange(R) for _ in range(n)]
    b = [hr.randrange(R) for _ in range(n)]
    c = [x * y % R for x, y in zip(a, b)]
    dom = domain_for(bls.Fr, n, dev)
    T = dom.T
    pa, pb, pc = T.pack(a), T.pack(b), T.pack(c)
    dom.coset_ntt(pa)                           # builds the coset tables
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        out = snark.qap_h(dom, pa, pb, pc)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (h, t_qap), launches = drive(counted, run)
    require("qap_h 2^20", launches, ("mont_mul",))
    per_ntt = {}
    for name in ("ntt", "intt", "coset_ntt", "coset_intt", "ntt", "intt"):
        fn = getattr(dom, name)
        before = fk.mont_mul.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(pa)
        torch.cuda.synchronize()
        per_ntt.setdefault(name + "_s", []).append(time.perf_counter() - t)
        per_ntt[name + "_mont_mul_launches"] = fk.mont_mul.launches - before
    fwd = dom.ntt(pa)
    if not torch.equal(dom.intt(fwd), pa):
        raise AssertionError("intt(ntt(a)) != a at 2^20")
    js = sorted(random.Random(SEED + 81).sample(range(n), 8))
    got = np.atleast_1d(T.unpack(fwd[:, js]))
    if any(int(g) != horner(a, pow(dom.w, j, R), R) for g, j in zip(got, js)):
        raise AssertionError("2^20 ntt disagrees with Horner at w^j")
    t0 = time.perf_counter()
    tau = hr.randrange(R)
    lag = snark._lagrange_coeffs_at(dom, tau)
    A, B, C = (sum(x * y for x, y in zip(v, lag)) % R for v in (a, b, c))
    hv = [int(v) for v in np.atleast_1d(T.unpack(h))]
    if (A * B - C) % R != horner(hv, tau, R) * (pow(tau, n, R) - 1) % R \
            or hv[-1] != 0:
        raise AssertionError("2^20 qap_h: A B - C != h Z_H at tau")
    phase("qap_h_2^20", n=n, qap_h_s=t_qap, setup_s=t_setup,
          mont_mul_launches=launches["mont_mul"], **per_ntt,
          ntt_samples=js, check_s=time.perf_counter() - t0,
          correct=True)
    return launches


def qap_at(cs, lag: list, p: int) -> tuple:
    """The QAP's per-variable a_i(tau), b_i(tau), c_i(tau), from the
    Lagrange coefficients at tau: the CRS's discrete logs."""
    nvars = cs.num_instance + cs.num_witness
    out = ([0] * nvars, [0] * nvars, [0] * nvars)
    for rows, vec in zip((cs.a_rows, cs.b_rows, cs.c_rows), out):
        for i, row in enumerate(rows):
            for coeff, idx in row:
                vec[idx] = (vec[idx] + lag[i] * coeff) % p
    for j in range(cs.num_instance):
        out[0][j] = (out[0][j] + lag[cs.num_constraints + j]) % p
    return out


def legogroth16_phases(counted, dev, mod=None, tag: str = "",
                       log_n: int = LEGO_LOG, keep: dict | None = None) -> dict:
    """The north-star workload (`benches/bench_northstar.py`) over the
    port's curve module `mod` (BLS12-381 by default; BN254 with tag
    "bn254_"): `chain_circuit` at 2^log_n - 4 constraints (2^16 - 4 by
    default; BN254's runs at `BN254_LEGO_LOG`), one committed witness.  The setup from explicit trapdoors, then one warm-up prove
    and `PROVE_RUNS` timed ones, each checked in the exponent: every proof
    element equals its discrete log (from the trapdoors, the replayed
    rng's tau, r, s and v, and the assignment) times the generator, the
    logs satisfy the verification equation A B = alpha beta + gamma
    (inputs + D) + delta C, and every device MSM equals the sum of its
    scalars times its points' known logs.  Then the port's verifier on
    the last proof (`verify_phase`).  Returns ({path: launches}, the
    last checked prove's b_g2 query MSM as {"points": TPoints, "scalars",
    "out"}); `keep`, when
    given, gets the proving key as "pk"."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves.tcurve import TPoints
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.ops import fixed_base
    from crypto_tpu_torch.ops.ntt import domain_for
    from crypto_tpu_torch.r1cs.cs import ConstraintSystem
    mod = mod or bls
    F, R = mod.Fr, mod.R
    G1, G2 = mod.G1.generator(), mod.G2.generator()
    nc = (1 << log_n) - 4
    N = 1 << log_n
    hr = random.Random(SEED + 90)
    alpha, beta, gamma, delta, eta = (hr.randrange(1, R) for _ in range(5))
    setup_seed = SEED + 91

    # ---- setup: the tables, then generate_parameters_with_trapdoors with
    # its fixed-base products, the device part of each, and its host
    # normalisation timed apart
    spent = dict.fromkeys(("tables_s", "mul_many_s", "fixed_base_many_s",
                           "normalize_s"), 0.0)
    real_fb, real_norm = snark._fixed_base_many, snark._normalized
    real_mm = fixed_base.FixedBaseTable.mul_many

    def timer(key, fn, sync=False):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return timed

    def setup():
        t = time.perf_counter()
        for g in (G1, G2):
            fixed_base.table_for(g.curve, g, device=dev)
        torch.cuda.synchronize()
        spent["tables_s"] = time.perf_counter() - t
        return snark.generate_parameters_with_trapdoors(
            chain_circuit(nc, F=F), 1, random.Random(setup_seed),
            *(F(x) for x in (alpha, beta, gamma, delta, eta)), ctx=mod,
            device=dev)

    snark._fixed_base_many = timer("fixed_base_many_s", real_fb)
    snark._normalized = timer("normalize_s", real_norm)
    fixed_base.FixedBaseTable.mul_many = timer("mul_many_s", real_mm, True)
    try:
        t0 = time.perf_counter()
        pk, setup_launches = drive(counted, setup)
        t_setup = time.perf_counter() - t0
    finally:
        snark._fixed_base_many, snark._normalized = real_fb, real_norm
        fixed_base.FixedBaseTable.mul_many = real_mm
    require(f"{tag}LegoGroth16 setup", setup_launches, SETUP_KERNELS)

    # the CRS's discrete logs, from the trapdoors and the replayed tau
    t0 = time.perf_counter()
    rr = random.Random(setup_seed)
    while True:
        tau = int(F.rand(rr))
        if (pow(tau, N, R) - 1) % R:
            break
    cs0 = ConstraintSystem(F, mode="setup")
    chain_circuit(nc, F=F)(cs0)
    lag = snark._lagrange_coeffs_at(domain_for(F, N, dev), tau, F)
    qa, qb, qc = qap_at(cs0, lag, R)
    n_inst = cs0.num_instance
    n_commit = n_inst + 1
    zt = (pow(tau, N, R) - 1) % R
    gi, di = pow(gamma, -1, R), pow(delta, -1, R)
    lin = [(beta * x + alpha * y + z) % R for x, y, z in zip(qa, qb, qc)]
    dlogs = {"a_query": qa, "b_g1_query": qb, "b_g2_query": qb,
             "h_query": [zt * di * pow(tau, i, R) % R for i in range(N - 1)],
             "l_query": [x * di % R for x in lin[n_commit:]]}
    gamma_abc = [x * gi % R for x in lin[:n_commit]]
    sample = random.Random(SEED + 92)
    checked = 0
    for name, logs in dlogs.items():
        pts = getattr(pk, name)
        if len(pts) != len(logs):
            raise AssertionError(f"setup: {name} has {len(pts)} points, "
                                 f"{len(logs)} expected")
        G = G2 if name == "b_g2_query" else G1
        for i in sample.sample(range(len(pts)), 8) + [0, len(pts) - 1]:
            checked += 1
            if pts[i] != G.mul_raw(logs[i]):
                raise AssertionError(f"setup: {name}[{i}] is not its log "
                                     f"times the generator")
    vk = pk.vk
    if (vk.gamma_abc_g1 != [G1.mul_raw(x) for x in gamma_abc]
            or vk.alpha_g1 != G1.mul_raw(alpha)
            or vk.delta_g2 != G2.mul_raw(delta)
            or pk.delta_g1 != G1.mul_raw(delta)
            or vk.eta_gamma_inv_g1 != G1.mul_raw(eta * gi % R)):
        raise AssertionError("setup: a key element is not its log times "
                             "the generator")
    phase(f"{tag}legogroth16_setup", constraints=nc, domain=N, seconds=t_setup,
          tables_s=spent["tables_s"], mul_many_device_s=spent["mul_many_s"],
          fixed_base_many_s=spent["fixed_base_many_s"],
          normalize_host_s=spent["normalize_s"],
          other_s=t_setup - spent["tables_s"] - spent["fixed_base_many_s"]
          - spent["normalize_s"],
          queries={k: len(getattr(pk, k)) for k in dlogs},
          launches={k: setup_launches[k] for k in SETUP_KERNELS},
          points_checked=checked, check_s=time.perf_counter() - t0,
          correct=True)

    # ---- the proves: the witness map and each query MSM timed (as
    # bench_northstar.py splits them), every MSM and the witness map's h
    # recorded for the checks
    x = F(hr.randrange(R))
    cs1 = ConstraintSystem(F, mode="prove")
    chain_circuit(nc, x, F)(cs1)
    z = [int(v) for v in cs1.full_assignment()]
    az, bz = (sum(u * v for u, v in zip(z, q)) % R for q in (qa, qb))
    lin_z = [u * v % R for u, v in zip(z, lin)]
    inputs_z, committed_z = sum(lin_z[:n_inst]), sum(lin_z[n_inst:n_commit])
    uncommitted_z = sum(lin_z[n_commit:]) % R
    record = {}
    real_wm, real_mq = snark.witness_map, snark._msm_query

    def wm(*args, **kw):
        t = time.perf_counter()
        out = real_wm(*args, **kw)
        record["witness_map_s"] = time.perf_counter() - t
        record["h"] = out
        return out

    def mq(pk_, name, scalars, offset=0, **kw):
        t = time.perf_counter()
        out = real_mq(pk_, name, scalars, offset, **kw)
        record[f"msm_{name}_s"] = time.perf_counter() - t
        record.setdefault("msms", []).append(
            (name, [int(s) for s in scalars], offset, out))
        return out

    def create(seed: int):
        record.clear()
        t = time.perf_counter()
        out = snark.create_proof(chain_circuit(nc, x, F), pk,
                                 random.Random(seed), ctx=mod, device=dev)
        return out, time.perf_counter() - t

    last = []

    def prove(seed: int):
        (proof, v, committed), total = create(seed)
        check_proof(seed, proof, int(v), committed)
        last[:] = [proof, v, committed]
        split = {k: v_ for k, v_ in record.items() if k.endswith("_s")}
        split["other_s"] = total - sum(split.values())
        return total, split

    def check_proof(seed, proof, v, committed):
        rr = random.Random(seed)
        r, s = int(F.rand(rr)), int(F.rand(rr))
        if v != int(F.rand(rr)) or [int(w) for w in committed] != [int(x)]:
            raise AssertionError("prove: v or the committed witness does "
                                 "not replay")
        h_tau = horner(record["h"][:N - 1], tau, R)
        A = (alpha + r * delta + az) % R
        B = (beta + s * delta + bz) % R
        C = (A * s + B * r - r * s * delta
             + di * (uncommitted_z + zt * h_tau - v * eta)) % R
        D = gi * (committed_z + v * eta) % R
        inputs = gi * inputs_z % R
        if (A * B - alpha * beta - gamma * (inputs + D) - delta * C) % R:
            raise AssertionError("prove: the logs fail the verification "
                                 "equation")
        if (proof.a, proof.b, proof.c, proof.d) != (
                G1.mul_raw(A), G2.mul_raw(B), G1.mul_raw(C), G1.mul_raw(D)):
            raise AssertionError("prove: a proof element is not its log "
                                 "times the generator")
        names = sorted(m[0] for m in record["msms"])
        if names != sorted(dlogs):
            raise AssertionError(f"prove: MSMs {names}")
        for name, sc, off, out in record["msms"]:
            G = G2 if name == "b_g2_query" else G1
            logs = dlogs[name][off:off + len(sc)]
            if out != G.mul_raw(sum(u * w for u, w in zip(sc, logs)) % R):
                raise AssertionError(f"prove: msm over {name} disagrees "
                                     f"with its known logs")

    snark.witness_map, snark._msm_query = wm, mq
    try:
        t0 = time.perf_counter()
        warm, _ = prove(SEED + 93)
        runs, splits, launches = [], [], None
        for run in range(PROVE_RUNS):
            if launches is None:
                (total, split), launches = drive(
                    counted, lambda: prove(SEED + 94 + run))
            else:
                total, split = prove(SEED + 94 + run)
            runs.append(total)
            splits.append(split)
            phase(f"{tag}legogroth16_prove_run", run=run, seconds=total,
                  **split, correct=True)
        t_all = time.perf_counter() - t0
        msm_sizes = {m[0]: len(m[1]) for m in record["msms"]}
        # the last checked prove's b_g2 MSM: its packed points, scalars
        # and result, for the kernel checks at the prove's own widths
        _, g2_sc, g2_off, g2_out = next(m for m in record["msms"]
                                        if m[0] == "b_g2_query")
        g2_pts = next(v for k, v in pk.device_cache.items()
                      if k[0] == "b_g2_query")
        g2_msm = dict(points=TPoints(*(t[:, g2_off:g2_off + len(g2_sc)]
                                       .contiguous() for t in g2_pts)),
                      scalars=g2_sc, out=g2_out)
    finally:
        snark.witness_map, snark._msm_query = real_wm, real_mq
    require(f"{tag}LegoGroth16 prove", launches, PROVE_KERNELS)
    if any(launches[k] for k in POINT_KERNELS):
        raise AssertionError(f"prove launched a point kernel: {launches}")
    med = statistics.median(runs)
    phase(f"{tag}legogroth16_prove", constraints=nc, runs=PROVE_RUNS,
          seconds=runs, median_s=med, spread=max(runs) / min(runs),
          warmup_s=warm, phases_median={
              k: statistics.median(sp[k] for sp in splits)
              for k in splits[0]}, msm_points=msm_sizes,
          launches={k: v for k, v in launches.items() if v},
          mont_pow_launches=launches["mont_pow"],
          mont_mul_launches=launches["mont_mul"],
          narrow_level_launches=launches["affine_level_fast"],
          all_s=t_all, correct=True)
    pub = [F(int(v_)) for v_ in cs1.instance_assignment[1:]]
    verify_launches = verify_phase(counted, mod, pk, pub, *last, tag)
    if keep is not None:
        keep["pk"] = pk
    return {f"{tag}legogroth16_setup": setup_launches,
            f"{tag}legogroth16_prove": launches,
            f"{tag}legogroth16_verify": verify_launches}, g2_msm


def verify_phase(counted, mod, pk, pub, proof, v, committed,
                 tag: str) -> dict:
    """The port's verifier (`snark.verify_proof` on the host pairing of
    `mod`, as the reference's) on a proof of the prove phase: it accepts
    the proof, rejects a spoiled public input and a spoiled C, opens D
    with v (`verify_commitment`) and refuses another witness; a
    `rerandomize_proof` output verifies; a `rerandomize_proof_1` output
    verifies and opens with the new v and not the old.  Returns the
    launches (none: host code)."""
    from crypto_tpu_torch.legogroth16 import snark
    F, vk = mod.Fr, pk.vk
    G = mod.G1.generator()
    secs = {}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        secs.setdefault(key, []).append(time.perf_counter() - t)
        return out

    def run():
        pvk = timed("prepare_s", snark.PreparedVerifyingKey.from_vk, vk,
                    ctx=mod)
        bad_c = snark.Proof(a=proof.a, b=proof.b, d=proof.d,
                            c=(proof.c + G).normalize())
        new_v = F(0x5EED)
        rr = timed("rerandomize_s", snark.rerandomize_proof, proof, vk,
                   random.Random(SEED + 98), ctx=mod)
        rr1 = timed("rerandomize_1_s", snark.rerandomize_proof_1, proof, v,
                    new_v, vk, pk.eta_delta_inv_g1, random.Random(SEED + 99),
                    ctx=mod)
        got = {
            "valid": timed("verify_s", snark.verify_proof, pvk, proof, pub,
                           ctx=mod),
            "spoiled_input": timed("verify_s", snark.verify_proof, pvk,
                                   proof, [pub[0] + F(1)], ctx=mod),
            "spoiled_c": timed("verify_s", snark.verify_proof, pvk, bad_c,
                               pub, ctx=mod),
            "commitment": timed("commitment_s", snark.verify_commitment, vk,
                                proof, pub, committed, v, ctx=mod),
            "commitment_other_witness": snark.verify_commitment(
                vk, proof, pub, [committed[0] + F(1)], v, ctx=mod),
            "rerandomized": timed("verify_s", snark.verify_proof, pvk, rr,
                                  pub, ctx=mod),
            "rerandomized_1": timed("verify_s", snark.verify_proof, pvk,
                                    rr1, pub, ctx=mod),
            "rerandomized_1_opens_new_v": snark.verify_commitment(
                vk, rr1, pub, committed, new_v, ctx=mod),
            "rerandomized_1_opens_old_v": snark.verify_commitment(
                vk, rr1, pub, committed, v, ctx=mod)}
        return got

    got, launches = drive(counted, run)
    want = {"valid": True, "spoiled_input": False, "spoiled_c": False,
            "commitment": True, "commitment_other_witness": False,
            "rerandomized": True, "rerandomized_1": True,
            "rerandomized_1_opens_new_v": True,
            "rerandomized_1_opens_old_v": False}
    if got != want:
        raise AssertionError(f"{tag}legogroth16_verify: {got}")
    phase(f"{tag}legogroth16_verify", checks=got, seconds=secs,
          verify_median_s=statistics.median(secs["verify_s"]),
          launches=sum(launches.values()), correct=True)
    return launches

PAIRS = 64                          # benches/bench_pairing.py NPAIR
PAIRING_RUNS = 1                    # timed multi-pairings, fresh pairs each
NSIG = 1024                         # bench_pairing.py NSIG, over 4 messages
SIG_MSGS = 4
PAIRING_ENV = "CRYPTO_TPU_PAIRING_BACKEND"
# what a multi-pairing launches: the Fq2 products and squares of the
# towers, mont_mul (the lines' scaling by the G1 point, the doubling's
# halvings, the inverse's norms) and mont_pow (the final exponentiation's
# Fq inverse); the checker's Miller product has no inverse
PAIRING_KERNELS = ("mont_mul", "mont_pow", "fq2_mul", "fq2_sqr")
CHECKER_KERNELS = ("mont_mul", "fq2_mul", "fq2_sqr")


def known_log_points(gen, logs, dev) -> list:
    """gen * log for each log, as normalised host points (the port's
    fixed-base products: a host window table below 512 logs, the device
    table from 512 on)."""
    from crypto_tpu_torch.utils.msm import \
        multiply_field_elems_with_same_group_elem
    return [p.normalize() for p in
            multiply_field_elems_with_same_group_elem(gen, logs, device=dev)]


def pairing_phases(counted, dev) -> tuple:
    """The pairing slice at `benches/bench_pairing.py`'s size: a 64-pair
    multi-pairing (plus one pair with G1 at infinity) once cold and
    `PAIRING_RUNS` times timed on fresh pairs, each against its known
    logs; the first pair set's per-pair Miller values against the host
    Miller loop and its product against the host multi-pairing;
    bilinearity and a product that is one; a lazy checker with 64
    deferred pairs, valid and spoiled; the BBS+ batch verify of `NSIG`
    signatures, valid and spoiled.  Returns ({path: launches}, the level
    widths of the batch verify's MSMs)."""
    import os
    from types import SimpleNamespace

    from crypto_tpu_torch.bbs_plus import batch
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    R = bls.R
    G1, G2 = bls.G1.generator(), bls.G2.generator()
    tp = tpairing_for("bls12_381", dev)
    hr = random.Random(SEED + 100)
    paths = {}

    # ---- pairing_64: pair sets from known logs, the product's log known
    t0 = time.perf_counter()
    nsets = 1 + PAIRING_RUNS
    la = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    lb = [hr.randrange(1, R) for _ in range(nsets * PAIRS)]
    A, B = known_log_points(G1, la, dev), known_log_points(G2, lb, dev)
    sets = []
    for k in range(nsets):
        sl = slice(k * PAIRS, (k + 1) * PAIRS)
        sets.append((list(zip(A[sl], B[sl])) + [(bls.G1.infinity(),
                                                 B[k * PAIRS])],
                     sum(x * y for x, y in zip(la[sl], lb[sl])) % R))
    gt = bls.gt_generator()
    t_setup = time.perf_counter() - t0

    torch.cuda.synchronize()
    t = time.perf_counter()
    cold = tp.multi_pairing(sets[0][0])
    t_cold = time.perf_counter() - t
    t0 = time.perf_counter()
    lanes = tp.t12.unpack_host(tp.miller_loop_batch(
        *tp.pack_pairs(sets[0][0])))
    if any(m != bls.miller_loop([pq]) for m, pq in zip(lanes, sets[0][0])):
        raise AssertionError("pairing_64: a lane's Miller value differs "
                             "from the host Miller loop")
    if cold != bls.multi_pairing(sets[0][0]) or cold != gt ** sets[0][1]:
        raise AssertionError("pairing_64: the product differs from the "
                             "host multi-pairing")
    t_check = time.perf_counter() - t0

    secs, launches = [], None
    for run in range(PAIRING_RUNS):
        pairs, log = sets[1 + run]

        def timed():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tp.multi_pairing(pairs)
            return out, time.perf_counter() - t

        if launches is None:
            (out, dt), launches = drive(counted, timed)
        else:
            out, dt = timed()
        if out != gt ** log:
            raise AssertionError("pairing_64: a timed multi-pairing "
                                 "differs from its known log")
        secs.append(dt)
    require("pairing_64", launches, PAIRING_KERNELS)
    paths["pairing_64"] = launches

    a, b = hr.randrange(1, R), hr.randrange(1, R)
    aP, bQ = G1.mul_raw(a).normalize(), G2.mul_raw(b).normalize()
    abP = G1.mul_raw(a * b % R).normalize()
    e1, e2 = tp.t12.unpack_host(tp.final_exponentiation(
        tp.miller_loop_batch(*tp.pack_pairs([(aP, bQ), (abP, G2)]))))
    if e1 != e2 or not tp.multi_pairing([(aP, G2), (-aP, G2)]).is_one():
        raise AssertionError("pairing_64: e(aP, bQ) != e(abP, Q) or "
                             "e(aP, Q) e(-aP, Q) != 1")
    med = statistics.median(secs)
    phase("pairing_64", pairs=PAIRS, infinite_pairs=1, runs=PAIRING_RUNS,
          seconds=secs, median_s=med, spread=max(secs) / min(secs),
          cold_s=t_cold, device_multi_pairing_64_wall_s=med,
          pairings_per_s=PAIRS / med, setup_s=t_setup,
          host_check_s=t_check, launches={k: launches[k]
                                          for k in PAIRING_KERNELS},
          bilinear=True, product_is_one=True, correct=True)

    # ---- pairing_checker: 64 deferred pairs from known logs through the
    # device Miller product; one spoiled pair turns the verdict
    rows = []
    for _ in range(PAIRS // 2):
        x, y, z = (hr.randrange(1, R) for _ in range(3))
        rows.append((x, y, x * y * pow(z, -1, R) % R, z))
    g1s = known_log_points(G1, [r[0] for r in rows] + [r[2] for r in rows],
                           dev)
    g2s = known_log_points(G2, [r[1] for r in rows] + [r[3] for r in rows],
                           dev)
    k = len(rows)
    quads = [(g1s[i], g2s[i], g1s[k + i], g2s[k + i]) for i in range(k)]
    weight = hr.randrange(1, R)
    env = os.environ.pop(PAIRING_ENV, None)

    def checker(spoil: bool):
        c = RandomizedPairingChecker(bls.Fr(weight), lazy=True, device=dev)
        qs = list(quads)
        if spoil:
            p1, q1, p2, q2 = qs[-1]
            qs[-1] = (p1, q1, p2, q2.double().normalize())
        c.add_sources(*qs[0])
        c.add_multiple_sources(*zip(*qs[1:]))
        return c

    try:
        good, bad = checker(False), checker(True)
        t = time.perf_counter()
        ok, chk_launches = drive(counted, good.verify)
        t_chk = time.perf_counter() - t
        rejected = not bad.verify()
    finally:
        if env is not None:
            os.environ[PAIRING_ENV] = env
    if len(good.pending) != PAIRS or not ok or not rejected:
        raise AssertionError(f"pairing_checker: {len(good.pending)} "
                             f"pairs, valid {ok}, spoiled rejected "
                             f"{rejected}")
    require("pairing_checker", chk_launches, CHECKER_KERNELS)
    paths["pairing_checker"] = chk_launches
    phase("pairing_checker", deferred_pairs=len(good.pending),
          verify_s=t_chk, valid=ok, spoiled_rejected=rejected,
          launches={k: chk_launches[k] for k in PAIRING_KERNELS},
          correct=True)

    # ---- bbs_batch_verify_1024: signatures from known logs (params,
    # key and each A_i = (g1 + h_0 s + sum h_j m_j)/(e + x) by its log)
    t0 = time.perf_counter()
    lg, l0, l2, x = (hr.randrange(1, R) for _ in range(4))
    lh = [hr.randrange(1, R) for _ in range(SIG_MSGS)]
    pts = known_log_points(G1, [lg, l0] + lh, dev)
    params = SimpleNamespace(g1=pts[0], h_0=pts[1], h=pts[2:],
                             g2=G2.mul_raw(l2).normalize(),
                             supported_message_count=SIG_MSGS)
    pk = SimpleNamespace(w=G2.mul_raw(l2 * x % R).normalize())
    msgs = [[hr.randrange(R) for _ in range(SIG_MSGS)] for _ in range(NSIG)]
    es = [hr.randrange(R) for _ in range(NSIG)]
    ss = [hr.randrange(R) for _ in range(NSIG)]
    a_logs = [(lg + l0 * s_ + sum(h * m for h, m in zip(lh, ms)))
              * pow(e + x, -1, R) % R for e, s_, ms in zip(es, ss, msgs)]
    sigs = [SimpleNamespace(A=A_, e=bls.Fr(e), s=bls.Fr(s_))
            for A_, e, s_ in zip(known_log_points(G1, a_logs, dev), es, ss)]
    msgs = [[bls.Fr(m) for m in ms] for ms in msgs]
    t_sign = time.perf_counter() - t0
    spoiled = list(sigs)
    s5 = spoiled[5]
    spoiled[5] = SimpleNamespace(A=s5.A, e=s5.e + bls.Fr(1), s=s5.s)

    widths, safe_widths = [], []
    real_msm = batch.msm_device_scheduled
    log_of = {(p.X, p.Y): lg_ for p, lg_ in zip((s_.A for s_ in sigs),
                                               a_logs)}

    def msm(curve, points, scalars, device):
        tm = {}
        out = real_msm(curve, points, scalars, device=device, timings=tm)
        widths.extend(tm["level_pairs"])
        safe_widths.extend(rerun_widths(tm))
        want = sum(s_ * log_of[(p.X, p.Y)] for s_, p in zip(scalars, points))
        if out != G1.mul_raw(want % R):
            raise AssertionError("bbs batch verify: an MSM differs from "
                                 "its known logs")
        return out

    def verify(sig_set, seed):
        return batch.batch_verify_signatures(sig_set, msgs, pk, params,
                                             random.Random(seed), device=dev)

    # the cold run counted, its two MSMs held to their known logs; then
    # the timed warm run and the spoiled set on the MSM entry as it is
    env = os.environ.get(PAIRING_ENV)
    os.environ[PAIRING_ENV] = "device"
    try:
        batch.msm_device_scheduled = msm
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_cold, bbs_launches = drive(counted,
                                          lambda: verify(sigs, SEED + 103))
            t_cold_v = time.perf_counter() - t
        finally:
            batch.msm_device_scheduled = real_msm
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok_warm = verify(sigs, SEED + 104)
        t_warm = time.perf_counter() - t
        ok_spoiled = verify(spoiled, SEED + 105)
    finally:
        if env is None:
            os.environ.pop(PAIRING_ENV)
        else:
            os.environ[PAIRING_ENV] = env
    if not (ok_cold and ok_warm) or ok_spoiled:
        raise AssertionError(f"bbs batch verify: valid {ok_cold}/{ok_warm},"
                             f" spoiled {ok_spoiled}")
    bbs_widths = widths
    require("bbs_batch_verify_1024", bbs_launches,
            set(PAIRING_KERNELS) | level_kernels(
                bbs_widths, safe_widths, msm_v2.CHUNK_MIN_PAIRS))
    paths["bbs_batch_verify_1024"] = bbs_launches
    phase("bbs_batch_verify_1024", signatures=NSIG, messages=SIG_MSGS,
          bbs_plus_batch_verify_1024_wall_s=t_warm, cold_s=t_cold_v,
          sigs_per_s=NSIG / t_warm, signing_s=t_sign,
          msm_level_pairs=bbs_widths, rerun_level_pairs=safe_widths,
          launches={k: v for k, v in bbs_launches.items() if v},
          valid=True, spoiled_rejected=True, correct=True)
    return paths, bbs_widths


POK_N = 256                         # proofs in the batch verify
POK_MSGS = 32                       # BASELINE.json config 2: 32 messages,
POK_REVEALED = 4                    # 4 of them revealed
POK_PROTOCOL = 4                    # proofs made by the port's own protocol
POK_SPOILED_N = 32                  # proofs in the spoiled-response batch
CHECKER_POKS, CHECKER_SIGS, CHECKER_23 = 16, 4, 2


def bbs_pok_phases(counted, dev) -> tuple:
    """BASELINE config 2 on the card: `batch_verify_proofs` over `POK_N`
    PoKOfSignatureG1 proofs of `POK_MSGS` messages (`POK_REVEALED`
    revealed), the pairing on the device, once cold (counted, both MSMs
    held to their known logs) and once warm (timed, host checker, device
    MSMs and pairing apart), and two spoiled sets that must be rejected:
    `POK_SPOILED_N` proofs with one response off by one (the mult checker
    fails before any MSM or pairing runs) and all `POK_N` with one proof
    made under another secret key (its Schnorr legs hold, both MSMs run
    on the card, counted and every level kernel required, and the
    pairing fails).  The params, key and `POK_N - POK_PROTOCOL` proofs
    come from the protocol's algebra over known logs (one
    `known_log_points` call); `POK_PROTOCOL` proofs come from the port's
    `SignatureG1.new` and `PoKOfSignatureG1Protocol`, their sign, prove
    and host verify timed.  Then one lazy `RandomizedPairingChecker` on
    the card takes `CHECKER_POKS` PoKs, `CHECKER_SIGS` signatures and
    `CHECKER_23` BBS23 PoKs: valid, and with one signature spoiled.
    Returns ({path: launches}, the batch verify's MSM level widths,
    {path: lanes of its device Miller loop})."""
    import os

    from crypto_tpu_torch.bbs_plus import batch
    from crypto_tpu_torch.bbs_plus import bbs23
    from crypto_tpu_torch.bbs_plus.proof import (
        MessageOrBlinding, PoKOfSignatureG1Proof, PoKOfSignatureG1Protocol,
        compute_challenge_contribution)
    from crypto_tpu_torch.bbs_plus.setup import (PublicKeyG2, SecretKey,
                                                 SignatureParamsG1)
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.hashing import compute_random_oracle_challenge
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.schnorr.discrete_log import PokPedersenCommitment
    from crypto_tpu_torch.schnorr.generalized import SchnorrResponse
    from crypto_tpu_torch.serialize import ByteWriter
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    R, Fr = bls.R, bls.Fr
    G1, G2 = bls.G1.generator(), bls.G2.generator()
    hr = random.Random(SEED + 200)
    paths = {}

    def inv(v):
        return pow(v, -1, R)

    # ---- params and key from known logs; 1 + POK_N - POK_PROTOCOL proofs
    # by the protocol's algebra (the last under another secret key)
    t0 = time.perf_counter()
    lg, l0, l2, x, x_other = (hr.randrange(1, R) for _ in range(5))
    lh = [hr.randrange(1, R) for _ in range(POK_MSGS)]
    hidden = range(POK_REVEALED, POK_MSGS)
    rows = []
    for k in range(1 + POK_N - POK_PROTOCOL):
        m = [hr.randrange(R) for _ in range(POK_MSGS)]
        e, s_, r2 = (hr.randrange(R) for _ in range(3))
        r1, b1, b2, bd, bs = (hr.randrange(1, R) for _ in range(5))
        bl = [hr.randrange(R) for _ in hidden]
        lb = (lg + l0 * s_ + sum(h * v for h, v in zip(lh, m))) % R
        key = x_other if k == POK_N - POK_PROTOCOL else x
        la = lb * inv(e + key) % R
        ap, ld = la * r1 % R, (r1 * lb - l0 * r2) % R
        logs = [ap, r1 * (lb - la * e) % R, ld, (ap * b1 + l0 * b2) % R,
                (sum(lh[i] * v for i, v in zip(hidden, bl)) + ld * bd
                 + l0 * bs) % R]
        rows.append((m, e, s_, r1, r2, b1, b2, bd, bs, bl, logs))
    pts = known_log_points(G1, [lg, l0] + lh
                           + [v for row in rows for v in row[-1]], dev)
    params = SignatureParamsG1(g1=pts[0], g2=G2.mul_raw(l2).normalize(),
                               h_0=pts[1], h=pts[2:2 + POK_MSGS])
    pk = PublicKeyG2(w=G2.mul_raw(l2 * x % R).normalize())
    sk = SecretKey(Fr(x))
    log_of = {}
    algebra = []                     # (proof, revealed, challenge)
    for k, (m, e, s_, r1, r2, b1, b2, bd, bs, bl, logs) in enumerate(rows):
        five = pts[2 + POK_MSGS + 5 * k:2 + POK_MSGS + 5 * (k + 1)]
        log_of.update(((p.X, p.Y), lv) for p, lv in zip(five[:2], logs[:2]))
        revealed = {i: Fr(m[i]) for i in range(POK_REVEALED)}
        w = ByteWriter()
        compute_challenge_contribution(*five, revealed, params, w)
        c = int(compute_random_oracle_challenge(Fr, w.bytes()))
        r3 = inv(r1)
        sp = (s_ - r2 * r3) % R
        resp2 = [(v + m[i] * c) % R for i, v in zip(hidden, bl)] \
            + [(bd - r3 * c) % R, (bs + sp * c) % R]
        proof = PoKOfSignatureG1Proof(
            A_prime=five[0], A_bar=five[1], d=five[2],
            sc_resp_1=PokPedersenCommitment(five[3], Fr((b1 - e * c) % R),
                                            Fr((b2 + r2 * c) % R)),
            T2=five[4], sc_resp_2=SchnorrResponse([Fr(v) for v in resp2]))
        algebra.append((proof, revealed, Fr(c)))
    other_key = algebra.pop()
    t_build = time.perf_counter() - t0

    # ---- POK_PROTOCOL proofs through the port's own protocol
    prng = random.Random(SEED + 201)
    made, signed, secs = [], [], {"sign_s": [], "prove_s": [],
                                  "host_verify_s": []}
    for _ in range(POK_PROTOCOL):
        msgs = [Fr.rand(prng) for _ in range(POK_MSGS)]
        t = time.perf_counter()
        sig = SignatureG1.new(prng, msgs, sk, params)
        secs["sign_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        mabs = [MessageOrBlinding.reveal_message(v) if i < POK_REVEALED
                else MessageOrBlinding.blind_randomly(v)
                for i, v in enumerate(msgs)]
        prot = PoKOfSignatureG1Protocol.init(prng, sig, params, mabs)
        revealed = {i: msgs[i] for i in range(POK_REVEALED)}
        w = ByteWriter()
        prot.challenge_contribution(revealed, params, w)
        ch = compute_random_oracle_challenge(Fr, w.bytes())
        proof = prot.gen_proof(ch)
        secs["prove_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        proof.verify(revealed, ch, pk, params)
        secs["host_verify_s"].append(time.perf_counter() - t)
        made.append((proof, revealed, ch))
        signed.append((sig, msgs))
    for proof, revealed, ch in algebra[:2]:
        proof.verify(revealed, ch, pk, params)
    valid = made + algebra
    # the spoiled sets: the first POK_SPOILED_N proofs with one response
    # spoiled, and all POK_N with one under another key
    spoiled_resp = list(valid[:POK_SPOILED_N])
    spoiled_key = list(valid)
    k = POK_SPOILED_N // 3
    pr, rev, ch = valid[k]
    resp = list(pr.sc_resp_2.responses)
    resp[0] = resp[0] + Fr(1)
    spoiled_resp[k] = (PoKOfSignatureG1Proof(
        pr.A_prime, pr.A_bar, pr.d, pr.sc_resp_1, pr.T2,
        SchnorrResponse(resp)), rev, ch)
    spoiled_key[2 * POK_N // 3] = other_key

    # ---- the batch verify: both MSMs held to their known logs in the
    # cold run (the protocol-made proofs' terms on the host); the warm run
    # split into device MSMs, pairing and host work
    widths, safe_widths = [], []
    sink = [widths, safe_widths]
    real_msm, real_vmsm, real_pair = (batch.msm_device_scheduled,
                                      batch._msm, batch._multi_pairing)
    spent = {"device_msm_s": 0.0, "pairing_s": 0.0, "pairings": 0,
             "lanes": 0}

    def checked_msm(curve, points, scalars, device):
        tm = {}
        out = real_msm(curve, points, scalars, device=device, timings=tm)
        sink[0].extend(tm["level_pairs"])
        sink[1].extend(rerun_widths(tm))
        want, extra = 0, bls.G1.infinity()
        for s_, p in zip(scalars, points):
            if (p.X, p.Y) in log_of:
                want += s_ * log_of[(p.X, p.Y)]
            else:
                extra = extra + p.mul_raw(s_)
        if out != G1.mul_raw(want % R) + extra:
            raise AssertionError("bbs pok batch verify: an MSM differs from "
                                 "its known logs")
        return out

    def timed_msm(points, scalars, device):
        t = time.perf_counter()
        out = real_vmsm(points, scalars, device)
        spent["device_msm_s"] += time.perf_counter() - t
        return out

    def timed_pair(pairs, device):
        t = time.perf_counter()
        out = real_pair(pairs, device)
        spent["pairing_s"] += time.perf_counter() - t
        spent["pairings"] += 1
        spent["lanes"] = max(spent["lanes"], len(pairs))
        return out

    def verify(items, seed):
        proofs, revealed, chs = (list(v) for v in zip(*items))
        return batch.batch_verify_proofs(proofs, revealed, chs, pk, params,
                                         random.Random(seed), device=dev)

    env = os.environ.get(PAIRING_ENV)
    os.environ[PAIRING_ENV] = "device"
    try:
        batch.msm_device_scheduled = checked_msm
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_cold, launches = drive(counted,
                                      lambda: verify(valid, SEED + 202))
            t_cold = time.perf_counter() - t
        finally:
            batch.msm_device_scheduled = real_msm
        batch._msm, batch._multi_pairing = timed_msm, timed_pair
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok_warm = verify(valid, SEED + 203)
            t_warm = time.perf_counter() - t
            split = dict(spent)
            spent["pairings"] = 0
            t = time.perf_counter()
            ok_resp = verify(spoiled_resp, SEED + 204)
            pairings_resp = spent["pairings"]
            key_widths, key_safe = sink[:] = [], []
            batch.msm_device_scheduled = checked_msm
            ok_key, key_launches = drive(
                counted, lambda: verify(spoiled_key, SEED + 205))
            pairings_key = spent["pairings"] - pairings_resp
            t_spoiled = time.perf_counter() - t
        finally:
            batch.msm_device_scheduled = real_msm
            batch._msm, batch._multi_pairing = real_vmsm, real_pair
    finally:
        if env is None:
            os.environ.pop(PAIRING_ENV)
        else:
            os.environ[PAIRING_ENV] = env
    if not (ok_cold and ok_warm) or ok_resp or ok_key \
            or (pairings_resp, pairings_key) != (0, 1):
        raise AssertionError(
            f"bbs pok batch verify: valid {ok_cold}/{ok_warm}, spoiled "
            f"response {ok_resp} ({pairings_resp} pairings), other key "
            f"{ok_key} ({pairings_key} pairings)")
    require("bbs_pok_batch_verify_256", launches, set(PAIRING_KERNELS)
            | level_kernels(widths, safe_widths, msm_v2.CHUNK_MIN_PAIRS))
    require("bbs_pok_batch_verify_256 other key", key_launches,
            set(PAIRING_KERNELS) | level_kernels(key_widths, key_safe,
                                                 msm_v2.CHUNK_MIN_PAIRS))
    paths["bbs_pok_batch_verify_256"] = launches
    host_s = t_warm - split["device_msm_s"] - split["pairing_s"]
    phase("bbs_pok_batch_verify_256", proofs=POK_N, messages=POK_MSGS,
          revealed=POK_REVEALED, bbs_plus_pok_batch_verify_256_wall_s=t_warm,
          cold_s=t_cold, host_checker_s=host_s,
          device_msm_s=split["device_msm_s"], pairing_s=split["pairing_s"],
          proofs_per_s=POK_N / t_warm, build_s=t_build,
          spoiled_sets_s=t_spoiled,
          **{k: statistics.mean(v) for k, v in secs.items()},
          msm_level_pairs=widths, rerun_level_pairs=safe_widths,
          launches={k: v for k, v in launches.items() if v}, valid=True,
          spoiled_response_rejected=True, other_key_rejected=True,
          other_key_proofs=POK_N, other_key_level_pairs=key_widths,
          other_key_launches={k: v for k, v in key_launches.items() if v},
          correct=True)

    # ---- bbs_pok_checker_16: PoKs, signatures and BBS23 PoKs through one
    # lazy checker, its Miller product on the device
    params23 = bbs23.SignatureParams23G1(g1=params.g1, g2=params.g2,
                                         h=params.h)
    pk23 = bbs23.PublicKey23G2(w=pk.w)
    poks23 = []
    for _ in range(CHECKER_23):
        msgs = [Fr.rand(prng) for _ in range(POK_MSGS)]
        sig = bbs23.Signature23G1.new(prng, msgs, sk, params23)
        prot = bbs23.PoKOfSignature23G1Protocol.init(
            prng, sig, params23, msgs, set(range(POK_REVEALED)))
        revealed = {i: msgs[i] for i in range(POK_REVEALED)}
        w = ByteWriter()
        prot.challenge_contribution(revealed, params23, w)
        ch = compute_random_oracle_challenge(Fr, w.bytes())
        poks23.append((prot.gen_proof(ch), revealed, ch))
    weight = Fr(hr.randrange(1, R))
    env = os.environ.pop(PAIRING_ENV, None)

    def checker(spoil: bool):
        c = RandomizedPairingChecker(weight, lazy=True, device=dev)
        for proof, revealed, ch in valid[:CHECKER_POKS]:
            proof.verify_with_randomized_pairing_checker(revealed, ch, pk,
                                                         params, c)
        for k, (sig, msgs) in enumerate(signed[:CHECKER_SIGS]):
            if spoil and k == 1:
                sig = SignatureG1(A=sig.A, e=sig.e + Fr(1), s=sig.s)
            sig.verify_with_pairing_checker(msgs, pk, params, c)
        for proof, revealed, ch in poks23:
            if not proof.verify(revealed, ch, pk23, params23,
                                pairing_checker=c):
                raise AssertionError("bbs_pok_checker_16: a BBS23 PoK's "
                                     "Schnorr legs failed")
        return c

    try:
        t = time.perf_counter()
        good = checker(False)
        t_add = time.perf_counter() - t
        t = time.perf_counter()
        ok, chk_launches = drive(counted, good.verify)
        t_chk = time.perf_counter() - t
        rejected = not checker(True).verify()
    finally:
        if env is not None:
            os.environ[PAIRING_ENV] = env
    npairs = 2 * (CHECKER_POKS + CHECKER_SIGS + CHECKER_23)
    if len(good.pending) != npairs or not ok or not rejected:
        raise AssertionError(f"bbs_pok_checker_16: {len(good.pending)} "
                             f"pairs, valid {ok}, spoiled rejected "
                             f"{rejected}")
    require("bbs_pok_checker_16", chk_launches, CHECKER_KERNELS)
    paths["bbs_pok_checker_16"] = chk_launches
    phase("bbs_pok_checker_16", poks=CHECKER_POKS, signatures=CHECKER_SIGS,
          bbs23_poks=CHECKER_23, deferred_pairs=len(good.pending),
          host_adds_s=t_add, verify_s=t_chk, valid=ok,
          spoiled_rejected=rejected,
          launches={k: chk_launches[k] for k in PAIRING_KERNELS},
          correct=True)
    return paths, widths, {"bbs_pok_batch_verify_256": split["lanes"],
                           "bbs_pok_checker_16": len(good.pending)}


SAVER_CB = 8                        # BASELINE config 4: 8-bit chunks (32)
SAVER_MSGS = 8                      # ... of 8 BBS+-signed messages
SAVER_DECRYPTS = 2                  # messages decrypted on the card, timed
SAVER_VERIFY_DECRYPTION = 1         # decryptions whose proof is verified
AGG_N = 8                           # proofs a SnarkPack aggregate folds
ROUTE_KERNELS = ("mont_mul", "mont_pow", "fq2_mul", "fq2_sqr")


def saver_aggregate_phases(counted, dev) -> tuple:
    """BASELINE config 4 and SnarkPack on the card, each phase with the
    launch counts reset before it and read after:

    * `saver_config4`: a BBS+ signature over `SAVER_MSGS` messages; a SAVER
      CRS at `SAVER_CB`-bit chunks (32 chunks), keys, `encrypt_with_proof`
      of every signed message (the port's prover: the witness map's NTTs
      on the card), both ciphertext checks of each, `decrypt` of the
      first `SAVER_DECRYPTS` on the card through the batched
      multi-pairing (every chunk's product and base in one call, timed,
      each message equal to the signed one), `verify_decryption` of
      `SAVER_VERIFY_DECRYPTION`, a changed chunk and a wrong message
      rejected;
    * `saver_aggregate_8`: the 8 SAVER proofs aggregated by SnarkPack
      without D (as the proof system aggregates Groth16 proofs), the
      prover split into its pairing calls, MSMs and host work; verified
      with `prepared_inputs` from the ciphertexts; a changed ciphertext
      and a wrong transcript label rejected;
    * `legogroth16_aggregate_8`: 8 bound-check LegoGroth16 proofs,
      aggregated with D folded and verified, both under
      `CRYPTO_TPU_PAIRING_BACKEND=device`: the prover's commitments and
      each GIPA round's products go to the card as batched calls, the
      verifier's checker too; wrong public inputs rejected.

    The first two phases take the router's own choice.  At n = 8 it keeps
    the prover's calls on the host (a batched call costs more than their
    host loop), so `saver_aggregate_8`'s device route is the verifier's
    checker (its Miller product of more than 8 pairs on the card; the
    final exponentiation stays on the host, as in the reference, so
    `mont_pow` does not launch there).

    Each phase requires a call of `TPairing.multi_pairings` (the batched
    device route; its four kernels) or, for `saver_aggregate_8`, of
    `TPairing.miller_product` (the checker's; its three);
    `legogroth16_aggregate_8` requires a batched call.  Returns ({path:
    launches}, {path: its launches' arguments, as `capture_launches`
    keeps them}, the SAVER CRS, generators and keys and the bound-check
    key, for `proof_system_phase`)."""
    import os

    from crypto_tpu_torch.bbs_plus.setup import KeypairG2, SignatureParamsG1
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import tpairing
    from crypto_tpu_torch.legogroth16 import aggregation as agg
    from crypto_tpu_torch.legogroth16 import bound_check, snark
    from crypto_tpu_torch.saver import core as saver
    from crypto_tpu_torch.transcript.transcript import Transcript
    Fr = bls.Fr
    hr = random.Random(SEED + 300)
    paths, captured, keep = {}, {}, {}
    batches = []                       # (path, groups k, lanes k m)
    real_batch = tpairing.TPairing.multi_pairings
    real_miller = tpairing.TPairing.miller_product
    path_now = [None]

    def spy(self, groups):
        m = max(1, max(len(g) for g in groups))
        batches.append((path_now[0], len(groups), m * len(groups)))
        return real_batch(self, groups)

    def miller_spy(self, pairs):
        batches.append((path_now[0], 0, len(pairs)))
        return real_miller(self, pairs)

    env = os.environ.pop(PAIRING_ENV, None)
    tpairing.TPairing.multi_pairings = spy
    tpairing.TPairing.miller_product = miller_spy
    try:
        def run(path, fn, need_batch=False):
            path_now[0] = path
            (out, seen), launches = drive(
                counted, lambda: capture_launches(counted, fn))
            batched = any(b[0] == path and b[1] for b in batches)
            require(path, launches, ROUTE_KERNELS if batched
                    else CHECKER_KERNELS)
            if not any(b[0] == path for b in batches):
                raise AssertionError(f"{path}: no pairing took the device "
                                     f"route")
            if need_batch and not batched:
                raise AssertionError(f"{path}: no batched multi-pairing "
                                     f"call")
            paths[path] = launches
            captured[path] = seen
            return out

        # ---- saver_config4 ---------------------------------------------
        def config4():
            t = {}
            t0 = time.perf_counter()
            params = SignatureParamsG1.generate_using_rng(hr, SAVER_MSGS)
            kp = KeypairG2.generate(hr, params)
            msgs = [Fr.rand(hr) for _ in range(SAVER_MSGS)]
            sig = SignatureG1.new(hr, msgs, kp.secret_key, params)
            sig.verify(msgs, kp.public_key, params)
            t["sign_verify_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gens = saver.EncryptionGens.new(b"chip-smoke saver config 4")
            spk = saver.generate_srs(SAVER_CB, gens, hr, device=dev)
            g_i = saver.get_gs_for_encryption(spk.pk.vk)
            t["srs_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            sk, ek, dk = saver.keygen(hr, SAVER_CB, gens, g_i,
                                      spk.pk.delta_g1, spk.gamma_g1)
            t["keygen_s"] = time.perf_counter() - t0
            cts, t["encrypt_with_proof_s"] = [], []
            for m in msgs:
                t0 = time.perf_counter()
                cts.append(saver.encrypt_with_proof(hr, m, ek, spk, SAVER_CB,
                                                    device=dev))
                t["encrypt_with_proof_s"].append(time.perf_counter() - t0)
            pvk = snark.PreparedVerifyingKey.from_vk(spk.pk.vk)
            t0 = time.perf_counter()
            for ct, _, proof in cts:
                if not (saver.verify_ciphertext_commitment(ct, ek, gens,
                                                           device=dev)
                        and saver.verify_ciphertext_proof(ct, proof, pvk,
                                                          device=dev)):
                    raise AssertionError("saver_config4: a ciphertext "
                                         "check failed")
            t["ciphertext_checks_s"] = time.perf_counter() - t0
            decs, t["decrypt_s"] = [], []
            for (ct, _, _), m in list(zip(cts, msgs))[:SAVER_DECRYPTS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dec = saver.decrypt(ct, sk, dk, g_i, SAVER_CB, device=dev)
                t["decrypt_s"].append(time.perf_counter() - t0)
                if dec[0] != m or dec[1] != ct.X_r.mul_raw(int(sk.rho)):
                    raise AssertionError("saver_config4: a decryption "
                                         "differs from the signed message")
                decs.append(dec)
            t0 = time.perf_counter()
            for (ct, _, _), (m, nu) in list(zip(cts, decs))[
                    :SAVER_VERIFY_DECRYPTION]:
                if not saver.verify_decryption(ct, m, nu, dk, g_i, gens,
                                               SAVER_CB, device=dev):
                    raise AssertionError("saver_config4: a decryption's "
                                         "verification failed")
            t["verify_decryption_s"] = (time.perf_counter() - t0) \
                / SAVER_VERIFY_DECRYPTION
            ct, _, proof = cts[0]
            bad = saver.Ciphertext(ct.X_r, [(ct.enc_chunks[0]
                                             + g_i[0]).normalize()]
                                   + ct.enc_chunks[1:], ct.commitment)
            if saver.verify_ciphertext_proof(bad, proof, pvk, device=dev) \
                    or saver.verify_decryption(ct, decs[0][0] + Fr(1),
                                               decs[0][1], dk, g_i, gens,
                                               SAVER_CB, device=dev):
                raise AssertionError("saver_config4: a changed chunk or a "
                                     "wrong message was accepted")
            keep.update(gens=gens, spk=spk, g_i=g_i, sk=sk, ek=ek, dk=dk)
            return t, spk, cts

        t, spk, cts = run("saver_config4", config4)
        calls = [b for b in batches if b[0] == "saver_config4"]
        phase("saver_config4", messages=SAVER_MSGS, chunk_bits=SAVER_CB,
              chunks=saver.chunks_count(SAVER_CB),
              saver_decrypt_wall_s=statistics.median(t["decrypt_s"]),
              **{k: v for k, v in t.items()},
              device_calls_groups_lanes=[b[1:] for b in calls],
              pairing_batch_threshold=tpairing.PAIRING_BATCH_THRESHOLD,
              launches={k: v for k, v in paths["saver_config4"].items()
                        if v},
              decrypted=True, spoiled_rejected=True, correct=True)

        # ---- saver_aggregate_8 on the router's own choice: at n = 8 it
        # keeps every prover call on the host (each call's weight stays
        # under the threshold), and the device route is the verifier's
        # checker
        t0 = time.perf_counter()
        srs = agg.GenericSRS.setup(hr, AGG_N)
        p_srs, v_srs = srs.specialize(AGG_N)
        t_srs = time.perf_counter() - t0
        vk = spk.pk.vk

        def prepared(ct):
            d = ct.X_r
            for c in ct.enc_chunks:
                d = d + c
            return (d + vk.gamma_abc_g1[0]).normalize()

        def saver_agg():
            proofs = [snark.Proof(p.a, p.b, p.c, None) for _, _, p in cts]
            tm = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = agg.aggregate_proofs(p_srs, Transcript(b"saver-aggregate"),
                                     proofs, device=dev, timings=tm)
            tm["prove_s"] = time.perf_counter() - t0
            prep = [prepared(ct) for ct, _, _ in cts]

            def verify(prep, label=b"saver-aggregate"):
                return agg.verify_aggregate_proof(
                    v_srs, vk, [[] for _ in prep], a, hr, Transcript(label),
                    prepared_inputs=prep, device=dev)

            t0 = time.perf_counter()
            ok = verify(prep)
            tm["verify_s"] = time.perf_counter() - t0
            k = len(cts) // 2
            ct = cts[k][0]
            bad = list(prep)
            bad[k] = prepared(saver.Ciphertext(
                ct.X_r, ct.enc_chunks[:-1] + [(ct.enc_chunks[-1]
                                               + vk.gamma_abc_g1[-1])
                                              .normalize()], ct.commitment))
            if not ok or verify(bad) or verify(prep, b"another label"):
                raise AssertionError(f"saver_aggregate_8: valid {ok}, or a "
                                     f"spoiled aggregate accepted")
            return tm

        tm = run("saver_aggregate_8", saver_agg)
        phase("saver_aggregate_8", proofs=AGG_N, srs_s=t_srs,
              saver_aggregate_8_prove_wall_s=tm["prove_s"],
              pairing_s=tm["pairing_s"], msm_s=tm["msm_s"],
              host_s=tm["prove_s"] - tm["pairing_s"] - tm["msm_s"],
              pairing_calls_groups_pairs_route=tm["pairing_calls"],
              verify_s=tm["verify_s"],
              launches={k: v for k, v in paths["saver_aggregate_8"].items()
                        if v},
              valid=True, spoiled_rejected=True, correct=True)

        # ---- legogroth16_aggregate_8 -----------------------------------
        def lego_agg():
            tm = {}
            t0 = time.perf_counter()
            pk = bound_check.generate_snark_srs_bound_check(hr, device=dev)
            tm["setup_s"] = time.perf_counter() - t0
            keep["bound_pk"] = pk
            lo, hi = 18, 1 << 40
            t0 = time.perf_counter()
            proofs = [bound_check.prove_bound_check(
                pk, hr.randrange(lo, hi), lo, hi, hr, device=dev)[0]
                for _ in range(AGG_N)]
            tm["prove_s"] = (time.perf_counter() - t0) / AGG_N
            pub = [[Fr(lo), Fr(hi)] for _ in proofs]

            def verify(pub):
                return agg.verify_aggregate_proof(
                    v_srs, pk.vk, pub, a, hr, Transcript(b"lego-aggregate"),
                    device=dev)

            os.environ[PAIRING_ENV] = "device"
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = agg.aggregate_proofs(p_srs,
                                         Transcript(b"lego-aggregate"),
                                         proofs, device=dev, timings=tm)
                tm["aggregate_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                ok = verify(pub)
                tm["verify_s"] = time.perf_counter() - t0
                bad = [list(p) for p in pub]
                bad[-1][0] = bad[-1][0] + Fr(1)
                spoiled = verify(bad)
            finally:
                os.environ.pop(PAIRING_ENV)
            if not ok or spoiled:
                raise AssertionError(f"legogroth16_aggregate_8: valid {ok}, "
                                     f"or wrong public inputs accepted")
            return tm

        tm = run("legogroth16_aggregate_8", lego_agg, need_batch=True)
        calls = [b for b in batches if b[0] == "legogroth16_aggregate_8"]
        phase("legogroth16_aggregate_8", proofs=AGG_N,
              pairing_backend="device",
              device_calls_groups_lanes=[b[1:] for b in calls],
              bound_check_setup_s=tm["setup_s"],
              bound_check_prove_s=tm["prove_s"],
              legogroth16_aggregate_8_prove_wall_s=tm["aggregate_s"],
              pairing_s=tm["pairing_s"], msm_s=tm["msm_s"],
              host_s=tm["aggregate_s"] - tm["pairing_s"] - tm["msm_s"],
              pairing_calls_groups_pairs_route=tm["pairing_calls"],
              verify_s=tm["verify_s"],
              launches={k: v for k, v in
                        paths["legogroth16_aggregate_8"].items() if v},
              valid=True, spoiled_rejected=True, correct=True)
    finally:
        tpairing.TPairing.multi_pairings = real_batch
        tpairing.TPairing.miller_product = real_miller
        if env is not None:
            os.environ[PAIRING_ENV] = env
    return paths, captured, keep


NELEM = 1 << 14                     # benches/bench_accumulator.py NELEM
NMEMBERS = NELEM // 2               # the members whose witnesses update
NBATCH = 256                        # the bench's additions
NCHECK_HOST = 16                    # members held to the port's host branch
# what a witness update on the card launches: mont_mul (the scans, the
# double-and-add, the final add, to_affine; batch_inv_t's tree) and
# mont_pow (to_affine's Fq root; batch_inv_t's Fr root with removals)
ACCUM_KERNELS = ("mont_mul", "mont_pow")


def timed_update(counted, seen: dict, fn, capture: bool = False):
    """fn(), a witness update that reaches
    `device_update.batch_update_with_sk_device`, with the launch counts
    reset just before it and read just after, and the device function
    shimmed to keep its `timings=` split and its d factors in `seen`;
    with `capture`, under `capture_launches`.  Returns (fn()'s result,
    the launches, the seconds, the captured launches or None)."""
    from crypto_tpu_torch.accumulator import device_update
    real = device_update.batch_update_with_sk_device

    def shim(*a, **kw):
        tm = {}
        out = real(*a, **kw, timings=tm)
        seen.update(timings=tm, d=out[0])
        return out

    device_update.batch_update_with_sk_device = shim
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        if capture:
            (out, captured), launches = drive(
                counted, lambda: capture_launches(counted, fn))
        else:
            (out, launches), captured = drive(counted, fn), None
        return out, launches, time.perf_counter() - t, captured
    finally:
        device_update.batch_update_with_sk_device = real


def check_update(where, dev, sk, members, wits, V_old, adds, rems,
                 new_value, new_wits, d, verify) -> dict:
    """A witness update of `members` (old witnesses `wits` under V_old,
    the batch as the updated accumulator sees it: `adds`, `rems`) held
    to an independent result: every d factor to d_A(y) / d_D(y) in plain
    host integers, every new witness to new_value / (y + alpha) by a host
    batch inverse and the device fixed-base table (not scalar_mul),
    `NCHECK_HOST` members to the port's host branch (below 512 members),
    the first and the last member by `verify(member, witness)`, a pairing
    check.  Returns the checks' seconds."""
    from crypto_tpu_torch.accumulator import witness
    from crypto_tpu_torch.accumulator.batch_utils import _batch_inverse
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.utils.msm import \
        multiply_field_elems_with_same_group_elem
    F, R = bls.Fr, bls.R
    n = len(members)
    ys, alpha = [int(y) for y in members], int(sk.alpha)
    t0 = time.perf_counter()
    num = [1] * n
    den = [1] * n
    for i, y in enumerate(ys):
        for a in adds:
            num[i] = num[i] * (int(a) - y) % R
        for r in rems:
            den[i] = den[i] * (int(r) - y) % R
    want_d = [n_ * pow(d_, -1, R) % R for n_, d_ in zip(num, den)]
    if [int(x) for x in d] != want_d:
        raise AssertionError(f"{where}: a d factor differs from the host "
                             f"product")
    invs = _batch_inverse([F(y + alpha) for y in ys])
    want = multiply_field_elems_with_same_group_elem(new_value, invs,
                                                     device=dev)
    got = [None if c.is_infinity() else (int(c.X), int(c.Y))
           for c in (w.C.normalize() for w in new_wits)]
    exp = [None if p.is_infinity() else tuple(int(c) for c in p.to_affine())
           for p in want]
    if got != exp:
        raise AssertionError(f"{where}: a witness differs from V_new / "
                             f"(y + alpha)")
    t1 = time.perf_counter()
    hd, hc = witness._batch_update_with_sk(
        adds, rems, members[:NCHECK_HOST],
        [w.C for w in wits[:NCHECK_HOST]], V_old, sk, device=dev)
    if [int(x) for x in hd] != want_d[:NCHECK_HOST] or \
            hc != [w.C for w in new_wits[:NCHECK_HOST]]:
        raise AssertionError(f"{where}: the host branch differs")
    t2 = time.perf_counter()
    if not all(verify(members[i], new_wits[i]) for i in (0, n - 1)):
        raise AssertionError(f"{where}: a witness fails its pairing check")
    return dict(check_table_s=t1 - t0, check_host_branch_s=t2 - t1,
                check_pairing_s=time.perf_counter() - t2)


def accumulator_phases(counted, dev) -> tuple:
    """The VB accumulator at `benches/bench_accumulator.py`'s size: the
    setup (params hashed from a label, a key from a fixed seed, 2^14
    elements added, the first 8,192 members' witnesses on the device
    fixed-base path, two pairing checks), then two updates of all 8,192
    witnesses through `update_membership_batch_with_sk` on the card: (a)
    256 additions, the bench's workload; (b) 256 removals
    of non-members (128 additions with 128 removals run on both halves of
    the KB universal accumulator, `accumulator_kb_universal_phase`).  Each
    update is held to an independent result (`check_update`).  Returns
    ({path: launches}, the params, the keys, the 2^14 elements, the
    accumulator before the updates and its first member and witness, for
    `proof_system_phase` and `accumulator_kb_universal_phase`)."""
    import os

    from crypto_tpu_torch.accumulator import witness
    from crypto_tpu_torch.accumulator.core import PositiveAccumulator
    from crypto_tpu_torch.accumulator.persistence import InMemoryState
    from crypto_tpu_torch.accumulator.setup import AccumKeypair, \
        AccumSetupParams
    from crypto_tpu_torch.curves import bls12_381 as bls
    F = bls.Fr
    rng = random.Random(SEED + 200)
    paths = {}
    # the routing held here is the reference's rule, with no override
    for k in ("CRYPTO_TPU_FORCE_DEVICE_ACCUM", "CRYPTO_TPU_NO_DEVICE_ACCUM"):
        os.environ.pop(k, None)

    # ---- accumulator_setup
    secs = {}
    t = time.perf_counter()
    params = AccumSetupParams.new(b"bench-accum")
    secs["params_s"] = time.perf_counter() - t
    t = time.perf_counter()
    kp = AccumKeypair.generate(rng, params)
    sk, pk = kp.secret_key, kp.public_key
    secs["keypair_s"] = time.perf_counter() - t
    state = InMemoryState()
    elems = [F.rand(rng) for _ in range(NELEM)]
    t = time.perf_counter()
    acc = PositiveAccumulator.initialize(params).add_batch(elems, sk, state)
    secs["add_batch_s"] = time.perf_counter() - t
    members = elems[:NMEMBERS]
    torch.cuda.synchronize()
    t = time.perf_counter()
    wits, wit_launches = drive(counted, lambda: acc.
                               get_membership_witnesses_for_batch(
                                   members, sk, state, device=dev))
    secs["witnesses_s"] = time.perf_counter() - t
    require("accumulator witnesses", wit_launches, ("mont_mul",))
    t = time.perf_counter()
    if not all(acc.verify_membership(members[i], wits[i], pk, params)
               for i in (0, NMEMBERS - 1)):
        raise AssertionError("accumulator_setup: a witness fails its "
                             "pairing check")
    secs["verify_s"] = time.perf_counter() - t
    paths["accumulator_witnesses"] = wit_launches
    phase("accumulator_setup", elements=NELEM, members=NMEMBERS, **secs,
          vb_accum_witness_gen_8192_wall_s=secs["witnesses_s"],
          witnesses_per_s=NMEMBERS / secs["witnesses_s"],
          launches={k: v for k, v in wit_launches.items() if v},
          correct=True)

    # ---- accumulator_update: two batches, each from the same V
    V0 = acc.value()
    fresh = [F.rand(rng) for _ in range(NBATCH)]
    cases = {
        "a": (fresh, [], acc.add_batch(fresh, sk, state)),
        "b": ([], elems[NMEMBERS:NMEMBERS + NBATCH],
              acc.remove_batch(elems[NMEMBERS:NMEMBERS + NBATCH], sk,
                               state)),
    }

    def update(adds, rems, seen: dict):
        out, launches, secs_, _ = timed_update(
            counted, seen, lambda: witness.update_membership_batch_with_sk(
                adds, rems, members, wits, V0, sk, device=dev))
        return out, launches, secs_

    def check(tag, adds, rems, new_acc, new_wits, d) -> dict:
        return check_update(
            f"accumulator_update ({tag})", dev, sk, members, wits, V0, adds,
            rems, new_acc.value(), new_wits, d,
            lambda m, w: new_acc.verify_membership(m, w, pk, params))

    def report(tag, seconds, seen, launches, checks, **kv):
        require(f"accumulator update ({tag})", launches, ACCUM_KERNELS)
        phase(f"accumulator_update_{tag}", members=NMEMBERS,
              additions=len(cases[tag][0]), removals=len(cases[tag][1]),
              seconds=seconds, updates_per_s=NMEMBERS / seconds,
              split_s=seen["timings"], **kv,
              launches={k: v for k, v in launches.items() if v}, **checks,
              correct=True)

    adds, rems, new_acc = cases["a"]
    seen = {}
    wits_a, launches_a, secs_a = update(adds, rems, seen)
    if "d" not in seen:
        raise AssertionError("accumulator update (a): 8,192 members did not "
                             "take the device path")
    checks = check("a", adds, rems, new_acc, wits_a, seen["d"])
    report("a", secs_a, seen, launches_a, checks,
           vb_accum_witness_update_8192_after_256_adds_wall_s=secs_a)
    paths["accumulator_update"] = launches_a
    adds, rems, new_acc = cases["b"]
    seen = {}
    new_wits, launches, secs_ = update(adds, rems, seen)
    checks = check("b", adds, rems, new_acc, new_wits, seen["d"])
    report("b", secs_, seen, launches, checks)
    paths["accumulator_update_b"] = launches
    return paths, dict(params=params, kp=kp, value=V0, member=members[0],
                       witness=wits[0], elements=elems)


# ---- the KB universal accumulator (`accumulator_kb_universal`)
NKB_BATCH = 128                     # a batch of 128 additions (non-members
                                    # that join) with 128 removals (members
                                    # that leave), on both halves
NKB_OMEGA = 8                       # holders a half updated through Omega


def accumulator_kb_universal_phase(counted, dev, acc_keep) -> tuple:
    """The KB universal accumulator at BASELINE config 3's scale, on the
    params, keys and 2^14 elements of `accumulator_phases` (no second
    setup): the domain is the 2^14 elements, the first 8,192 are added
    as members, then one `batch_updates` of `NKB_BATCH` additions drawn
    from the non-members with `NKB_BATCH` removals drawn from the
    members.  The tracked sets are the 8,064 members not removed and the
    8,064 non-members not added (so no tracked element is among its
    half's removals, whose d_D would be 0: ROADMAP Queue 3).  Their
    witnesses come from the KB batch methods on the device fixed-base
    path (`accumulator_kb_witnesses`), then each half updates through
    `kb_universal_witness.update_{mem,non_mem}_wits_on_batch_updates`:
    one device update a half (`accumulator_kb_update_{mem,non_mem}`),
    timed, split by phase, its launches counted and captured, the
    accumulator kernels required.  Each half is held to `check_update`
    (the non-member half with the roles of additions and removals
    swapped), and `NKB_OMEGA` holders a half update from the published
    `KBUniversalOmega` alone to the same witnesses.  Returns ({path:
    launches}, {path: captured launches}, what `proof_system_more_phase`
    needs: the updated accumulator, its keys and params, a tracked member
    and non-member with their new witnesses)."""
    from crypto_tpu_torch.accumulator import kb_universal_witness as kbw
    from crypto_tpu_torch.accumulator.kb_universal import \
        KBUniversalAccumulator
    from crypto_tpu_torch.accumulator.persistence import InMemoryState
    params, kp, elems = acc_keep["params"], acc_keep["kp"], \
        acc_keep["elements"]
    sk, pk = kp.secret_key, kp.public_key
    t = {}
    t0 = time.perf_counter()
    ms, ns = InMemoryState(), InMemoryState()
    kb = KBUniversalAccumulator.initialize(params, sk, elems, ms, ns)
    kb = kb.add_batch(elems[:NMEMBERS], sk, ms, ns)
    t["setup_s"] = time.perf_counter() - t0
    adds = elems[NMEMBERS:NMEMBERS + NKB_BATCH]
    rems = elems[:NKB_BATCH]
    members = elems[NKB_BATCH:NMEMBERS]
    non_members = elems[NMEMBERS + NKB_BATCH:]
    ids = {int(x) for x in members} | {int(x) for x in non_members}
    if ids & ({int(x) for x in adds} | {int(x) for x in rems}):
        raise AssertionError("accumulator_kb_universal: a tracked element "
                             "is in the batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (mem_wits, nm_wits), wit_launches = drive(counted, lambda: (
        kb.get_membership_witnesses_for_batch(members, sk, ms, device=dev),
        kb.get_non_membership_witnesses_for_batch(non_members, sk, ns,
                                                  device=dev)))
    t["witnesses_s"] = time.perf_counter() - t0
    require("KB witnesses", wit_launches, ("mont_mul",))
    if not (kb.verify_membership(members[0], mem_wits[0], pk, params)
            and kb.verify_non_membership(non_members[-1], nm_wits[-1], pk,
                                         params)):
        raise AssertionError("accumulator_kb_universal: a batch witness "
                             "fails its pairing check")
    paths = {"accumulator_kb_witnesses": wit_launches}
    captured = {}
    old_mem, old_nm = kb.mem_value(), kb.non_mem_value()
    t0 = time.perf_counter()
    omega = kbw.KBUniversalOmega.new(adds, rems, old_mem, old_nm, sk,
                                     device=dev)
    t["omega_s"] = time.perf_counter() - t0
    new_kb = kb.batch_updates(adds, rems, sk, ms, ns)
    halves = (
        ("mem", members, mem_wits, old_mem, new_kb.mem, adds, rems,
         omega.mem, kbw.update_mem_wits_on_batch_updates,
         kbw.update_mem_wit_using_public_info),
        ("non_mem", non_members, nm_wits, old_nm, new_kb.non_mem, rems, adds,
         omega.non_mem, kbw.update_non_mem_wits_on_batch_updates,
         kbw.update_non_mem_wit_using_public_info))
    new = {}
    for (tag, tracked, wits, V_old, half, h_adds, h_rems, om, update,
         public) in halves:
        path = f"accumulator_kb_update_{tag}"
        seen = {}
        new_wits, launches, secs, cap = timed_update(
            counted, seen, lambda: update(adds, rems, tracked, wits, V_old,
                                          sk, device=dev), capture=True)
        if "d" not in seen:
            raise AssertionError(f"{path}: 8,064 witnesses did not take the "
                                 f"device path")
        require(path, launches, ACCUM_KERNELS)
        checks = check_update(path, dev, sk, tracked, wits, V_old, h_adds,
                              h_rems, half.value(), new_wits, seen["d"],
                              lambda m, w: half.verify_membership(
                                  m, w, pk, params))
        t0 = time.perf_counter()
        held = [public(w, y, adds, rems, om) for y, w in
                zip(tracked[:NKB_OMEGA], wits[:NKB_OMEGA])]
        if [w.C for w in held] != [w.C for w in new_wits[:NKB_OMEGA]]:
            raise AssertionError(f"{path}: a holder's Omega update differs")
        checks["check_omega_s"] = time.perf_counter() - t0
        paths[path] = launches
        captured[path] = cap
        new[tag] = new_wits
        phase(path, tracked=len(tracked), additions=len(h_adds),
              removals=len(h_rems), seconds=secs,
              updates_per_s=len(tracked) / secs, split_s=seen["timings"],
              launches={k: v for k, v in launches.items() if v},
              omega_holders=NKB_OMEGA, **checks, correct=True)
    phase("accumulator_kb_universal", domain=NELEM, members=NMEMBERS,
          tracked=[len(members), len(non_members)],
          batch=[NKB_BATCH, NKB_BATCH], **t,
          witness_launches={k: v for k, v in wit_launches.items() if v},
          correct=True)
    return paths, captured, dict(
        params=params, kp=kp, kb=new_kb, member=members[0],
        mem_wit=new["mem"][0], non_member=non_members[0],
        nm_wit=new["non_mem"][0])


PS_MSGS = 32                        # BASELINE config 2's credential: 32
PS_REVEALED = 4                     # messages, 4 of them revealed
PS_AGE = (18, 128)                  # the bound check's [min, max)
PS_NONCE = b"chip-smoke composite nonce"


def proof_system_phase(counted, dev, saver_keep, acc_keep) -> tuple:
    """The composite proof system on the card (`proof_system_composite`):
    one `ProofSpec` of six statements, a BBS+ credential over `PS_MSGS`
    messages (`PS_REVEALED` revealed; message 0 the user id, message 1 the
    age), VB membership (CDH) of the user id in the accumulator of
    `accumulator_phases` (its value before the updates, its first member
    and witness), the original VB membership statement on the same, a
    Pedersen commitment to the user id, SAVER encryption of it at
    `SAVER_CB`-bit chunks under `saver_config4`'s CRS and keys, and a
    LegoGroth16 bound check of the age in `PS_AGE` under
    `legogroth16_aggregate_8`'s key; the user id linked across the first
    five statements, the age across the credential and the bound check.

    Each path below runs with the launch counts reset before it and read
    after, and `capture_launches` keeping its launches: `Proof.new`
    (`proof_system_prove`: the SNARK provers' witness maps on the card;
    their MSMs on the card only from `legogroth16/snark.py`'s threshold,
    and whether one did is reported), `Proof.verify` with no checker,
    with the lazy `RandomizedPairingChecker` (`proof_system_verify_lazy`:
    more than the checker's `DEVICE_THRESHOLD` deferred pairs, so one
    device Miller product, and mont_mul, fq2_mul and fq2_sqr must launch)
    and with the eager one, each timed; the auditor's decryption of the
    statement's ciphertext on the card (`proof_system_decrypt`, one
    batched multi-pairing), equal to the user id.  A wrong nonce, a
    broken witness equality (a Pedersen commitment to another value), a
    changed SAVER ciphertext and an age out of range at prove time are
    rejected.  The pairing backend variable is unset: the router and the
    checker take their own choice.  Returns ({path: launches}, {path: its
    captured launches})."""
    import copy
    import os

    from crypto_tpu_torch.accumulator import proofs_original as po
    from crypto_tpu_torch.bbs_plus.setup import KeypairG2, SignatureParamsG1
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import tpairing
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.proof_system import statements as st
    from crypto_tpu_torch.proof_system import statements_accum_original \
        as sao
    from crypto_tpu_torch.proof_system import statements_snark as ss
    from crypto_tpu_torch.proof_system.base import ProofSpec, \
        ProofSystemError
    from crypto_tpu_torch.proof_system.proof import Proof, VerifierConfig
    from crypto_tpu_torch.saver import core as saver
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    Fr = bls.Fr
    hr = random.Random(SEED + 500)
    k = saver_keep
    params, kp = acc_keep["params"], acc_keep["kp"]
    uid, V, wit = acc_keep["member"], acc_keep["value"], acc_keep["witness"]
    t = {}
    t0 = time.perf_counter()
    sig_params = SignatureParamsG1.generate_using_rng(hr, PS_MSGS)
    issuer = KeypairG2.generate(hr, sig_params)
    age = Fr(hr.randrange(*PS_AGE))
    msgs = [uid, age] + [Fr.rand(hr) for _ in range(PS_MSGS - 2)]
    sig = SignatureG1.new(hr, msgs, issuer.secret_key, sig_params)
    comm_G, comm_H, ped_G, ped_H = (bls.G1.rand(hr).normalize()
                                    for _ in range(4))
    blinding = Fr.rand(hr)
    prk = po.MembershipProvingKey.new(b"chip-smoke composite")
    revealed = {i: msgs[i] for i in range(PS_MSGS - PS_REVEALED, PS_MSGS)}
    t["setup_s"] = time.perf_counter() - t0

    def spec_of(value=uid, snarks=True):
        """The spec, its Pedersen commitment to `value`; without `snarks`
        the first four statements only."""
        spec = ProofSpec(context=b"chip-smoke composite")
        s_bbs = spec.add_statement(st.PoKBBSSignatureG1(
            params=sig_params, public_key=issuer.public_key,
            revealed_messages=revealed))
        linked = [(s_bbs, 0), (spec.add_statement(
            st.VBAccumulatorMembershipCDH(
                accumulator_value=V, params=params,
                public_key=kp.public_key)), 0),
            (spec.add_statement(sao.VBAccumulatorMembership(
                accumulator_value=V, params=params,
                public_key=kp.public_key, proving_key=prk)), 0),
            (spec.add_statement(st.PedersenCommitmentStmt(
                bases=[ped_G, ped_H], commitment=(
                    ped_G * int(value)
                    + ped_H * int(blinding)).normalize())), 0)]
        if snarks:
            linked.append((spec.add_statement(ss.SaverStatement(
                chunk_bit_size=SAVER_CB, enc_gens=k["gens"], ek=k["ek"],
                snark_pk=k["spk"], comm_G=comm_G, comm_H=comm_H)), 0))
            s_age = spec.add_statement(ss.BoundCheckLegoGroth16(
                min_val=PS_AGE[0], max_val=PS_AGE[1],
                snark_pk=k["bound_pk"]))
            spec.add_witness_equality([(s_bbs, 1), (s_age, 0)])
        spec.add_witness_equality(linked)
        return spec

    def wits_of(value=uid, snarks=True):
        return [st.BBSWitness(signature=sig, messages=msgs),
                st.AccumMembershipWit(element=uid, witness=wit),
                st.AccumMembershipWit(element=uid, witness=wit),
                [value, blinding]] + ([uid, age] if snarks else [])

    spec = spec_of()
    paths, captured = {}, {}
    miller, device_msms = [], []
    real_miller = tpairing.TPairing.miller_product
    real_msm = snark.msm_device_scheduled

    def miller_spy(self, pairs):
        miller.append((path_now[0], len(pairs)))
        return real_miller(self, pairs)

    def msm_spy(curve, points, scalars, **kw):
        device_msms.append((path_now[0], len(scalars)))
        return real_msm(curve, points, scalars, **kw)

    path_now = [None]

    def run(path, fn, need=()):
        path_now[0] = path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, seen), launches = drive(
            counted, lambda: capture_launches(counted, fn))
        torch.cuda.synchronize()
        t[path + "_s"] = time.perf_counter() - t0
        require(path, launches, need)
        paths[path] = launches
        captured[path] = seen
        return out

    env = os.environ.pop(PAIRING_ENV, None)
    tpairing.TPairing.miller_product = miller_spy
    snark.msm_device_scheduled = msm_spy
    try:
        proof = run("proof_system_prove", lambda: Proof.new(
            hr, spec, wits_of(), nonce=PS_NONCE, device=dev), ("mont_mul",))
        for mode, cfg, need in (("none", None, ()),
                                ("lazy", VerifierConfig(True),
                                 CHECKER_KERNELS),
                                ("eager", VerifierConfig(False), ())):
            if not run(f"proof_system_verify_{mode}", lambda: proof.verify(
                    hr, spec, nonce=PS_NONCE, config=cfg, device=dev), need):
                raise AssertionError(f"proof_system_composite: verify "
                                     f"({mode}) refused the proof")
        lazy = [n for p, n in miller if p == "proof_system_verify_lazy"]
        if len(lazy) != 1 or lazy[0] < RandomizedPairingChecker \
                .DEVICE_THRESHOLD:
            raise AssertionError(f"proof_system_composite: the lazy "
                                 f"checker's device Miller products {lazy}")
        if any(p != "proof_system_verify_lazy" for p, _ in miller):
            raise AssertionError(f"proof_system_composite: a device Miller "
                                 f"product off the lazy verify: {miller}")
        ct = proof.statement_proofs[4].ciphertext
        dec, nu = run("proof_system_decrypt", lambda: saver.decrypt(
            ct, k["sk"], k["dk"], k["g_i"], SAVER_CB, device=dev),
            ROUTE_KERNELS)
        if dec != uid or nu != ct.X_r.mul_raw(int(k["sk"].rho)):
            raise AssertionError("proof_system_composite: the auditor's "
                                 "decryption differs from the user id")

        # ---- rejections, outside the counted paths
        t0 = time.perf_counter()
        refused = {}

        def refuses(name, fn, err=ProofSystemError, match=""):
            try:
                fn()
            except err as e:
                refused[name] = match in str(e)
                return
            refused[name] = False

        refuses("wrong_nonce", lambda: proof.verify(
            hr, spec, nonce=b"another nonce", device=dev))
        other = Fr.rand(hr)
        small = spec_of(other, snarks=False)
        refuses("broken_equality", lambda: Proof.new(
            hr, small, wits_of(other, snarks=False), nonce=PS_NONCE,
            device=dev).verify(hr, small, nonce=PS_NONCE, device=dev),
            match="equality")
        bad = copy.deepcopy(proof)
        bct = bad.statement_proofs[4].ciphertext
        bct.enc_chunks[0] = (bct.enc_chunks[0] + k["g_i"][0]).normalize()
        refuses("changed_ciphertext", lambda: bad.verify(
            hr, spec, nonce=PS_NONCE, device=dev))
        ages = ProofSpec()
        ages.add_statement(ss.BoundCheckLegoGroth16(
            min_val=PS_AGE[0], max_val=PS_AGE[1], snark_pk=k["bound_pk"]))
        refuses("age_out_of_range", lambda: Proof.new(
            hr, ages, [Fr(PS_AGE[0] - 1)], nonce=PS_NONCE, device=dev),
            snark.LegoGroth16Error)
        t["rejections_s"] = time.perf_counter() - t0
        if not all(refused.values()):
            raise AssertionError(f"proof_system_composite: not refused: "
                                 f"{refused}")
    finally:
        tpairing.TPairing.miller_product = real_miller
        snark.msm_device_scheduled = real_msm
        if env is not None:
            os.environ[PAIRING_ENV] = env
    phase("proof_system_composite", statements=len(spec.statements),
          messages=PS_MSGS, revealed=PS_REVEALED, chunk_bits=SAVER_CB,
          accumulator_elements=NELEM, age_bounds=list(PS_AGE),
          prove_s=t["proof_system_prove_s"],
          verify_s={m: t[f"proof_system_verify_{m}_s"]
                    for m in ("none", "lazy", "eager")},
          decrypt_s=t["proof_system_decrypt_s"], setup_s=t["setup_s"],
          rejections_s=t["rejections_s"], deferred_pairs=lazy[0],
          checker_device_threshold=RandomizedPairingChecker.DEVICE_THRESHOLD,
          prover_msm_on_card=bool(device_msms),
          prover_device_msm_sizes=[n for _, n in device_msms],
          launches={p: {n: c for n, c in v.items() if c}
                    for p, v in paths.items()},
          decrypted=True, refused=refused, correct=True)
    return paths, captured



# ---- the range statements and the Circom statement (`proof_system_ranges`)
PR_MSGS = 32                        # BASELINE config 2's credential: 32
PR_REVEALED = 4                     # messages, 4 of them revealed
PR_BASE = 16                        # the CCS range proofs' digit base
# a 64-bit attribute (a timestamp in ns) in [PR_MIN, PR_MAX): 64-bit
# bounds, whose CCS decompositions take 16 base-16 digits each
PR_MIN, PR_MAX = 1 << 62, (1 << 63) + (1 << 61)
PR_NONCE = b"chip-smoke ranges nonce"
# each kernel wrapper's source, and the `pl.pallas_call` line it replaces
KERNEL_SOURCE = {
    "mont_mul": ("mont_mul.cu", "ops/pallas/field_kernels.py:386"),
    "mont_pow": ("mont_mul.cu", "ops/pallas/field_kernels.py:386"),
    "fq2_mul": ("fq2_mul.cu", "ops/pallas/curve_kernels.py:1066"),
    "fq2_sqr": ("fq2_mul.cu", "ops/pallas/curve_kernels.py:908"),
    "gather_rows_t": ("gather.cu", "ops/pallas/field_kernels.py:356"),
    "slot_tables": ("gather.cu", "ops/msm_v2.py:719"),
    "affine_level": ("affine_level.cu", "ops/pallas/curve_kernels.py:533"),
    "affine_level_fast": ("affine_level.cu",
                          "ops/pallas/curve_kernels.py:739"),
    "chunked_level_prefix": ("chunked_level.cu",
                             "ops/pallas/curve_kernels.py:844"),
    "chunked_level_down": ("chunked_level.cu",
                           "ops/pallas/curve_kernels.py:860"),
    "chunked_level_prefix_fast": ("chunked_level.cu",
                                  "ops/pallas/curve_kernels.py:669"),
    "chunked_level_down_fast": ("chunked_level.cu",
                                "ops/pallas/curve_kernels.py:683"),
    "affine_level_pre_fq2": ("affine_level_fq2.cu",
                             "ops/pallas/curve_kernels.py:1014"),
    "affine_level_post_fq2": ("affine_level_fq2.cu",
                              "ops/pallas/curve_kernels.py:1029"),
}


def plain_of(name: str):
    """The plain PyTorch version of the kernel wrapper `name` (the Fq2
    levels' is the generic level's over Fq2)."""
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    base = name[:-len("_fq2")] if name.endswith("_fq2") else name
    return getattr(fk, base + "_plain", None) or getattr(ck, base + "_plain")


def kernel_of(name: str):
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    return getattr(fk, name, None) or getattr(ck, name)


def launch_shape(name: str, args) -> list:
    """The [rows, lanes] a launch of `name` ran at: the gather's payload
    words and slots, otherwise its first tensor's."""
    if name == "gather_rows_t":
        return [args[0].shape[1], args[1].shape[0]]
    t = next(a for a in args if isinstance(a, torch.Tensor))
    return list(t.shape)


def capture_launches(counted, fn):
    """fn() with every counted wrapper shimmed (`with_shims`) to keep a
    copy of the arguments of the first launch at each shape (and
    exponent) of each kernel; returns fn()'s result and {(name, shape
    key): args}."""
    seen = {}

    def on_launch(name, args):
        key = (name,) + tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                              else a if isinstance(a, int) else None
                              for a in args)
        if key not in seen:
            seen[key] = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)

    return with_shims(counted, on_launch, fn), seen


def captured_kernel_checks(row, agree, captured: dict) -> list:
    """Every kernel launch `capture_launches` kept, per path: the kernel
    against its plain version on the same arguments, bit for bit.
    `mont_pow`'s plain version is lane by lane (608 dependent products,
    ~4-5 s a call at any width), so every path's launches of one
    exponent share one plain call over their inputs side by side, and
    that call's time is the plain time of each path's `mont_pow` row.
    Returns the kernels-line rows, one a path and kernel (and exponent)
    at its widest launch."""
    rows, checked, pows = [], [], {}
    for path, seen in captured.items():
        widest = {}
        for key, args in seen.items():
            name = key[0]
            shape = launch_shape(name, args)
            checked.append([path, name, shape])
            if name == "mont_pow":
                pows.setdefault((args[1], args[2].p), []).append((path,
                                                                  args))
                continue
            out, want = kernel_of(name)(*args), plain_of(name)(*args)
            agree(name, out if isinstance(out, tuple) else (out,),
                  want if isinstance(want, tuple) else (want,),
                  f"on {path} at {shape}")
            if shape[0] * shape[1] > widest.get(name, (0, None))[0]:
                widest[name] = (shape[0] * shape[1], args)
        rows.extend(kernel_row(row, agree, path, name, args)
                    for name, (_, args) in sorted(widest.items()))
    src, rep = KERNEL_SOURCE["mont_pow"]
    for (e, _), group in pows.items():
        mod = group[0][1][2]
        whole, whole_ms = timed_call(lambda: plain_of("mont_pow")(
            torch.cat([a[0] for _, a in group], 1), e, mod))
        at, widest = 0, {}
        for path, a in group:
            m = a[0].shape[1]
            err = agree("mont_pow", (kernel_of("mont_pow")(*a),),
                        (whole[:, at:at + m],), f"on {path} at M={m}")
            if m > widest.get(path, (0,))[0]:
                widest[path] = (m, a, err)
            at += m
        rows.extend(row("mont_pow", "crypto_tpu_torch/csrc/" + src,
                        "crypto_tpu/" + rep, path, err,
                        cuda_ms(lambda: kernel_of("mont_pow")(*a)), whole_ms,
                        a, launch_shape("mont_pow", a))
                    for path, (m, a, err) in sorted(widest.items()))
    phase("check_captured_kernels", path_kernel_shape=json.dumps(checked),
          bit_exact=True)
    return rows


def kernel_row(row, agree, path: str, name: str, args) -> dict:
    """The kernels-line row of `name` on `path` at the launch `args`: its
    plain version timed once and held to the kernel, the kernel timed."""
    src, rep = KERNEL_SOURCE[name]
    want, plain_ms = timed_call(lambda: plain_of(name)(*args))
    out = kernel_of(name)(*args)
    err = agree(name, out if isinstance(out, tuple) else (out,),
                want if isinstance(want, tuple) else (want,), f"on {path}")
    return row(name, "crypto_tpu_torch/csrc/" + src, "crypto_tpu/" + rep,
               path, err, cuda_ms(lambda: kernel_of(name)(*args)), plain_ms,
               args, launch_shape(name, args))


def proof_system_ranges_phase(counted, dev, lego_pk) -> tuple:
    """The range statements and the Circom statement in one composite
    proof on the card (`proof_system_ranges`): a BBS+ credential over
    `PR_MSGS` messages (`PR_REVEALED` revealed; message 0 a 64-bit
    timestamp, message 1 an attribute, message 2 the circuit's committed
    wire), and, each linked to its message by a witness equality: the
    timestamp in [`PR_MIN`, `PR_MAX`) by the Bulletproofs++ bound check
    (64 bits in base-2 digits, the statement's), by the CCS arbitrary range (base
    `PR_BASE`: 2 x 16 digits) and by its keyed-verification form (the
    prover's statement in the prover's spec, the verifier's, holding the
    weak-BB key, in the verifier's); message 1 unequal to a public value;
    and `chain_circuit` at 2^LEGO_LOG - 4 constraints written as Circom's
    `.r1cs` (`testing.r1cs_of`, into build/), read back by
    `legogroth16/circom.py` and proven under `legogroth16_phases`' key
    (`lego_pk`: the same constraint system, `tests/test_torch_circom.py`).

    Each path runs with the launch counts reset before it and read after,
    and every launch's arguments kept (`capture_launches`): `Proof.new`
    (`proof_system_ranges_prove`: the Circom prover's witness map and
    its G1 and G2 query MSMs on the card, every MSM kernel required),
    `Proof.verify` with no checker, with the lazy checker (one device
    Miller product of 34 or more pairs; mont_mul, fq2_mul and fq2_sqr
    required) and with the eager one, each timed.  Every routed pairing
    call's pairs, products and route are listed.  A wrong nonce, a broken
    witness equality, a spoiled Bulletproofs++ proof, a spoiled
    set-membership digit (its response z_v, which passes the commitment
    check: the lazy checker's one device Miller product refuses it) and a
    timestamp out of range at prove time are refused.  Returns ({path: launches}, {path: captured launches})."""
    import copy
    import os

    from crypto_tpu_torch.bbs_plus.setup import KeypairG2, SignatureParamsG1
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.bulletproofs_pp.range_proof import SetupParams
    from crypto_tpu_torch.bulletproofs_pp.wnla import BppError
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import tpairing
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.legogroth16.circom import parse_r1cs
    from crypto_tpu_torch.proof_system import statements as st
    from crypto_tpu_torch.proof_system import statements_ranges as sr
    from crypto_tpu_torch.proof_system.base import ProofSpec, \
        ProofSystemError
    from crypto_tpu_torch.proof_system.proof import Proof, VerifierConfig
    from crypto_tpu_torch.r1cs.cs import ConstraintSystem
    from crypto_tpu_torch.smc_range_proof.ccs import (
        MemberCommitmentKey, SetMembershipCheckParams, SmcError)
    from crypto_tpu_torch.smc_range_proof.kv import \
        SetMembershipCheckParamsKV
    from crypto_tpu_torch.testing import r1cs_of
    from crypto_tpu_torch.utils.commitment import PedersenCommitmentKey
    Fr = bls.Fr
    hr = random.Random(SEED + 600)
    t = {}
    t0 = time.perf_counter()
    sig_params = SignatureParamsG1.generate_using_rng(hr, PR_MSGS)
    issuer = KeypairG2.generate(hr, sig_params)
    stamp = hr.randrange(PR_MIN, PR_MAX)
    x = Fr.rand(hr)
    msgs = [Fr(stamp), Fr.rand(hr), x] + [Fr.rand(hr)
                                          for _ in range(PR_MSGS - 3)]
    sig = SignatureG1.new(hr, msgs, issuer.secret_key, sig_params)
    revealed = {i: msgs[i] for i in range(PR_MSGS - PR_REVEALED, PR_MSGS)}
    bpp = SetupParams.new_for_perfect_range_proof(b"chip-smoke bpp", 2, 64,
                                                  2)
    smc = SetMembershipCheckParams.new_for_range_proof(hr, b"chip-smoke smc",
                                                       PR_BASE)
    smc_kv = SetMembershipCheckParamsKV.new_for_range_proof(
        hr, b"chip-smoke smc kv", PR_BASE)
    ck = MemberCommitmentKey.new(b"chip-smoke smc ck")
    ped = PedersenCommitmentKey.new(bls.G1, b"chip-smoke ineq")
    ped_r = Fr.rand(hr)
    ped_c = ped.commit(msgs[1], ped_r)
    inequal_to = msgs[1] + Fr(1)
    t["setup_s"] = time.perf_counter() - t0

    # the circuit as Circom's .r1cs, written and read back; its wires
    t0 = time.perf_counter()
    nc = (1 << LEGO_LOG) - 4
    cs1 = ConstraintSystem(Fr, mode="prove")
    chain_circuit(nc, x)(cs1)
    wires = cs1.full_assignment()
    path = Path("build") / "chain_circuit.r1cs"
    path.parent.mkdir(exist_ok=True)
    path.write_bytes(r1cs_of(cs1, 1, 1))
    r1cs = parse_r1cs(str(path))
    out = wires[1]
    t["circom_r1cs_s"] = time.perf_counter() - t0
    if (r1cs.n_constraints, r1cs.n_wires, r1cs.n_public) != (nc, nc + 2, 1):
        raise AssertionError(f"proof_system_ranges: the .r1cs read back as "
                             f"{r1cs.n_constraints} constraints, "
                             f"{r1cs.n_wires} wires")

    def spec_of(verifier=True, link=0, bpp_only=False):
        spec = ProofSpec(context=b"chip-smoke ranges")
        s0 = spec.add_statement(st.PoKBBSSignatureG1(
            params=sig_params, public_key=issuer.public_key,
            revealed_messages=revealed))
        rng_ = [(s0, link), (spec.add_statement(sr.BoundCheckBpp(
            min_val=PR_MIN, max_val=PR_MAX, bpp_params=bpp)), 0)]
        if bpp_only:
            spec.add_witness_equality(rng_)
            return spec
        rng_.append((spec.add_statement(sr.BoundCheckSmc(
            min_val=PR_MIN, max_val=PR_MAX, params=smc, comm_key=ck,
            base=PR_BASE)), 0))
        kv = sr.BoundCheckSmcWithKVVerifier(
            min_val=PR_MIN, max_val=PR_MAX, params=smc_kv, comm_key=ck,
            base=PR_BASE, secret_key=smc_kv.sk) if verifier else \
            sr.BoundCheckSmcWithKVProver(
                min_val=PR_MIN, max_val=PR_MAX, params=smc_kv, comm_key=ck,
                base=PR_BASE)
        rng_.append((spec.add_statement(kv), 0))
        spec.add_witness_equality(rng_)
        s4 = spec.add_statement(sr.PublicInequalityStatement(
            commitment=ped_c, inequal_to=inequal_to, comm_key=ped))
        spec.add_witness_equality([(s0, 1), (s4, 0)])
        s5 = spec.add_statement(sr.R1CSCircomStatement(
            r1cs=r1cs, snark_pk=lego_pk, public_inputs=[out]))
        spec.add_witness_equality([(s0, 2), (s5, 0)])
        return spec

    def wits_of(stamp_value=stamp, bpp_only=False):
        w = [st.BBSWitness(signature=sig, messages=msgs), Fr(stamp_value)]
        if bpp_only:
            return w
        return w + [Fr(stamp_value), Fr(stamp_value), (msgs[1], ped_r),
                    wires]

    paths, captured = {}, {}
    miller, device_msms, routes = [], [], []
    real_miller = tpairing.TPairing.miller_product
    real_msm = snark.msm_device_scheduled
    real_route = tpairing.pairing_route
    path_now = [None]

    def miller_spy(self, pairs):
        miller.append((path_now[0], len(pairs)))
        return real_miller(self, pairs)

    def msm_spy(curve, points, scalars, **kw):
        device_msms.append((path_now[0], curve.name, len(scalars)))
        return real_msm(curve, points, scalars, **kw)

    def route_spy(npairs, ngroups=1):
        r = real_route(npairs, ngroups)
        routes.append((path_now[0], npairs, ngroups, r))
        return r

    def run(path, fn, need=()):
        path_now[0] = path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (res, seen), launches = drive(
            counted, lambda: capture_launches(counted, fn))
        torch.cuda.synchronize()
        t[path + "_s"] = time.perf_counter() - t0
        require(path, launches, need)
        paths[path] = launches
        captured[path] = seen
        return res

    env = os.environ.pop(PAIRING_ENV, None)
    tpairing.TPairing.miller_product = miller_spy
    tpairing.pairing_route = route_spy
    snark.msm_device_scheduled = msm_spy
    spec = spec_of()
    try:
        proof = run("proof_system_ranges_prove", lambda: Proof.new(
            hr, spec_of(verifier=False), wits_of(), nonce=PR_NONCE,
            device=dev), PROVE_KERNELS + LEVEL_KERNELS[("narrow", False)])
        sizes = sorted({(c, n) for p, c, n in device_msms
                        if p == "proof_system_ranges_prove"})
        if not any(c == bls.G2.name for c, _ in sizes) \
                or max(n for _, n in sizes) < nc:
            raise AssertionError(f"proof_system_ranges: the Circom prove's "
                                 f"device MSMs {sizes}")
        for mode, cfg, need in (("none", None, ()),
                                ("lazy", VerifierConfig(True),
                                 CHECKER_KERNELS),
                                ("eager", VerifierConfig(False), ())):
            if not run(f"proof_system_ranges_verify_{mode}",
                       lambda: proof.verify(hr, spec, nonce=PR_NONCE,
                                            config=cfg, device=dev), need):
                raise AssertionError(f"proof_system_ranges: verify ({mode}) "
                                     f"refused the proof")
        lazy = [n for p, n in miller if p == "proof_system_ranges_verify_lazy"]
        if len(lazy) != 1 or lazy[0] < 34:
            raise AssertionError(f"proof_system_ranges: the lazy checker's "
                                 f"device Miller products {lazy}")
        if any(p != "proof_system_ranges_verify_lazy" for p, _ in miller):
            raise AssertionError(f"proof_system_ranges: a device Miller "
                                 f"product off the lazy verify: {miller}")
        path_now[0] = "rejections"

        # ---- rejections, outside the counted paths
        t0 = time.perf_counter()
        refused = {}

        def refuses(name, fn, err=ProofSystemError, match=""):
            try:
                fn()
            except err as e:
                refused[name] = match in str(e)
                return
            refused[name] = False

        refuses("wrong_nonce", lambda: proof.verify(
            hr, spec, nonce=b"another nonce", device=dev))
        refuses("broken_equality", lambda: proof.verify(
            hr, spec_of(link=3), nonce=PR_NONCE, device=dev),
            match="equality")
        bad = copy.deepcopy(proof)
        wn = bad.statement_proofs[1].bpp_proof.norm_proof
        wn.n = [wn.n[0] + Fr(1)]
        refuses("spoiled_bpp", lambda: bad.verify(
            hr, spec, nonce=PR_NONCE, device=dev), match="BP++")
        # a spoiled digit response z_v passes the commitment check: only
        # its pairing equation, deferred into the lazy checker's one
        # device Miller product, refuses it
        bad_digit = copy.deepcopy(proof)
        rp = bad_digit.statement_proofs[2].range_proof
        rp.z_v_min = [rp.z_v_min[0] + Fr(1)] + rp.z_v_min[1:]
        path_now[0] = "spoiled_digit"
        _, digit_launches = drive(counted, lambda: refuses(
            "spoiled_digit", lambda: bad_digit.verify(
                hr, spec, nonce=PR_NONCE, config=VerifierConfig(True),
                device=dev), match="accumulated pairing check"))
        path_now[0] = "rejections"
        require("proof_system_ranges spoiled digit", digit_launches,
                CHECKER_KERNELS)
        digit_miller = [n for p, n in miller if p == "spoiled_digit"]
        if len(digit_miller) != 1 or digit_miller[0] < 34:
            raise AssertionError(f"proof_system_ranges: the spoiled digit's "
                                 f"device Miller products {digit_miller}")
        refuses("stamp_out_of_range_bpp", lambda: Proof.new(
            hr, spec_of(verifier=False, bpp_only=True),
            wits_of(PR_MAX, bpp_only=True), nonce=PR_NONCE, device=dev),
            BppError)
        small = ProofSpec()
        small.add_statement(sr.BoundCheckSmc(
            min_val=PR_MIN, max_val=PR_MAX, params=smc, comm_key=ck,
            base=PR_BASE))
        refuses("stamp_out_of_range_smc", lambda: Proof.new(
            hr, small, [Fr(PR_MIN - 1)], nonce=PR_NONCE, device=dev),
            SmcError)
        t["rejections_s"] = time.perf_counter() - t0
        if not all(refused.values()):
            raise AssertionError(f"proof_system_ranges: not refused: "
                                 f"{refused}")
    finally:
        tpairing.TPairing.miller_product = real_miller
        tpairing.pairing_route = real_route
        snark.msm_device_scheduled = real_msm
        if env is not None:
            os.environ[PAIRING_ENV] = env
    phase("proof_system_ranges", statements=len(spec.statements),
          messages=PR_MSGS, revealed=PR_REVEALED, ccs_base=PR_BASE,
          bpp_base=2,
          bounds=[PR_MIN, PR_MAX], circom_constraints=nc,
          prove_s=t["proof_system_ranges_prove_s"],
          verify_s={m: t[f"proof_system_ranges_verify_{m}_s"]
                    for m in ("none", "lazy", "eager")},
          setup_s=t["setup_s"], circom_r1cs_s=t["circom_r1cs_s"],
          rejections_s=t["rejections_s"], deferred_pairs=lazy[0],
          spoiled_digit_pairs=digit_miller[0],
          spoiled_digit_launches={n: c for n, c in digit_launches.items()
                                  if c},
          prover_device_msms=[[c, n] for c, n in sizes],
          routes=[list(r) for r in routes],
          launches={p: {n: c for n, c in v.items() if c}
                    for p, v in paths.items()},
          refused=refused, correct=True)
    return paths, captured

BN254_MSM_RUNS = 1                  # timed 2^20 BN254 G1 MSMs
# the L = 8 instantiations the BN254 paths must launch between them: every
# level kernel of both formulas, the Fq2 level, product and square, the
# gather and its tables (8 words a row on G1, 16 on G2), mont_mul and
# mont_pow, and the bench points' full add and normalize
BN254_KERNELS = ("mont_mul", "mont_pow", "affine_level",
                 "chunked_level_prefix", "chunked_level_down",
                 "affine_level_fast", "chunked_level_prefix_fast",
                 "chunked_level_down_fast", "fq2_mul", "fq2_sqr",
                 "affine_level_pre_fq2", "affine_level_post_fq2",
                 "gather_rows_t", "slot_tables", "jacobian_add",
                 "jacobian_normalize")


# ---- PS, BBS23, BBDT16, KB universal and keyed-verification statements
# in one composite (`proof_system_more`)
PM_MSGS = 32                        # BASELINE config 2's credential: 32
PM_REVEALED = 4                     # messages, 4 of them revealed
PM_SIGNERS = (3, 5)                 # the PS issuers: 3 of 5 sign
PM_NONCE = b"chip-smoke more nonce"


def proof_system_more_phase(counted, dev, kb_keep) -> tuple:
    """The statements of `statements_more` and `statements_kv` in one
    `ProofSpec` on the card, over config 2's credential (`PM_MSGS`
    messages, the last `PM_REVEALED` revealed; message 0 the user id, a
    tracked member of `accumulator_kb_universal_phase`'s updated
    accumulator): a BBS+ PoK, a PS PoK on a signature aggregated from 3
    of 5 signers of a `threshold_keygen`, a BBS23 PoK, a BBDT16 MAC PoK
    (`PoKBBDT16MAC`; its full verifier on the verifier's side), KB
    universal membership and non-membership (CDH) and the two KB
    keyed-verification statements (their full verifiers on the
    verifier's side); the user id linked across BBS+, PS, the MAC and
    both membership statements, the non-member across its two.  Each run
    below with the launch counts reset before it and read after, its
    launches captured: `Proof.new`, `Proof.verify` with no checker, the
    lazy checker (BBS+, PS, BBS23 and both CDH statements defer 10
    pairs: one device Miller product, whose kernels must launch) and the
    eager one, each timed; a detached membership proof of the user id in
    a spec of its own (the detached verifier's challenge contribution is
    not its prover's, so it verifies only alone: ROADMAP Queue 3), proved
    and verified.  Refused: a proof over a spoiled PS signature, by the
    lazy checker's device Miller product; the MAC under another key, by
    its full verifier; the detached proof opened with another
    accumulator key.  The pairing backend variable is unset.  Returns
    ({path: launches}, {path: captured launches})."""
    import os

    from crypto_tpu_torch.accumulator.setup import AccumSecretKey
    from crypto_tpu_torch.bbs_plus.bbs23 import (PublicKey23G2,
                                                 Signature23G1,
                                                 SignatureParams23G1)
    from crypto_tpu_torch.bbs_plus.setup import (KeypairG2, SecretKey,
                                                 SignatureParamsG1)
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.coconut import core as ps
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import tpairing
    from crypto_tpu_torch.kvac.bbdt16 import MAC, KVACSecretKey, MACParams
    from crypto_tpu_torch.proof_system import statements as st
    from crypto_tpu_torch.proof_system import statements_kv as skv
    from crypto_tpu_torch.proof_system import statements_more as sm
    from crypto_tpu_torch.proof_system.base import ProofSpec, \
        ProofSystemError
    from crypto_tpu_torch.proof_system.proof import Proof, VerifierConfig
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    Fr = bls.Fr
    hr = random.Random(SEED + 700)
    params, kp, kb = kb_keep["params"], kb_keep["kp"], kb_keep["kb"]
    pk = kp.public_key
    uid, mem_wit = kb_keep["member"], kb_keep["mem_wit"]
    y_nm, nm_wit = kb_keep["non_member"], kb_keep["nm_wit"]
    t = {}
    t0 = time.perf_counter()
    msgs = [uid] + [Fr.rand(hr) for _ in range(PM_MSGS - 1)]
    revealed = {i: msgs[i] for i in range(PM_MSGS - PM_REVEALED, PM_MSGS)}
    sig_params = SignatureParamsG1.generate_using_rng(hr, PM_MSGS)
    issuer = KeypairG2.generate(hr, sig_params)
    bbs_sig = SignatureG1.new(hr, msgs, issuer.secret_key, sig_params)
    ps_params = ps.PSSignatureParams.new(b"chip-smoke PS", PM_MSGS)
    shares, _, ps_pk = ps.threshold_keygen(hr, *PM_SIGNERS, PM_MSGS,
                                           ps_params)
    ps_sig = ps.aggregate_signatures([      # signers 1, 3 and 5
        (i + 1, ps.PSSignature.new_deterministic(msgs, shares[i]))
        for i in (0, 2, 4)])
    if not ps_sig.verify(msgs, ps_pk, ps_params, device=dev):
        raise AssertionError("proof_system_more: the aggregated PS "
                             "signature fails to verify")
    b23_params = SignatureParams23G1.new(b"chip-smoke BBS23", PM_MSGS)
    b23_sk = SecretKey.generate(hr)
    b23_pk = PublicKey23G2.generate(b23_sk, b23_params)
    b23_sig = Signature23G1.new(hr, msgs, b23_sk, b23_params)
    mac_params = MACParams.new(b"chip-smoke BBDT16", PM_MSGS)
    mac_sk = KVACSecretKey.generate(hr)
    mac = MAC.new(hr, msgs, mac_sk, mac_params)
    t["setup_s"] = time.perf_counter() - t0

    def spec_of(verifier: bool, mac_key=mac_sk):
        """The composite spec; `verifier` puts the full verifiers (the
        MAC's under `mac_key`, the KV statements' under the accumulator
        key) in place of the prover's statements."""
        spec = ProofSpec(context=b"chip-smoke more")
        add = spec.add_statement
        s_bbs = add(st.PoKBBSSignatureG1(
            params=sig_params, public_key=issuer.public_key,
            revealed_messages=revealed))
        s_ps = add(sm.PoKPSSignature(params=ps_params, public_key=ps_pk,
                                     revealed_messages=revealed))
        add(sm.PoKBBSSignature23G1(params=b23_params, public_key=b23_pk,
                                   revealed_messages=revealed))
        s_mac = add(sm.PoKBBDT16MACFullVerifier(
            params=mac_params, revealed_messages=revealed,
            secret_key=mac_key) if verifier else sm.PoKBBDT16MAC(
                params=mac_params, revealed_messages=revealed))
        s_mem = add(st.KBUniversalAccumulatorMembership(
            accumulator_value=kb.mem.value(), params=params, public_key=pk))
        s_nm = add(st.KBUniversalAccumulatorNonMembership(
            accumulator_value=kb.non_mem.value(), params=params,
            public_key=pk))
        if verifier:
            s_mkv = add(skv.KBUniversalAccumulatorMembershipKVFullVerifier(
                accumulator_value=kb.mem.value(), secret_key=kp.secret_key))
            s_nkv = add(
                skv.KBUniversalAccumulatorNonMembershipKVFullVerifier(
                    accumulator_value=kb.non_mem.value(),
                    secret_key=kp.secret_key))
        else:
            s_mkv = add(skv.KBUniversalAccumulatorMembershipKV(
                accumulator_value=kb.mem.value()))
            s_nkv = add(skv.KBUniversalAccumulatorNonMembershipKV(
                accumulator_value=kb.non_mem.value()))
        spec.add_witness_equality([(s_bbs, 0), (s_ps, 0), (s_mac, 0),
                                   (s_mem, 0), (s_mkv, 0)])
        spec.add_witness_equality([(s_nm, 0), (s_nkv, 0)])
        return spec

    def wits_of(ps_signature=ps_sig):
        mem = st.AccumMembershipWit(element=uid, witness=mem_wit)
        nm = st.AccumMembershipWit(element=y_nm, witness=nm_wit)
        return [st.BBSWitness(bbs_sig, msgs),
                sm.PSSigWitness(ps_signature, msgs),
                sm.BBS23Witness(b23_sig, msgs), sm.KVACWitness(mac, msgs),
                mem, nm, mem, nm]

    def detached_spec(acc_key=None):
        spec = ProofSpec(context=b"chip-smoke detached")
        spec.add_statement(skv.DetachedAccumulatorMembershipVerifier(
            params=params, public_key=pk, secret_key=acc_key)
            if acc_key is not None else
            skv.DetachedAccumulatorMembershipProver(params=params,
                                                    public_key=pk))
        return spec

    prover_spec, verifier_spec = spec_of(False), spec_of(True)
    paths, captured = {}, {}
    miller = []
    real_miller = tpairing.TPairing.miller_product
    path_now = [None]

    def miller_spy(self, pairs):
        miller.append((path_now[0], len(pairs)))
        return real_miller(self, pairs)

    def run(path, fn, need=()):
        path_now[0] = path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, seen), launches = drive(
            counted, lambda: capture_launches(counted, fn))
        torch.cuda.synchronize()
        t[path + "_s"] = time.perf_counter() - t0
        require(path, launches, need)
        paths[path] = launches
        captured[path] = seen
        return out

    refused = {}

    def refuses(name, fn, err=ProofSystemError, match=""):
        try:
            fn()
        except err as e:
            refused[name] = match in str(e)
            return
        refused[name] = False

    env = os.environ.pop(PAIRING_ENV, None)
    tpairing.TPairing.miller_product = miller_spy
    try:
        proof = run("proof_system_more_prove", lambda: Proof.new(
            hr, prover_spec, wits_of(), nonce=PM_NONCE, device=dev))
        for mode, cfg, need in (("none", None, ()),
                                ("lazy", VerifierConfig(True),
                                 CHECKER_KERNELS),
                                ("eager", VerifierConfig(False), ())):
            if not run(f"proof_system_more_verify_{mode}",
                       lambda: proof.verify(hr, verifier_spec,
                                            nonce=PM_NONCE, config=cfg,
                                            device=dev), need):
                raise AssertionError(f"proof_system_more: verify ({mode}) "
                                     f"refused the proof")
        det = run("proof_system_more_detached_prove", lambda: Proof.new(
            hr, detached_spec(), [skv.DetachedAccumMembershipWit(
                element=uid, witness=mem_wit,
                accumulator_value=kb.mem.value())], nonce=PM_NONCE,
            device=dev))
        if not run("proof_system_more_detached_verify", lambda: det.verify(
                hr, detached_spec(kp.secret_key), nonce=PM_NONCE,
                device=dev)):
            raise AssertionError("proof_system_more: the detached verifier "
                                 "refused the proof")

        # ---- rejections
        t0 = time.perf_counter()
        spoiled = ps.PSSignature(ps_sig.sigma_1, (
            ps_sig.sigma_2 + bls.G1.generator()).normalize())
        bad = Proof.new(hr, prover_spec, wits_of(spoiled), nonce=PM_NONCE,
                        device=dev)
        run("proof_system_more_spoiled_ps", lambda: refuses(
            "spoiled_ps_signature", lambda: bad.verify(
                hr, verifier_spec, nonce=PM_NONCE,
                config=VerifierConfig(True), device=dev),
            match="pairing"), CHECKER_KERNELS)
        refuses("mac_other_key", lambda: proof.verify(
            hr, spec_of(True, KVACSecretKey.generate(hr)), nonce=PM_NONCE,
            device=dev), match="keyed")
        refuses("detached_other_key", lambda: det.verify(
            hr, detached_spec(AccumSecretKey(alpha=Fr.rand(hr))),
            nonce=PM_NONCE, device=dev), (ProofSystemError, ValueError))
        t["rejections_s"] = time.perf_counter() - t0
    finally:
        tpairing.TPairing.miller_product = real_miller
        if env is not None:
            os.environ[PAIRING_ENV] = env
    if not all(refused.values()):
        raise AssertionError(f"proof_system_more: not refused: {refused}")
    lazy = [n for p, n in miller if p == "proof_system_more_verify_lazy"]
    if len(lazy) != 1 or lazy[0] < RandomizedPairingChecker.DEVICE_THRESHOLD:
        raise AssertionError(f"proof_system_more: the lazy checker's device "
                             f"Miller products {lazy}")
    off = [m for m in miller if m[0] not in ("proof_system_more_verify_lazy",
                                             "proof_system_more_spoiled_ps")]
    if off or len(miller) != 2:
        raise AssertionError(f"proof_system_more: device Miller products "
                             f"{miller}")
    phase("proof_system_more", statements=len(verifier_spec.statements),
          messages=PM_MSGS, revealed=PM_REVEALED,
          ps_signers=list(PM_SIGNERS), accumulator_domain=NELEM,
          prove_s=t["proof_system_more_prove_s"],
          verify_s={m: t[f"proof_system_more_verify_{m}_s"]
                    for m in ("none", "lazy", "eager")},
          detached_s=[t["proof_system_more_detached_prove_s"],
                      t["proof_system_more_detached_verify_s"]],
          setup_s=t["setup_s"], rejections_s=t["rejections_s"],
          deferred_pairs=lazy[0],
          checker_device_threshold=RandomizedPairingChecker.DEVICE_THRESHOLD,
          launches={p: {n: c for n, c in v.items() if c}
                    for p, v in paths.items()},
          refused=refused, correct=True)
    return paths, captured


SPLIT_MSGS = 32                     # BASELINE config 2's credential: 32
SPLIT_REVEALED = 4                  # messages, 4 of them revealed
TZ21_SET = (16, 32)                 # DKGitH (N, tau): (1/16)^32 = 2^-128
TZ21_K = 4                          # messages it encrypts (+ the filler)
TZ21_SAMPLES = 32                   # party instances held to host products
TZ21_ROBUST = (16, 12)              # RDkgith: the reference's default,
#                                     16 parties, 12 revealed
SPLIT_NONCE = b"chip-smoke split nonce"
IETF_MSGS = 32                      # the IETF suites' messages, 4 disclosed
IETF_DISCLOSED = (0, 9, 17, 31)
IETF_HEADER = bytes.fromhex("11223344556677889900aabbccddeeff")
IETF_KEY_MATERIAL = bytes.fromhex(
    "746869732d49532d6a7573742d616e2d546573742d494b4d2d746f2d67656e65"
    "726174652d246528724074232d6b6579")
IETF_KEY_INFO = bytes.fromhex(
    "746869732d49532d736f6d652d6b65792d6d657461646174612d746f2d62652d"
    "757365642d696e2d746573742d6b65792d67656e")
# the draft's fixtures (tests/test_bbs_ietf.py): SK, PK and P1 of the
# SHA-256 suite; SK, Q_1, H_1 and H_2 of the SHAKE-256 suite
IETF_KATS = {
    "BLS12381_SHA256": dict(
        sk=0x60e55110f76883a13d030b2f6bd11883422d5abde717569fc0731f51237169fc,
        pk="a820f230f6ae38503b86c70dc50b61c58a77e45c39ab25c0652bbaa8fa136f28"
           "51bd4781c9dcde39fc9d1d52c9e60268061e7d7632171d91aa8d460acee0e96f"
           "1e7c4cfb12d3ff9ab5d5dc91c277db75c845d649ef3c4f63aebc364cd55ded0c",
        p1="a8ce256102840821a3e94ea9025e4662b205762f9776b3a766c872b948f1fd22"
           "5e7c59698588e70d11406d161b4e28c9"),
    "BLS12381_SHAKE256": dict(
        sk=0x2eee0f60a8a3a8bec0ee942bfd46cbdae9a0738ee68f5a64e7238311cf09a079,
        generators=[
            "a9d40131066399fd41af51d883f4473b0dcd7d028d3d34ef17f3241d204e2850"
            "7d7ecae032afa1d5490849b7678ec1f8",
            "903c7ca0b7e78a2017d0baf74103bd00ca8ff9bf429f834f071c75ffe6bfdec6"
            "d6dca15417e4ac08ca4ae1e78b7adc0e",
            "84321f5855bfb6b001f0dfcb47ac9b5cc68f1a4edd20f0ec850e0563b27d2acc"
            "ee6edff1a26b357762fb24e8ddbb6fcb"])}
TZ21_KERNELS = ("mont_mul", "mont_pow")


def proof_system_split_phase(counted, dev, acc_keep, kb_keep) -> tuple:
    """TZ21 verifiable encryption at the 128-bit set, the split composite
    and the IETF BBS suites on the card (`proof_system_split`), over a
    credential of config 2's shape (`SPLIT_MSGS` messages, the last
    `SPLIT_REVEALED` revealed; message 0 the user id of
    `accumulator_phases`' first member, messages 1-4 the encrypted ones).

    (a) DKGitH alone at (N, tau) = `TZ21_SET` over `TZ21_K` messages and
    the filler (5 commitment bases): the prove and the verify, cold (the
    7 fixed-base tables built in the call; the table cache cleared before
    the cold verify) and warm, each on the device route (`mont_mul` and
    `mont_pow` required: the host route launches nothing);
    `TZ21_SAMPLES` sampled party instances' commitments, shared secrets
    and ephemeral keys against host `msm` and `mul_raw`; compress at the
    reference's default subset and decrypt as the auditor, every message
    back exactly; a spoiled delta, opening and hidden ciphertext refused.

    (b) One composite over a prover's spec and a verifier's spec
    (`statements_split`): BBS+ (`PoKBBSSignatureG1Prover`/`Verifier`), a
    BBS23 credential on the same messages (the IETF statements), VB
    membership (CDH) of the user id in `acc_keep`'s accumulator, KB
    universal non-membership (CDH) in `kb_keep`'s, a G2 Pedersen
    commitment, `VeTZ21` at `TZ21_SET` over messages 1-4 and
    `VeTZ21Robust` at `TZ21_ROBUST` over message 1, tied by witness
    equalities.  The prove, and the verify with no checker, the lazy
    checker (the four signature and CDH statements defer 8 pairs: one
    device Miller product) and the eager one, each timed; refused: a
    proof at (2, 1) under the (16, 32) statement, the prover's spec
    asked to verify, a wrong nonce, a broken witness equality; the
    auditor decrypts the 4 messages from the composite's TZ21 proof.

    (c) Both IETF ciphersuites: the draft's fixtures (`IETF_KATS`), then
    `sign`, `verify`, `proof_gen` and `proof_verify` over `IETF_MSGS`
    messages, 4 disclosed, each timed; a spoiled signature and a spoiled
    proof refused.

    Each path runs with the launch counts reset before it and read after,
    its launches captured.  The pairing backend variable is unset.
    Returns ({path: launches}, {path: captured launches})."""
    import os

    from crypto_tpu_torch.bbs_plus import ietf
    from crypto_tpu_torch.bbs_plus.bbs23 import (PublicKey23G2,
                                                 Signature23G1,
                                                 SignatureParams23G1)
    from crypto_tpu_torch.bbs_plus.setup import (KeypairG2, SecretKey,
                                                 SignatureParamsG1)
    from crypto_tpu_torch.bbs_plus.signature import SignatureG1
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import tpairing
    from crypto_tpu_torch.hashing import n_group_elements
    from crypto_tpu_torch.ops import fixed_base
    from crypto_tpu_torch.proof_system import statements as st
    from crypto_tpu_torch.proof_system import statements_more as sm
    from crypto_tpu_torch.proof_system import statements_split as ss
    from crypto_tpu_torch.proof_system.base import ProofSpec, \
        ProofSystemError
    from crypto_tpu_torch.proof_system.proof import Proof, VerifierConfig
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    from crypto_tpu_torch.utils.elgamal import keygen
    from crypto_tpu_torch.utils.msm import msm
    from crypto_tpu_torch.verifiable_encryption import tz21
    Fr = bls.Fr
    hr = random.Random(SEED + 800)
    t = {}
    t0 = time.perf_counter()
    uid = acc_keep["member"]
    msgs = [uid] + [Fr.rand(hr) for _ in range(SPLIT_MSGS - 1)]
    revealed = {i: msgs[i] for i in range(SPLIT_MSGS - SPLIT_REVEALED,
                                          SPLIT_MSGS)}
    hidden = msgs[1:1 + TZ21_K]
    gens = [p.normalize() for p in n_group_elements(
        bls.G1, 0, TZ21_K + 1, b"chip-smoke TZ21 commitment key")]
    enc_g = bls.G1.rand(hr).normalize()
    dec_sk, enc_pk = keygen(hr, enc_g)
    wits = hidden + [Fr.rand(hr)]
    Y = msm(gens, wits).normalize()
    t["setup_s"] = time.perf_counter() - t0

    paths, captured = {}, {}
    miller, products = [], {}
    real_miller = tpairing.TPairing.miller_product
    real_products = tz21._party_products
    path_now = [None]

    def miller_spy(self, pairs):
        miller.append((path_now[0], len(pairs)))
        return real_miller(self, pairs)

    def products_spy(gens_, shares, ephs, pk, g, device):
        out = real_products(gens_, shares, ephs, pk, g, device)
        products.setdefault(path_now[0], []).append(
            (gens_, shares, ephs, pk, g, out))
        return out

    def run(path, fn, need=()):
        path_now[0] = path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, seen), launches = drive(
            counted, lambda: capture_launches(counted, fn))
        torch.cuda.synchronize()
        t[path + "_s"] = time.perf_counter() - t0
        require(path, launches, need)
        paths[path] = launches
        captured[path] = seen
        return out

    refused = {}

    def refuses(name, fn, match=""):
        try:
            ok = fn()
        except (ProofSystemError, ValueError) as e:
            refused[name] = match in str(e)
            return
        refused[name] = ok is False and not match

    env = os.environ.pop(PAIRING_ENV, None)
    tpairing.TPairing.miller_product = miller_spy
    tz21._party_products = products_spy
    try:
        # ---- (a) DKGitH alone at the 128-bit set
        def prove():
            return tz21.DkgithProof.new(hr, wits, Y, gens, enc_pk, enc_g,
                                        *TZ21_SET, device=dev)

        def verify(p):
            return p.verify(Y, gens, enc_pk, enc_g, device=dev)

        proof = run("tz21_prove_cold", prove, TZ21_KERNELS)
        run("tz21_prove_warm", prove, TZ21_KERNELS)
        fixed_base._table_cache.cache_clear()
        for path in ("tz21_verify_cold", "tz21_verify_warm"):
            if not run(path, lambda: verify(proof), TZ21_KERNELS):
                raise AssertionError(f"proof_system_split: {path} refused "
                                     f"the proof")
        t0 = time.perf_counter()
        for path, n in (("tz21_prove_cold", TZ21_SET[0] * TZ21_SET[1]),
                        ("tz21_verify_cold",
                         (TZ21_SET[0] - 1) * TZ21_SET[1])):
            (g_, shares, ephs, pk, g, (comms, shared, eph)), = \
                products[path]
            if len(comms) != n:
                raise AssertionError(f"proof_system_split: {path} made "
                                     f"{len(comms)} party instances")
            for i in sorted(hr.sample(range(n), TZ21_SAMPLES)):
                r = int(ephs[i])
                if (comms[i], shared[i], eph[i]) != (
                        msm(g_, shares[i]), pk.y.mul_raw(r),
                        g.mul_raw(r)):
                    raise AssertionError(f"proof_system_split: {path}'s "
                                         f"party instance {i} differs from "
                                         f"the host's products")
        t["samples_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if proof.compress().decrypt(dec_sk, Y, gens)[:TZ21_K] != hidden:
            raise AssertionError("proof_system_split: the auditor's "
                                 "decryption differs from the messages")
        t["decrypt_s"] = time.perf_counter() - t0
        d = dict(vars(proof))
        ct = proof.hidden_cts[0]
        for what, change in (
                ("delta", dict(deltas=[[x + Fr(1) for x in proof.deltas[0]]]
                               + proof.deltas[1:])),
                ("opening", dict(openings=[[bytes(tz21.SEED_SIZE)]
                                           + proof.openings[0][1:]]
                                 + proof.openings[1:])),
                ("hidden_ct", dict(hidden_cts=[tz21.BatchCt(
                    eph=ct.eph, cts=[ct.cts[0] + Fr(1)] + ct.cts[1:])]
                    + proof.hidden_cts[1:]))):
            bad = tz21.DkgithProof(**{**d, **change})
            run("tz21_spoiled_" + what, lambda: refuses(
                "tz21_" + what, lambda: verify(bad)), TZ21_KERNELS)

        # ---- (b) the composite over a prover's and a verifier's spec
        t0 = time.perf_counter()
        sig_params = SignatureParamsG1.generate_using_rng(hr, SPLIT_MSGS)
        issuer = KeypairG2.generate(hr, sig_params)
        bbs_sig = SignatureG1.new(hr, msgs, issuer.secret_key, sig_params)
        b23_params = SignatureParams23G1.new(b"chip-smoke split BBS23",
                                             SPLIT_MSGS)
        b23_sk = SecretKey.generate(hr)
        b23_pk = PublicKey23G2.generate(b23_sk, b23_params)
        b23_sig = Signature23G1.new(hr, msgs, b23_sk, b23_params)
        params, kp = acc_keep["params"], acc_keep["kp"]
        V, vb_wit = acc_keep["value"], acc_keep["witness"]
        kb = kb_keep["kb"]
        g2_bases = [bls.G2.rand(hr).normalize() for _ in range(2)]
        g2_wits = [Fr.rand(hr), Fr.rand(hr)]
        g2_comm = msm(g2_bases, g2_wits).normalize()
        t["composite_setup_s"] = time.perf_counter() - t0

        def tz21_statements(ve=TZ21_SET):
            return [ss.VeTZ21(comm_key=gens, enc_pk=enc_pk, enc_gen=enc_g,
                              n_parties=ve[0], reps=ve[1]),
                    ss.VeTZ21Robust(comm_key=gens, enc_pk=enc_pk,
                                    enc_gen=enc_g, n_parties=TZ21_ROBUST[0],
                                    reps=TZ21_ROBUST[1])]

        def spec_of(verifier: bool, ve=TZ21_SET):
            spec = ProofSpec(context=b"chip-smoke split")
            nm_value = kb.non_mem.value()
            if verifier:
                stmts = [
                    ss.PoKBBSSignatureG1Verifier(
                        sig_params, issuer.public_key, revealed),
                    ss.PoKBBSSignature23IETFG1Verifier(b23_params, b23_pk,
                                                       revealed),
                    ss.VBAccumulatorMembershipCDHVerifier(V, params,
                                                          kp.public_key),
                    ss.KBUniversalAccumulatorNonMembershipCDHVerifier(
                        nm_value, kb_keep["params"], kb_keep["kp"].public_key)]
            else:
                stmts = [
                    ss.PoKBBSSignatureG1Prover(sig_params,
                                               revealed_messages=revealed),
                    ss.PoKBBSSignature23IETFG1Prover(
                        b23_params, revealed_messages=revealed),
                    ss.VBAccumulatorMembershipCDHProver(V, params),
                    ss.KBUniversalAccumulatorNonMembershipCDHProver(
                        nm_value, kb_keep["params"])]
            for s in stmts + [ss.PedersenCommitmentG2(g2_bases, g2_comm)] \
                    + tz21_statements(ve):
                spec.add_statement(s)
            spec.add_witness_equality([(0, 0), (1, 0), (2, 0)])
            spec.add_witness_equality([(0, 1), (5, 0), (6, 0)])
            for i in range(1, TZ21_K):
                spec.add_witness_equality([(0, 1 + i), (5, i)])
            return spec

        def wits_of(ve_msgs=hidden):
            return [st.BBSWitness(bbs_sig, msgs),
                    sm.BBS23Witness(b23_sig, msgs),
                    st.AccumMembershipWit(element=uid, witness=vb_wit),
                    st.AccumMembershipWit(element=kb_keep["non_member"],
                                          witness=kb_keep["nm_wit"]),
                    list(g2_wits), list(ve_msgs), [msgs[1]]]

        prover_spec, verifier_spec = spec_of(False), spec_of(True)
        comp = run("proof_system_split_prove", lambda: Proof.new(
            hr, prover_spec, wits_of(), nonce=SPLIT_NONCE, device=dev),
            TZ21_KERNELS)
        for mode, cfg, need in (("none", None, TZ21_KERNELS),
                                ("lazy", VerifierConfig(True),
                                 TZ21_KERNELS + CHECKER_KERNELS),
                                ("eager", VerifierConfig(False),
                                 TZ21_KERNELS)):
            if not run(f"proof_system_split_verify_{mode}",
                       lambda: comp.verify(hr, verifier_spec,
                                           nonce=SPLIT_NONCE, config=cfg,
                                           device=dev), need):
                raise AssertionError(f"proof_system_split: verify ({mode}) "
                                     f"refused the proof")
        t0 = time.perf_counter()
        ve_proof = comp.statement_proofs[5]
        got = ve_proof.ve_proof.compress().decrypt(
            dec_sk, ve_proof.commitment, gens[:TZ21_K + 1])
        if got[:TZ21_K] != hidden:
            raise AssertionError("proof_system_split: the auditor's "
                                 "decryption of the composite differs")
        t["composite_decrypt_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        weak_spec = ProofSpec(context=b"chip-smoke guard")
        weak_spec.add_statement(tz21_statements((2, 1))[0])
        strong_spec = ProofSpec(context=b"chip-smoke guard")
        strong_spec.add_statement(tz21_statements()[0])
        weak = Proof.new(hr, weak_spec, [hidden], nonce=SPLIT_NONCE,
                         device=dev)
        if not weak.verify(hr, weak_spec, nonce=SPLIT_NONCE, device=dev):
            raise AssertionError("proof_system_split: the (2, 1) proof "
                                 "fails under its own statement")
        refuses("guard_2_1_under_16_32", lambda: weak.verify(
            hr, strong_spec, nonce=SPLIT_NONCE, device=dev), "parameters")
        refuses("prover_spec_verifies", lambda: comp.verify(
            hr, prover_spec, nonce=SPLIT_NONCE, device=dev), "prover-side")
        refuses("wrong_nonce", lambda: comp.verify(
            hr, verifier_spec, nonce=b"another nonce", device=dev))
        broken = Proof.new(hr, prover_spec, wits_of(
            [hidden[0] + Fr(1)] + hidden[1:]), nonce=SPLIT_NONCE, device=dev)
        refuses("broken_equality", lambda: broken.verify(
            hr, verifier_spec, nonce=SPLIT_NONCE, device=dev), "equality")
        t["rejections_s"] = time.perf_counter() - t0

        # ---- (c) the IETF suites
        ietf_s = {}
        msg_octets = [b"chip-smoke IETF message %d" % i
                      for i in range(IETF_MSGS)]
        for name, kat in IETF_KATS.items():
            cs = getattr(ietf, name)
            sk = cs.keygen(IETF_KEY_MATERIAL, IETF_KEY_INFO)
            pk = cs.sk_to_pk(sk)
            kat_ok = int(sk) == kat["sk"]
            if "pk" in kat:
                kat_ok &= pk.hex() == kat["pk"]
                kat_ok &= ietf.point_to_octets_g1(cs.p1()).hex() == kat["p1"]
            else:
                kat_ok &= [ietf.point_to_octets_g1(p).hex() for p in
                           cs.create_generators(3)] == kat["generators"]
            if not kat_ok:
                raise AssertionError(f"proof_system_split: {name} differs "
                                     f"from the draft's fixtures")
            tag = "ietf_" + name[len("BLS12381_"):].lower()
            sig = run(tag + "_sign", lambda: cs.sign(sk, pk, IETF_HEADER,
                                                     msg_octets))
            if not run(tag + "_verify", lambda: cs.verify(
                    pk, sig, IETF_HEADER, msg_octets, device=dev)):
                raise AssertionError(f"proof_system_split: {tag} refused "
                                     f"its signature")
            disclosed = {i: msg_octets[i] for i in IETF_DISCLOSED}
            pr = run(tag + "_proof_gen", lambda: cs.proof_gen(
                pk, sig, IETF_HEADER, SPLIT_NONCE, msg_octets,
                list(IETF_DISCLOSED), hr))
            if not run(tag + "_proof_verify", lambda: cs.proof_verify(
                    pk, pr, IETF_HEADER, SPLIT_NONCE, disclosed, IETF_MSGS,
                    device=dev)):
                raise AssertionError(f"proof_system_split: {tag} refused "
                                     f"its proof")
            bad_sig = sig[:50] + bytes([sig[50] ^ 1]) + sig[51:]
            refuses(tag + "_spoiled_signature", lambda: cs.verify(
                pk, bad_sig, IETF_HEADER, msg_octets, device=dev))
            bad_pr = pr[:150] + bytes([pr[150] ^ 1]) + pr[151:]
            refuses(tag + "_spoiled_proof", lambda: cs.proof_verify(
                pk, bad_pr, IETF_HEADER, SPLIT_NONCE, disclosed, IETF_MSGS,
                device=dev))
            ietf_s[tag] = {k: t[f"{tag}_{k}_s"] for k in
                           ("sign", "verify", "proof_gen", "proof_verify")}
    finally:
        tpairing.TPairing.miller_product = real_miller
        tz21._party_products = real_products
        if env is not None:
            os.environ[PAIRING_ENV] = env
    if not all(refused.values()):
        raise AssertionError(f"proof_system_split: not refused: {refused}")
    lazy = [n for p, n in miller if p == "proof_system_split_verify_lazy"]
    if len(lazy) != 1 or lazy[0] < RandomizedPairingChecker.DEVICE_THRESHOLD:
        raise AssertionError(f"proof_system_split: the lazy checker's device "
                             f"Miller products {lazy}")
    if len(miller) != 1:
        raise AssertionError(f"proof_system_split: device Miller products "
                             f"{miller}")
    phase("proof_system_split", tz21_set=list(TZ21_SET), tz21_messages=TZ21_K,
          robust_set=list(TZ21_ROBUST), messages=SPLIT_MSGS,
          revealed=SPLIT_REVEALED,
          tz21_prove_s=[t["tz21_prove_cold_s"], t["tz21_prove_warm_s"]],
          tz21_verify_s=[t["tz21_verify_cold_s"], t["tz21_verify_warm_s"]],
          tz21_instances=[TZ21_SET[0] * TZ21_SET[1],
                          (TZ21_SET[0] - 1) * TZ21_SET[1]],
          tz21_samples=TZ21_SAMPLES, samples_s=t["samples_s"],
          decrypt_s=t["decrypt_s"],
          prove_s=t["proof_system_split_prove_s"],
          verify_s={m: t[f"proof_system_split_verify_{m}_s"]
                    for m in ("none", "lazy", "eager")},
          composite_decrypt_s=t["composite_decrypt_s"],
          rejections_s=t["rejections_s"], ietf_s=ietf_s,
          setup_s=[t["setup_s"], t["composite_setup_s"]],
          deferred_pairs=lazy[0],
          launches={p: {n: c for n, c in v.items() if c}
                    for p, v in paths.items()},
          refused=refused, correct=True)
    return paths, captured


def bn254_msm_phases(counted, dev) -> tuple:
    """BN254 G1 at the reference's full size: 2^20 bench points with known
    discrete logs (two full adds and a normalize at 8 limbs, as on
    BLS12-381), `BN254_MSM_RUNS` timed MSMs at c = 16 on the
    fast levels, each equal to its known-dlog sum with no rerun, one
    `safe=True` MSM, the rerun path (one duplicated base colliding in one
    window: exactly the spoiled windows rerun), and the edge MSMs of G1
    (8 duplicate bases, rerun through the total narrow level; 300 points
    with one scalar) and G2 (duplicates, P and -P, infinity, zero and
    equal scalars).  Returns ({path: (launches, level widths)}, what the
    kernel checks need)."""
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
    from crypto_tpu_torch.ops import msm_v2
    n, R, thr = 1 << N_LOG, bn.R, msm_v2.CHUNK_MIN_PAIRS
    tc = tcurve_for(bn.G1, dev)
    G = bn.G1.generator()
    paths = {}

    # ---- bench points: 2^20 distinct points, full add + normalize
    t0 = time.time()
    (points, dlog), bp = drive(counted, lambda: make_bench_points(tc, n))
    torch.cuda.synchronize()
    t_points = time.time() - t0
    require("bn254 bench points", bp, ("jacobian_add", "jacobian_normalize"))
    if (bp["jacobian_add"], bp["jacobian_normalize"]) != (2, 1):
        raise AssertionError(f"bn254 bench points: expected 2 full adds "
                             f"and 1 normalize, got {bp}")
    logs = [dlog(i) for i in range(n)]
    sample = list(range(0, n, n // 64))
    got = tc.unpack(TPoints(*(t[:, sample] for t in points)))
    if any(g != G.mul_raw(logs[i]) for g, i in zip(got, sample)):
        raise AssertionError("bn254 bench points disagree with their "
                             "discrete logs")
    paths["bn254_bench_points_2^20"] = (bp, [])
    phase("bn254_bench_points", n=n, seconds=round(t_points, 3),
          full_add_launches=bp["jacobian_add"],
          normalize_launches=bp["jacobian_normalize"],
          sample_checked=len(sample), correct=True)

    # ---- the 2^20 MSM, c = 16, fast levels
    _, warm = make_bench_scalars(R, n, SEED + 200)
    msm_v2.msm_device_scheduled(bn.G1, points, warm, c=16)
    secs, runs = [], []
    for run in range(BN254_MSM_RUNS):
        sc, sb = make_bench_scalars(R, n, SEED + 201 + run)
        timings = {}
        torch.cuda.synchronize()

        def timed():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bn.G1, points, sb, c=16,
                                              timings=timings)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed)
        if result != G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % R):
            raise AssertionError("bn254 2^20 MSM disagrees with the "
                                 "known-dlog result")
        if timings["rerun_windows"] or any(launches[k] for k in
                                           SAFE_KERNELS + FQ2_KERNELS):
            raise AssertionError(f"bn254 2^20 MSM on distinct bases reran "
                                 f"{timings['rerun_windows']} or launched "
                                 f"a total-formula or an Fq2 kernel: "
                                 f"{launches}")
        require("bn254 2^20 MSM", launches,
                level_kernels(timings["level_pairs"], [], thr))
        secs.append(dt)
        runs.append((launches, timings))
        phase("bn254_msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(timings), rerun_windows=[], correct=True)
    launches, timings = runs[0]
    main_widths = timings["level_pairs"]
    paths["bn254_msm_2^20"] = (launches, main_widths)
    med = statistics.median(secs)
    phase("bn254_msm", n=n, c=16, runs=BN254_MSM_RUNS, seconds=secs,
          median_s=med, spread=max(secs) / min(secs), points_per_s=n / med,
          level_pairs=main_widths, slots=timings["slots"],
          launches={k: v for k, v in launches.items() if v}, correct=True)

    # ---- safe=True once on fresh scalars
    sc, sb = make_bench_scalars(R, n, SEED + 240)
    t_s = {}
    t0 = time.perf_counter()
    res, safe_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bn.G1, points, sb, c=16, safe=True, timings=t_s))
    dt_s = time.perf_counter() - t0
    if res != G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % R) \
            or t_s["rerun_windows"]:
        raise AssertionError("bn254 2^20 MSM with safe=True disagrees with "
                             "the known-dlog result or reran")
    require("bn254 safe 2^20 MSM", safe_launches,
            level_kernels([], t_s["level_pairs"], thr))
    paths["bn254_msm_safe_2^20"] = (safe_launches, t_s["level_pairs"])
    phase("bn254_msm_safe", n=n, seconds=dt_s, phases=floats(t_s),
          correct=True)

    # ---- the rerun path: a duplicated base collides in window w0's bucket
    sc, sb = make_bench_scalars(R, n, SEED + 250)
    dh = msm_v2.device_digits(sb, 16, bn.Fr.bits).cpu().numpy()
    W, B, w0 = dh.shape[0], 1 << 15, 5
    i_b = next(k for k in range(11, n) if dh[w0, k] != 0)
    j_b = next(k for k in range(n // 2, n)
               if all(dh[w, k] != dh[w, i_b] for w in range(W) if w != w0))
    v0 = int(dh[w0, i_b])
    lane = np.arange(n)
    moved = np.nonzero((np.abs(dh[w0]) == abs(v0)) & (lane != i_b)
                       & (lane != j_b))[0]
    new = np.sign(dh[w0, moved]) * ((abs(v0) + np.arange(moved.size)) % B
                                    + 1)
    logs_r = list(logs)
    logs_r[j_b] = logs[i_b]
    shift = 1 << (16 * w0)
    expect_s = sum(s * d for s, d in zip(sc, logs_r))
    expect_s += (v0 - int(dh[w0, j_b])) * shift * logs_r[j_b]
    expect_s += sum((int(a) - int(b)) * shift * logs_r[k]
                    for k, a, b in zip(moved, new, dh[w0, moved]))
    dh[w0, moved] = new
    dh[w0, j_b] = v0
    pts_r = TPoints(*(t.clone() for t in points))
    for t in pts_r:
        t[:, j_b] = t[:, i_b]
    t_rr = {}
    t0 = time.perf_counter()
    res_r, rr_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bn.G1, pts_r, torch.from_numpy(dh).to(dev), c=16, timings=t_rr))
    dt_r = time.perf_counter() - t0
    del pts_r
    if res_r != G.mul_raw(expect_s % R):
        raise AssertionError("bn254 2^20 rerun MSM disagrees with the "
                             "known-dlog result")
    spoiled = spoiled_windows(t_rr)
    if w0 not in spoiled or t_rr["rerun_windows"] != spoiled:
        raise AssertionError(f"bn254 rerun path: collision in window {w0}, "
                             f"spoiled windows {spoiled}, rerun "
                             f"{t_rr['rerun_windows']}")
    rr_widths = rerun_widths(t_rr)
    require("bn254 2^20 rerun", rr_launches,
            level_kernels(t_rr["level_pairs"], rr_widths, thr))
    paths["bn254_rerun_2^20"] = (rr_launches, rr_widths)
    phase("bn254_rerun_msm", n=n, collision_window=w0, bases=[i_b, j_b],
          rerun_windows=spoiled, rerun_level_pairs=rr_widths, seconds=dt_r,
          phases=floats(t_rr), correct=True)

    # ---- G1 edge MSMs: 8 duplicate bases, and 300 points with one scalar
    p0 = G.mul_raw(random.Random(SEED + 251).randrange(1, R))
    m_eq, s_eq = 300, 0x1234567890ABCDEF
    sub = TPoints(*(t[:, :m_eq].contiguous() for t in points))
    t_dup, t_eq = {}, {}
    (dup, eq_res), edge_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bn.G1, [p0] * 8, [7] * 8, timings=t_dup),
        msm_v2.msm_device_scheduled(bn.G1, sub, [s_eq] * m_eq,
                                    timings=t_eq)))
    if dup != p0.mul_raw(56) \
            or eq_res != G.mul_raw(s_eq * sum(logs[:m_eq]) % R):
        raise AssertionError("bn254 edge MSMs disagree with the host")
    if 0 not in t_dup["rerun_windows"] \
            or t_dup["rerun_windows"] != spoiled_windows(t_dup) \
            or t_eq["rerun_windows"]:
        raise AssertionError(f"bn254 edge MSMs: rerun "
                             f"{t_dup['rerun_windows']} and "
                             f"{t_eq['rerun_windows']}")
    edge_widths = t_dup["level_pairs"] + t_eq["level_pairs"]
    edge_safe = rerun_widths(t_dup)
    require("bn254 edge MSM", edge_launches,
            level_kernels(edge_widths, edge_safe, thr)
            | set(LEVEL_KERNELS[("narrow", True)]))
    paths["bn254_edge_msm"] = (edge_launches, edge_widths)
    phase("bn254_edge_msm", duplicate_bases=True, all_equal_scalars_n=m_eq,
          level_pairs=edge_widths, rerun_windows=t_dup["rerun_windows"],
          rerun_level_pairs=edge_safe, correct=True)

    # ---- G2 edge MSMs on the Fq2 levels: no flag, no rerun
    G2 = bn.G2.generator()
    hr = random.Random(SEED + 260)
    q0, q1, *qs = (G2.mul_raw(hr.randrange(1, R)) for _ in range(8))
    e_pts = [q0] * 6 + [q1, -q1, bn.G2.infinity(), q0.double()] + qs
    e_sc = [7] * 6 + [9, 9, 5, 0, 0, 3, 7, 11, 2, 13]
    e_expect = bn.G2.infinity()
    for p_, s_ in zip(e_pts, e_sc):
        e_expect = e_expect + p_.mul_raw(s_)
    eq_logs = [hr.randrange(1, R) for _ in range(64)]
    eq_pts = known_log_points(G2, eq_logs, dev)
    t_e1, t_e2 = {}, {}
    (e_res, eq2_res), edge2_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bn.G2, e_pts, e_sc, timings=t_e1),
        msm_v2.msm_device_scheduled(bn.G2, eq_pts, [s_eq] * len(eq_pts),
                                    timings=t_e2)))
    if e_res != e_expect or eq2_res != G2.mul_raw(s_eq * sum(eq_logs) % R):
        raise AssertionError("bn254 G2 edge MSMs disagree with the host")
    not_g2 = G1_LEVEL_KERNELS + POINT_KERNELS
    require("bn254 G2 edge MSM", edge2_launches, G2_KERNELS)
    if any(edge2_launches[k] for k in not_g2) or t_e1["rerun_windows"] \
            or t_e2["rerun_windows"]:
        raise AssertionError(f"bn254 G2 edge MSM: a G1 kernel or a rerun: "
                             f"{edge2_launches}")
    g2_edge_widths = t_e1["level_pairs"] + t_e2["level_pairs"]
    paths["bn254_g2_edge_msm"] = (edge2_launches, g2_edge_widths)
    phase("bn254_g2_edge_msm", points=[len(e_pts), len(eq_pts)],
          level_pairs=g2_edge_widths, rerun_windows=[], correct=True)
    return paths, dict(points=points, sb=sb, main_widths=main_widths,
                       slots=timings["slots"], rr_widths=rr_widths,
                       safe_widths=t_s["level_pairs"],
                       edge_widths=edge_widths, edge_safe=edge_safe,
                       g2_edge_widths=g2_edge_widths)


def bn254_pairing_phase(counted, dev) -> tuple:
    """`TPairingBN` at `bench_pairing.py`'s size: 64 BN254 pairs from known
    logs plus one with G1 at infinity, one multi-pairing on the card,
    timed (the process's first BN254 pairing) and counted, equal to
    e(G1, G2)^(sum a_i b_i) and to the port's host `bn254` multi-pairing,
    its per-pair Miller values against the host Miller loop; e(aP, bQ) ==
    e(abP, Q).  Returns (launches, the pair set to profile)."""
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    R = bn.R
    G1, G2 = bn.G1.generator(), bn.G2.generator()
    tp = tpairing_for("bn254", dev)
    hr = random.Random(SEED + 300)
    t0 = time.perf_counter()
    la = [hr.randrange(1, R) for _ in range(PAIRS)]
    lb = [hr.randrange(1, R) for _ in range(PAIRS)]
    A, B = known_log_points(G1, la, dev), known_log_points(G2, lb, dev)
    pairs = list(zip(A, B)) + [(bn.G1.infinity(), B[0])]
    log = sum(x * y for x, y in zip(la, lb)) % R
    gt = bn.pairing(G1, G2)
    t_setup = time.perf_counter() - t0

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = tp.multi_pairing(pairs)
        return out, time.perf_counter() - t

    (out, dt), launches = drive(counted, timed)
    t0 = time.perf_counter()
    lanes = tp.t12.unpack_host(tp.miller_loop_batch(*tp.pack_pairs(pairs)))
    if any(m != bn.miller_loop([pq]) for m, pq in zip(lanes, pairs)):
        raise AssertionError("bn254_pairing_64: a lane's Miller value "
                             "differs from the host Miller loop")
    if out != bn.multi_pairing(pairs) or out != gt ** log:
        raise AssertionError("bn254_pairing_64: the product differs from "
                             "the host multi-pairing or its known log")
    t_check = time.perf_counter() - t0
    require("bn254_pairing_64", launches, PAIRING_KERNELS)
    if any(launches[k] for k in G1_LEVEL_KERNELS + POINT_KERNELS):
        raise AssertionError(f"bn254_pairing_64 launched a level or point "
                             f"kernel: {launches}")
    a, b = hr.randrange(1, R), hr.randrange(1, R)
    aP, bQ = G1.mul_raw(a).normalize(), G2.mul_raw(b).normalize()
    abP = G1.mul_raw(a * b % R).normalize()
    if not tp.multi_pairing([(aP, bQ), (-abP, G2)]).is_one():
        raise AssertionError("bn254_pairing_64: e(aP, bQ) != e(abP, Q)")
    phase("bn254_pairing_64", pairs=PAIRS, infinite_pairs=1, runs=1,
          seconds=[dt], median_s=dt, first_call=True,
          pairings_per_s=PAIRS / dt, setup_s=t_setup, host_check_s=t_check,
          launches={k: v for k, v in launches.items() if v}, bilinear=True,
          correct=True)
    return launches, pairs


def bn254_kernel_checks(row, agree, paths, data, dev) -> list:
    """Every L = 8 instantiation held bit for bit against its plain version
    at the BN254 paths' own shapes, with ragged widths, dead lanes and
    infinite operands, as the L = 12 checks are; returns the kernels-line
    rows (`row`) of each at its path's shape."""
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tcurve import tcurve_for
    from crypto_tpu_torch.fields.tfield import tfield_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    csrc = "crypto_tpu_torch/csrc/"
    ref = "crypto_tpu/ops/pallas/curve_kernels.py:"
    mref = "crypto_tpu/ops/pallas/field_kernels.py:386"
    thr = msm_v2.CHUNK_MIN_PAIRS
    tc, tc2 = tcurve_for(bn.G1, dev), tcurve_for(bn.G2, dev)
    F, F2 = tc.F, tc2.F
    points = data["points"]
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    hr = random.Random(SEED + 401)
    P = bn.P

    # the prove's own b_g2 MSM (`legogroth16_phases` at BN254_LEGO_LOG),
    # rerun outside the counted paths on its points and scalars: its
    # window size, level widths and slot counts are the prove's, for the
    # Fq2 level's, the Fq2 product's and the G2 gather's shapes
    g2 = data["prove_g2_msm"]
    pts2 = g2["points"]
    n2 = pts2.X.shape[1]
    c2 = msm_v2._auto_c_v2(n2)
    t2 = {}
    res2 = msm_v2.msm_device_scheduled(bn.G2, pts2, g2["scalars"],
                                       timings=t2)
    if res2 != g2["out"]:
        raise AssertionError("bn254 rerun of the prove's b_g2 MSM "
                             "disagrees with the prove's")

    def lvl(M, pts, Fx):
        # operands among the finite points (a query may hold infinity)
        live = torch.nonzero(~Fx.is_zero(pts.Z)).flatten()
        n = live.numel()
        i1 = live[torch.randint(0, n, (M,), generator=gen, device=dev)]
        i2 = live[torch.randint(0, n, (M,), generator=gen, device=dev)]
        lane = torch.arange(M, device=dev)
        i2 = torch.where(lane % 7 < 2, i1, i2)
        x1, y1, x2, y2 = pts.X[:, i1], pts.Y[:, i1], pts.X[:, i2], \
            pts.Y[:, i2]
        y2 = torch.where((lane % 7 == 1)[None], Fx.neg(y2), y2)
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    def add_row(name, src, rep, path, err, fn, plain_ms, args, shape, **kw):
        rows.append(row(name, src, rep, path, err, cuda_ms(fn), plain_ms,
                        args, shape, **kw))

    # ---- the bench points' full add (at their 2^14 and 2^20 rows) and
    # normalize (2^20 points) at 8 limbs, with the 12-limb checks' warps
    # of one kind, ragged widths and infinite points
    from crypto_tpu_torch.ops.kernels import point_kernels as pk
    n = points.X.shape[1]
    bp_path = "bn254_bench_points_2^20"
    for M in (1 << 14, n):
        J, Q, _ = jacobian_inputs(F, lvl(M, points, F), points.X[
            :, torch.randint(0, n, (M,), generator=gen, device=dev)])
        args = J + Q
        pa, add_ms = timed_call(lambda: pk.jacobian_add_plain(F, *args))
        e_add = agree("jacobian_add", pk.jacobian_add(F, *args), pa,
                      f"on bn254 at M={M}")
        if int(pa[3].sum()) == 0:
            raise AssertionError("bn254 full-add check inputs hold no P + P")
    add_row("jacobian_add", csrc + "jacobian.cu", ref + "334", bp_path,
            e_add, lambda: pk.jacobian_add(F, *args), add_ms, (F,) + args,
            [8, n])
    warps_ms = check_full_add_warps(F, J, Q, agree)
    pn, norm_ms = timed_call(lambda: pk.jacobian_normalize_plain(F, *J))
    e_norm = agree("jacobian_normalize", pk.jacobian_normalize(F, *J), pn,
                   f"on bn254 at M={n}")
    add_row("jacobian_normalize", csrc + "normalize.cu", ref + "390",
            bp_path, e_norm, lambda: pk.jacobian_normalize(F, *J), norm_ms,
            (F,) + J, [8, n])
    cases = check_normalize_cases(F, J, pn, agree)
    phase("check_point_kernels_bn254", full_add_rows=[1 << 14, n],
          full_add_warps_of_one_kind=True, full_add_warps_ms=warps_ms,
          normalize_points=n, normalize_infinite=int(F.is_zero(J[2]).sum()),
          normalize_checked=cases,
          bound_chain_squares_products=list(chain_ops(bn.P - 2)),
          bit_exact=True)

    # ---- mont_mul at the G1 tail's width and ragged, Fr at the 2^16 NTT's
    # stage, the pairing's base products; mont_pow's roots
    for fld, M, path in ((bn.Fq, 16 << 15, "bn254_msm_2^20"),
                         (bn.Fq, (16 << 15) - 3, None),
                         (bn.Fr, 1 << 15, None),
                         (bn.Fq, 2 * (PAIRS + 1), "bn254_pairing_64")):
        Fx = tfield_for(fld, dev)
        ra = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        rb = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        ra[:, :4] = Fx.pack([0, 1, fld.p - 1, fld.p - 1], mont=False)
        rb[:, :4] = ra[:, :4].flip(1)
        ra[:, 4] = rb[:, 5] = -1
        plain, plain_ms = timed_call(lambda: fk.mont_mul_plain(ra, rb,
                                                               Fx.mod))
        err = agree("mont_mul", (fk.mont_mul(ra, rb, Fx.mod),), (plain,),
                    f"on {fld.name} at M={M}")
        if path:
            add_row("mont_mul", csrc + "mont_mul.cu", mref, path, err,
                    lambda: fk.mont_mul(ra, rb, Fx.mod), plain_ms,
                    (ra, rb, Fx.mod), [8, M])
    # mont_pow: the plain version once over every width's inputs side by
    # side (it is lane by lane), and alone at the row's shape
    xs = []
    for M, zero, path in ((1, False, "bn254_msm_2^20"), (1, True, None),
                          (16, False, None), (1 << 16, False, None)):
        x = F.pack([0 if zero else hr.randrange(1, P) for _ in range(M)])
        x[:, 3::5] = 0
        xs.append((M, path, x))
    whole = fk.mont_pow_plain(torch.cat([x for *_, x in xs], 1), P - 2,
                              F.mod)
    at = 0
    for M, path, x in xs:
        err = agree("mont_pow", (fk.mont_pow(x, P - 2, F.mod),),
                    (whole[:, at:at + M],), f"on bn254.Fq at M={M}")
        at += M
        if path:
            pw, pw_ms = timed_call(lambda: fk.mont_pow_plain(x, P - 2,
                                                             F.mod))
            err = agree("mont_pow", (fk.mont_pow(x, P - 2, F.mod),), (pw,),
                        f"on bn254.Fq at M={M}")
            add_row("mont_pow", csrc + "mont_mul.cu", mref, path, err,
                    lambda: fk.mont_pow(x, P - 2, F.mod), pw_ms,
                    (x, P - 2, F.mod), [8, M])
    phase("check_mont_mul_bn254", fq=[16 << 15, (16 << 15) - 3,
                                      2 * (PAIRS + 1)], fr=[1 << 15],
          mont_pow=[1, 16, 1 << 16], zeros=True, bit_exact=True)

    # ---- the one-launch narrow levels, both formulas, at the edge MSMs'
    # widest narrow width (the row), every narrow width of the BN254 G1
    # paths and LEVEL_WIDTHS; then the split level against them
    def narrow(*lists):
        return sorted({w for ws in lists for w in ws if w < thr})

    for fast, edge_w, more in (
            (False, data["edge_safe"], narrow(data["edge_safe"],
                                              data["safe_widths"],
                                              data["rr_widths"])),
            (True, data["edge_widths"], narrow(data["edge_widths"],
                                               data["main_widths"]))):
        rows.extend(check_narrow_levels(
            row, agree, F, lambda M: lvl(M, points, F), fast,
            "bn254_edge_msm", max(narrow(edge_w)), more))
    level_timings(F, lambda M: lvl(M, points, F))

    # ---- the chunked levels at 524,288 pairs, a width of both the rerun
    # (total formula) and the 2^20 MSM (fast) and the width of the
    # BLS12-381 rows; ragged, and every warp holding an infinite operand
    def chunked(M, inf_warps=False):
        pad = (-M) % msm_v2.CHUNK_PAD
        x1, y1, m1, x2, y2, m2 = lvl(M, points, F)
        x1, y1, x2, y2 = (msm_v2._pad_cols(t, pad, 0)
                          for t in (x1, y1, x2, y2))
        m1, m2 = msm_v2._pad_cols(m1, pad, 1), msm_v2._pad_cols(m2, pad, 1)
        if inf_warps:
            Mp = x1.shape[1]
            lane = torch.arange(Mp, device=dev)
            warp = lane % (Mp // ck.CHUNK_K) // 32
            m1 = ((warp % 4 == 0) | (warp % 4 == 2)
                  | ((warp % 4 == 3) & (lane % 3 == 0))).to(torch.int32)
            m2 = ((warp % 4 == 1) | (warp % 4 == 2)
                  | ((warp % 4 == 3) & (lane % 3 == 1))).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    for fast, path, widths in ((False, "bn254_rerun_2^20",
                                data["rr_widths"]),
                               (True, "bn254_msm_2^20",
                                data["main_widths"])):
        chunk_widths = sorted(w for w in widths if w >= thr)
        w_chunk = 1 << 19 if 1 << 19 in chunk_widths else \
            chunk_widths[len(chunk_widths) // 2]
        if fast:
            prefix, down = ck.chunked_level_prefix_fast, \
                ck.chunked_level_down_fast
            prefix_p = ck.chunked_level_prefix_fast_plain
            down_p = ck.chunked_level_down_fast_plain
        else:
            prefix, down = ck.chunked_level_prefix, ck.chunked_level_down
            prefix_p = ck.chunked_level_prefix_plain
            down_p = ck.chunked_level_down_plain
        for M, iw in ((w_chunk, False), (w_chunk + 5, False),
                      (w_chunk, True)):
            ins = chunked(M, iw)
            kq = prefix(F, *ins)
            pq, prefix_ms = timed_call(lambda: prefix_p(F, *ins))
            e_pre = agree(prefix.__name__, kq, pq, f"at bn254 M={M}")
            total = kq[1].clone()
            total[0] |= F.is_zero(total).to(torch.int32)
            args = ins + (kq[0], msm_v2.batch_inv_t(F, total)) \
                + (() if fast else (kq[2],))
            pdn, down_ms = timed_call(lambda: down_p(F, *args))
            e_down = agree(down.__name__, down(F, *args), pdn,
                           f"at bn254 M={M}")
            if M == w_chunk and not iw:
                lines = ("669", "683") if fast else ("844", "860")
                Mp = ins[0].shape[1]
                add_row(prefix.__name__, csrc + "chunked_level.cu",
                        ref + lines[0], path, e_pre,
                        lambda: prefix(F, *ins), prefix_ms, (F,) + ins,
                        [8, Mp])
                add_row(down.__name__, csrc + "chunked_level.cu",
                        ref + lines[1], path, e_down,
                        lambda: down(F, *args), down_ms, (F,) + args,
                        [8, Mp])
    phase("check_chunked_level_bn254", infinite_operand_in_every_warp=True,
          bit_exact=True)

    # ---- the Fq2 level at the prove's b_g2 MSM's narrowest level (its
    # rerun), ragged, the G2 edge MSMs' widest and 96 pairs whose
    # first warp mixes doublings, P + (-P) and infinite operands
    g2_widths = t2["level_pairs"]
    w_lvl = min(g2_widths)
    for M in (w_lvl, w_lvl + 5, max(data["g2_edge_widths"]), 96):
        ins = lvl(M, pts2, F2)
        kd = ck.affine_level_pre_fq2(F2, *ins)
        pd, pre_ms = timed_call(lambda: ck.affine_level_pre_plain(F2, *ins))
        e_pre = agree("affine_level_pre_fq2", kd, pd, f"at bn254 M={M}")
        x1, y1, m1, x2, y2, m2 = ins
        args = (x1, y1, x2, y2, msm_v2.batch_inv_t(F2, kd[0]), kd[1], m1,
                m2)
        pp, post_ms = timed_call(lambda: ck.affine_level_post_plain(F2,
                                                                    *args))
        e_post = agree("affine_level_post_fq2",
                       ck.affine_level_post_fq2(F2, *args), pp,
                       f"at bn254 M={M}")
        if M == 96 and not all(int(t.sum()) for t in (
                kd[1][:32], kd[2][:32] & (m1[:32] == 0) & (m2[:32] == 0),
                m1[:32], m2[:32])):
            raise AssertionError("bn254 Fq2 level inputs: a warp without a "
                                 "doubling, P + (-P) or an infinite operand")
        if M == w_lvl:
            add_row("affine_level_pre_fq2", csrc + "affine_level_fq2.cu",
                    ref + "1014", "bn254_legogroth16_prove", e_pre,
                    lambda: ck.affine_level_pre_fq2(F2, *ins), pre_ms,
                    (F2,) + ins, [16, M])
            add_row("affine_level_post_fq2", csrc + "affine_level_fq2.cu",
                    ref + "1029", "bn254_legogroth16_prove", e_post,
                    lambda: ck.affine_level_post_fq2(F2, *args), post_ms,
                    (F2,) + args, [16, M])
    phase("check_affine_level_fq2_bn254", pairs=[w_lvl, w_lvl + 5,
                                                 max(data["g2_edge_widths"]),
                                                 96], g2_prove_level_pairs=
          g2_widths, bit_exact=True)

    # ---- the Fq2 product and square: at the prove's first product-tree
    # width and the pairing's line products (15 a lane) and squares (4 a
    # lane), random coordinates with the edges 0, 1, u, (p-1)(1 + u) and
    # the canonical limbs that bound the lazy reduction
    edges2 = F2.pack([bn.Fq2(0, 0), bn.Fq2(1, 0), bn.Fq2(0, 1),
                      bn.Fq2(P - 1, P - 1)])
    limb_edges = F2.pack([bn.Fq2(P - 1, P - 1), bn.Fq2(0, P - 1),
                          bn.Fq2(P - 1, 0), bn.Fq2(1, 0), bn.Fq2(P - 1, 1)],
                         mont=False)
    lanes = PAIRS + 1
    for M, path in ((w_lvl // 2, "bn254_legogroth16_prove"),
                    (w_lvl // 2 - 3, None),
                    (15 * lanes, "bn254_pairing_64")):
        a = pts2.X[:, torch.randint(0, n2, (M,), generator=gen, device=dev)]
        b = pts2.Y[:, torch.randint(0, n2, (M,), generator=gen, device=dev)]
        a[:, :4], b[:, :4] = edges2, edges2.flip(1)
        a[:, 5:10], b[:, 5:10] = limb_edges, limb_edges
        a[:, 10:15], b[:, 10:15] = limb_edges, limb_edges.flip(1)
        pm, pm_ms = timed_call(lambda: fk.fq2_mul_plain(F, a, b))
        err = agree("fq2_mul", (fk.fq2_mul(F, a, b),), (pm,),
                    f"at bn254 M={M}")
        if path:
            add_row("fq2_mul", csrc + "fq2_mul.cu", ref + "1066", path, err,
                    lambda: fk.fq2_mul(F, a, b), pm_ms, (F, a, b), [16, M])
        a = a.clone()
        a[8:, 15] = a[:8, 15]                        # a0 = a1
        a[8:, 16] = 0                                # a1 = 0
        sq_M = 4 * lanes if path == "bn254_pairing_64" else M
        a = a[:, :sq_M].contiguous()
        ps, ps_ms = timed_call(lambda: fk.fq2_sqr_plain(F, a))
        err = agree("fq2_sqr", (fk.fq2_sqr(F, a),), (ps,),
                    f"at bn254 M={sq_M}")
        if path:
            add_row("fq2_sqr", csrc + "fq2_mul.cu", ref + "908", path, err,
                    lambda: fk.fq2_sqr(F, a), ps_ms, (F, a), [16, sq_M])
    phase("check_fq2_bn254", fq2_mul=[w_lvl // 2, w_lvl // 2 - 3,
                                      15 * lanes],
          fq2_sqr=[w_lvl // 2, w_lvl // 2 - 3, 4 * lanes], limb_edges=True,
          bit_exact=True)

    # ---- the slot tables and the gather at 8 words a row (the 2^20 G1
    # MSM's layout) and 16 (the prove's b_g2 MSM's): each point once a window at
    # random slots, the rest empty, then a ragged count with indices past
    # the table and below -1 and an all-dead tile; the library call is
    # index_select on the clamped index with a zero fill
    g_line = {}
    for tag, Fx, pts, slots, W, path in (
            ("g1", F, points, data["slots"], (bn.Fr.bits + 16) // 16,
             "bn254_msm_2^20"),
            ("g2", F2, pts2, t2["slots"], (bn.Fr.bits + c2) // c2,
             "bn254_legogroth16_prove")):
        n = pts.X.shape[1]
        y = pts.Y.clone()
        y[:, ::4097] = 0
        pt, tables_ms = timed_call(lambda: fk.slot_tables_plain(Fx, pts.X,
                                                                 y))
        e_t = agree("slot_tables", fk.slot_tables(Fx, pts.X, y), pt,
                    f"on bn254 {tag}")
        add_row("slot_tables", csrc + "gather.cu",
                "crypto_tpu/ops/msm_v2.py:719", path, e_t,
                lambda: fk.slot_tables(Fx, pts.X, y), tables_ms,
                (Fx, pts.X, y), [Fx.U, n])
        tab = pt[0]
        for M in (max(slots), n + 3):
            live = min(M, W * n)
            idx = torch.full((M,), -1, dtype=torch.int64, device=dev)
            pos = torch.randperm(M, generator=gen, device=dev)[:live]
            idx[pos] = torch.cat([torch.randperm(n, generator=gen,
                                                 device=dev)
                                  for _ in range(W)])[:live]
            if M == n + 3:
                idx[:3] = torch.tensor([n, n + 9, -5], device=dev)
                idx[256:512] = -1
            pg, gather_ms = timed_call(lambda: fk.gather_rows_t_plain(tab,
                                                                      idx))
            e_g = agree("gather_rows_t", (fk.gather_rows_t(tab, idx),),
                        (pg,), f"on bn254 {tag} at M={M}")
            if M == n + 3:
                break

            def library():
                return tab.t().index_select(1, idx.clamp(min=0)) \
                    .masked_fill_(idx < 0, 0)

            agree("index_select", (library(),), (pg,), f"at bn254 M={M}")
            t_library = cuda_ms(library)
            add_row("gather_rows_t", csrc + "gather.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:356", path, e_g,
                    lambda: fk.gather_rows_t(tab, idx), gather_ms,
                    (tab, idx), [Fx.U, M], library_ms=t_library)
            g_line[tag] = dict(U=Fx.U, slots=M, live=live,
                               library_ms=t_library)
    phase("check_gather_bn254", **g_line, dead_tile=[256, 512],
          bit_exact=True)
    return rows


# ---- BASELINE config 5's multi-GPU path, on one card
SHARDS = 4                          # MSM shards and NTT ranks run in turn
SHARDED_NTT_LOG = 20                # the sharded NTT's domain: 2^20 Fr


def sharded_msm_phase(counted, dev, points, logs, sc, sb, single) -> tuple:
    """The sharded 2^20 G1 MSM (`parallel/sharded_msm_v2.py`) on the main
    MSM's points and scalars (c = 16, fast levels): (a) `msm_sharded_v2`
    in the process group main() opened, a world of one on NCCL; (b)
    `msm_shards_in_turn` over 4 shards of 2^18 points: each shard's
    `shard_bucket_sums` on the grid of the largest bucket of any shard,
    `combine_bucket_shards` (ndev = 4: its first level adds 2 x 16 x 2^15
    bucket pairs on the chunked total formula, with `batch_inv_t`'s
    mont_mul and mont_pow), the tail and the host Horner.  Each equal to
    the known-dlog value and to `single`, the main MSM's result on the
    same scalars; no window rerun.  Each runs twice: with the launch
    counts reset before it and read after and every launch's arguments
    kept (`capture_launches`), then bare, timed.  Returns ({path:
    (launches, level widths)}, {path: captured launches})."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves.tcurve import TPoints
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.parallel import sharded_msm_v2 as sm
    G = bls.G1.generator()
    n = points.X.shape[1]
    expect = G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % bls.R)
    if single != expect:
        raise AssertionError("sharded MSM: the main MSM's result is not the "
                             "known-dlog value")
    thr = msm_v2.CHUNK_MIN_PAIRS
    m = n // SHARDS
    shards = [(TPoints(*(t[:, i * m:(i + 1) * m].contiguous()
                         for t in points)), sb[i * m:(i + 1) * m])
              for i in range(SHARDS)]
    B = 1 << 15
    runs = (("sharded_msm_world1", "sharded_msm_world1_2^20",
             "world of one",
             lambda t: sm.msm_sharded_v2(bls.G1, points, sb, c=16,
                                         device=dev, timings=t)),
            ("sharded_msm_in_turn", f"sharded_msm_{SHARDS}_in_turn_2^20",
             f"{SHARDS} shards in turn",
             lambda t: sm.msm_shards_in_turn(bls.G1, shards, 16, device=dev,
                                             timings=t)))
    paths, captured = {}, {}
    for name, path, what, fn in runs:
        t_c, t = {}, {}
        (res_c, seen), launches = drive(
            counted, lambda: capture_launches(counted, lambda: fn(t_c)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(t)
        secs = time.perf_counter() - t0
        per = t.get("shards", [t])
        reruns = [tt["rerun_windows"] for tt in t_c.get("shards", [t_c])
                  + per]
        if res_c != expect or res != expect or any(reruns):
            raise AssertionError(f"sharded MSM, {what}: wrong result or "
                                 f"windows rerun {reruns}")
        widths = [w for tt in per for w in tt["level_pairs"]]
        kernels = level_kernels(widths, [], thr)
        if "shards" in t:
            kernels |= set(LEVEL_KERNELS[("chunked", True)])
        require(f"sharded MSM, {what}", launches, kernels)
        paths[path] = (launches, widths)
        captured[path] = seen
        phase(name, n=n, shards=len(per), pad=t["pad"], seconds=secs,
              phases=floats(t), shard_level_pairs=per[0]["level_pairs"],
              slots=per[0]["slots"],
              combine_pairs=[(len(per) >> (i + 1)) * 16 * B
                             for i in range((len(per) - 1).bit_length())],
              launches={k: v for k, v in launches.items() if v},
              equals_msm_device_scheduled=True, correct=True)
    return paths, captured


def sharded_ntt_phase(counted, dev) -> tuple:
    """The four-step NTT (`parallel/sharded_ntt.py`) of 2^20 random Fr
    elements (canonical limbs drawn on the card): 4 ranks in turn through
    `rank_step` and `natural_order`, and `sharded_ntt_t` in main()'s
    world of one, both equal to the port's single-device NTT.  Each runs
    as the MSM's paths do: counted and captured, then bare, timed.
    Returns ({path: (launches, [])}, {path: captured launches})."""
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.ops.ntt import domain_for
    from crypto_tpu_torch.parallel import sharded_ntt as sn
    n = 1 << SHARDED_NTT_LOG
    gen = torch.Generator(device=dev).manual_seed(SEED + 310)
    a = torch.randint(-(1 << 31), 1 << 31, (8, n), generator=gen,
                      dtype=torch.int32, device=dev)
    a[7] &= 0x0FFFFFFF                  # below 2^252 < r: canonical
    dom = domain_for(bls.Fr, n, dev)
    want, single_ms = timed_call(lambda: dom.ntt(a))
    t0 = time.perf_counter()
    plan = sn.plan_for(bls.Fr, n, SHARDS, dev)
    plan_s = time.perf_counter() - t0
    sn.plan_for(bls.Fr, n, 1, dev)      # the world of one's plan, untimed
    blocks = a.view(8, SHARDS, n // SHARDS)

    def in_turn():
        return sn.natural_order(torch.stack(
            [sn.rank_step(plan, blocks, r) for r in range(SHARDS)]))

    turn_path = f"sharded_ntt_{SHARDS}_in_turn_2^20"
    paths, captured, ms = {}, {}, {}
    for path, fn in ((turn_path, in_turn), ("sharded_ntt_world1_2^20",
                      lambda: sn.sharded_ntt_t(bls.Fr, a, device=dev))):
        (got_c, seen), launches = drive(
            counted, lambda: capture_launches(counted, fn))
        got, ms[path] = timed_call(fn)
        if not (torch.equal(got_c, want) and torch.equal(got, want)):
            raise AssertionError(f"sharded NTT disagrees with the "
                                 f"single-device NTT on {path}")
        require(f"sharded NTT, {path}", launches, ("mont_mul",))
        paths[path] = (launches, [])
        captured[path] = seen
    phase("sharded_ntt", n=n, ranks_in_turn=SHARDS, plan_s=plan_s,
          single_ms=single_ms, in_turn_ms=ms[turn_path],
          world1_ms=ms["sharded_ntt_world1_2^20"],
          mont_mul_launches=[v[0]["mont_mul"] for v in paths.values()],
          equals_single_device=True, correct=True)
    return paths, captured


DKLS_PRODUCTS = 256                 # DKLS19 products between two parties
TWBB = (3, 5, (1, 2, 5))            # threshold weak-BB: 3 of 5, signers
#                                     1, 2, 5 (tests/test_threshold_bbs.py)
TACC = (2, 3)                       # threshold accumulator managers


def threshold_ot_phase(acc_keep) -> None:
    """The OT stack and its two threshold consumers, host work on the
    card's machine: one base-OT phase of 128 OTs between two parties
    (every chosen key its pair's), KOS and DKLS19 batch multiplication of
    256 products over it (the shares sum to the products); threshold
    weak-BB at 3 of 5 (signers 1, 2, 5): A equal to g1 / (e + x) from
    the dealt key, the signature verified by the host pairing; 2-of-3
    threshold managers on the accumulator phase's 2^14-element
    accumulator: a membership witness and a removal, each equal to V /
    (y + alpha) from the full key.  Each step timed."""
    from crypto_tpu_torch.accumulator import threshold as thr
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.hashing import group_elem_from_try_and_incr
    from crypto_tpu_torch.ot import dkls
    from crypto_tpu_torch.ot.ot_extension import setup_ote_pair
    from crypto_tpu_torch.secret_sharing.schemes import shamir_deal_secret
    from crypto_tpu_torch.short_group_sig import threshold_weak_bb as twbb
    from crypto_tpu_torch.short_group_sig.weak_bb import (WeakBBPublicKeyG2,
                                                          WeakBBSecretKey)
    F = bls.Fr
    rng = random.Random(SEED + 300)
    secs = {}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        secs[key] = time.perf_counter() - t
        return out

    sender, receiver = timed("base_ot_128_s", lambda: setup_ote_pair(
        rng, bls.G1.generator()))
    if [p[s] for p, s in zip(receiver.seed_pairs, sender.s_bits)] \
            != sender.seeds:
        raise AssertionError("base OT: a chosen key is not its pair's")
    params = dkls.MultiplicationOTEParams(kappa=256, ssp=80)
    gadget = dkls.GadgetVector.new(params, b"chip-smoke dkls19")
    alpha = F.rand(rng)
    betas = [F.rand(rng) for _ in range(DKLS_PRODUCTS)]
    state, U, kos_rlc = timed("dkls19_party2_round1_s",
                              lambda: dkls.batch_mul_party2_round1(
                                  rng, betas, receiver, gadget, params))
    shares1, tau, rlc = timed("dkls19_party1_s", lambda: dkls.batch_mul_party1(
        rng, alpha, DKLS_PRODUCTS, U, kos_rlc, sender, gadget, params))
    shares2 = timed("dkls19_party2_round2_s",
                    lambda: dkls.batch_mul_party2_round2(state, tau, rlc,
                                                         gadget, params))
    if any(s1 + s2 != alpha * b for s1, s2, b in zip(shares1, shares2,
                                                      betas)):
        raise AssertionError("DKLS19: shares do not sum to the products")

    t, total, ids = TWBB
    g1 = group_elem_from_try_and_incr(bls.G1, b"chip-smoke twbb g1") \
        .normalize()
    g2 = group_elem_from_try_and_incr(bls.G2, b"chip-smoke twbb g2") \
        .normalize()
    sk = WeakBBSecretKey.generate(rng)
    pk = WeakBBPublicKeyG2.generate(sk, g2)
    shares, _ = shamir_deal_secret(rng, sk.x, t, total)
    e = F.rand(rng)
    signers = {s.id: twbb.ThresholdWeakBBSigner.init(rng, s.id, s.share,
                                                     list(ids))
               for s in shares.shares if s.id in ids}
    sig = timed("threshold_weak_bb_3_of_5_s",
                lambda: twbb.run_threshold_weak_bb(rng, signers, e, g1))
    if sig.A != g1 * int((e + sk.x).inverse()):
        raise AssertionError("threshold weak-BB: A is not g1 / (e + x)")
    if not timed("weak_bb_verify_s", lambda: sig.verify(e, pk, g1, g2)):
        raise AssertionError("threshold weak-BB: the signature fails")

    t, total = TACC
    V, kp, elems = acc_keep["value"], acc_keep["kp"], acc_keep["elements"]
    a_sk = kp.secret_key.alpha
    shares, _ = shamir_deal_secret(rng, a_sk, t, total)
    sub = {s.id: s.share for s in shares.shares[:t]}
    managers = thr.make_threshold_managers(rng, sub)
    wit = timed("accumulator_witness_2_of_3_s",
                lambda: thr.threshold_membership_witness(rng, managers,
                                                         elems[1], V))
    managers = thr.make_threshold_managers(rng, sub)
    V_new = timed("accumulator_remove_2_of_3_s",
                  lambda: thr.threshold_remove(rng, managers, elems[2], V))
    for got, y in ((wit.C, elems[1]), (V_new, elems[2])):
        if got != V * int((y + a_sk).inverse()):
            raise AssertionError("threshold accumulator: not V / (y + alpha)")
    phase("threshold_ot", base_ots=128, dkls19_products=DKLS_PRODUCTS,
          weak_bb=f"{TWBB[0]}-of-{TWBB[1]} signers {list(TWBB[2])}",
          accumulator=f"{TACC[0]}-of-{TACC[1]} on {len(elems)} elements",
          **secs, seconds=sum(secs.values()), correct=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from crypto_tpu_torch.bench_points import make_bench_points, \
        make_bench_scalars
    from crypto_tpu_torch.curves import bls12_381 as bls
    from crypto_tpu_torch.curves import bn254 as bn
    from crypto_tpu_torch.curves.tcurve import TPoints, tcurve_for
    from crypto_tpu_torch.fields.tfield import tfield_for
    from crypto_tpu_torch.ops import msm_v2
    from crypto_tpu_torch.ops.kernels import build
    from crypto_tpu_torch.ops.kernels import curve_kernels as ck
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    from crypto_tpu_torch.ops.kernels import point_kernels as pk

    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    phase("card", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.time()
    build.load_library()
    phase("build", seconds=round(time.time() - t0, 3),
          nvcc_seconds=round(build.build_info["seconds"], 3),
          lib=build.build_info["path"])
    res = build.kernel_resources(
        Path(build.build_info["path"]).with_suffix(".log").read_text())
    sass = build.sass_counts(build.build_info["path"])
    phase("kernel_resources", registers_spill_stores_spill_loads_sass=json.dumps(
        {k: [v.get("registers"), v.get("spill_stores"), v.get("spill_loads"),
             sass.get(k)] for k, v in res.items()}))
    spills = sorted(k for k, v in res.items()
                    if v.get("spill_stores") or v.get("spill_loads"))
    unreported = sorted(set(KERNEL_ENTRY) - {k.split("<")[0] for k in res})
    if spills or unreported:
        raise AssertionError(f"ptxas: spills in {spills}, no report for "
                             f"{unreported}")

    counted = (fk.mont_mul, fk.mont_pow, ck.affine_level,
               ck.chunked_level_prefix, ck.chunked_level_down,
               ck.affine_level_fast,
               ck.chunked_level_prefix_fast, ck.chunked_level_down_fast,
               pk.jacobian_add, pk.jacobian_add_mixed, pk.jacobian_double,
               pk.jacobian_normalize, fk.fq2_mul, fk.fq2_sqr,
               ck.affine_level_pre_fq2, ck.affine_level_post_fq2,
               fk.gather_rows_t, fk.slot_tables)
    thr = msm_v2.CHUNK_MIN_PAIRS
    paths = {}            # path -> (launches, level widths)

    # ---- bench points: 2^20 distinct points, full add + normalize ------
    n = 1 << N_LOG
    tc = tcurve_for(bls.G1, dev)
    F = tc.F
    G = bls.G1.generator()
    t0 = time.time()
    (points, dlog), bp_launches = drive(counted,
                                        lambda: make_bench_points(tc, n))
    torch.cuda.synchronize()
    t_points = time.time() - t0
    require("bench points", bp_launches, ("jacobian_add",
                                          "jacobian_normalize"))
    if (bp_launches["jacobian_add"], bp_launches["jacobian_normalize"]) \
            != (2, 1):
        raise AssertionError(f"bench points: expected 2 full adds and 1 "
                             f"normalize, got {bp_launches}")
    logs = [dlog(i) for i in range(n)]
    sample = list(range(0, n, n // 64))
    got = tc.unpack(TPoints(*(t[:, sample] for t in points)))
    if any(g != G.mul_raw(logs[i]) for g, i in zip(got, sample)):
        raise AssertionError("bench points disagree with their discrete "
                             "logs")
    paths["bench_points_2^20"] = (bp_launches, [])
    phase("bench_points", n=n, seconds=round(t_points, 3),
          full_add_launches=bp_launches["jacobian_add"],
          normalize_launches=bp_launches["jacobian_normalize"],
          sample_checked=len(sample), correct=True)

    # ---- the main path: 2^20 points, c = 16, fast levels ----------------
    _, warm_sb = make_bench_scalars(bls.R, n, SEED)
    msm_v2.msm_device_scheduled(bls.G1, points, warm_sb, c=16)

    secs, main_runs = [], []
    for run in range(MSM_RUNS):
        sc, sb = make_bench_scalars(bls.R, n, SEED + 1 + run)
        timings = {}
        torch.cuda.synchronize()

        def timed():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bls.G1, points, sb, c=16,
                                              timings=timings)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed)
        expect = G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % bls.R)
        if result != expect:
            raise AssertionError("2^20 MSM disagrees with the known-dlog "
                                 "result")
        if timings["rerun_windows"] or any(launches[k] for k in
                                           SAFE_KERNELS + FQ2_KERNELS):
            raise AssertionError(
                f"2^20 MSM on distinct bases reran windows "
                f"{timings['rerun_windows']} or launched a total-formula "
                f"or an Fq2 kernel: {launches}")
        widths = timings["level_pairs"]
        require("2^20 MSM", launches, level_kernels(widths, [], thr))
        secs.append(dt)
        main_runs.append((launches, widths))
        phase("msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(timings), rerun_windows=[],
              gather_launches=launches["gather_rows_t"],
              mont_mul_launches=launches["mont_mul"],
              mont_pow_launches=launches["mont_pow"], correct=True)
    main_launches, main_widths = main_runs[0]
    paths["msm_2^20"] = main_runs[0]
    main_scalars = (sc, sb, result)         # the last timed run's
    med = statistics.median(secs)
    phase("msm", n=n, c=16, runs=MSM_RUNS, seconds=secs, median_s=med,
          spread=max(secs) / min(secs), points_per_s=n / med,
          level_pairs=main_widths, slots=timings["slots"],
          chunk_min_pairs=thr,
          bench_points_seconds=round(t_points, 3), card=repr(card),
          correct=True)

    # ---- safe=True once on fresh scalars: the total-formula levels
    sc, sb = make_bench_scalars(bls.R, n, SEED + 40)
    t_s = {}
    t0 = time.perf_counter()
    res, safe_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bls.G1, points, sb, c=16, safe=True, timings=t_s))
    dt_s = time.perf_counter() - t0
    if res != G.mul_raw(sum(s * d for s, d in zip(sc, logs)) % bls.R) \
            or t_s["rerun_windows"]:
        raise AssertionError("2^20 MSM with safe=True disagrees with the "
                             "known-dlog result or reran")
    require("safe 2^20 MSM", safe_launches,
            level_kernels([], t_s["level_pairs"], thr))
    paths["msm_safe_2^20"] = (safe_launches, t_s["level_pairs"])
    phase("msm_safe", n=n, seconds=dt_s, phases=floats(t_s), correct=True)

    # ---- the rerun path: a duplicated base collides in one window -------
    sc, sb = make_bench_scalars(bls.R, n, SEED + 50)
    digits = msm_v2.device_digits(sb, 16, bls.Fr.bits)
    dh = digits.cpu().numpy()
    W, B, w0 = dh.shape[0], 1 << 15, 5
    i_b = next(k for k in range(11, n) if dh[w0, k] != 0)
    j_b = next(k for k in range(n // 2, n)
               if all(dh[w, k] != dh[w, i_b] for w in range(W) if w != w0))
    v0 = int(dh[w0, i_b])
    # window w0's bucket |v0| - 1 keeps only bases i_b and j_b: the others
    # move to the buckets after it, one each
    lane = np.arange(n)
    moved = np.nonzero((np.abs(dh[w0]) == abs(v0)) & (lane != i_b)
                       & (lane != j_b))[0]
    new = np.sign(dh[w0, moved]) * ((abs(v0) + np.arange(moved.size)) % B
                                    + 1)
    logs_r = list(logs)
    logs_r[j_b] = logs[i_b]
    shift = 1 << (16 * w0)
    expect_s = sum(s * d for s, d in zip(sc, logs_r))
    expect_s += (v0 - int(dh[w0, j_b])) * shift * logs_r[j_b]
    expect_s += sum((int(a) - int(b)) * shift * logs_r[k]
                    for k, a, b in zip(moved, new, dh[w0, moved]))
    dh[w0, moved] = new
    dh[w0, j_b] = v0
    pts_r = TPoints(*(t.clone() for t in points))
    for t in pts_r:
        t[:, j_b] = t[:, i_b]
    t_rr = {}
    t0 = time.perf_counter()
    res_r, rr_launches = drive(counted, lambda: msm_v2.msm_device_scheduled(
        bls.G1, pts_r, torch.from_numpy(dh).to(dev), c=16, timings=t_rr))
    dt_r = time.perf_counter() - t0
    if res_r != G.mul_raw(expect_s % bls.R):
        raise AssertionError("2^20 rerun MSM disagrees with the known-dlog "
                             "result")
    spoiled = spoiled_windows(t_rr)
    if w0 not in spoiled or t_rr["rerun_windows"] != spoiled:
        raise AssertionError(f"rerun path: collision in window {w0}, "
                             f"spoiled windows {spoiled}, rerun "
                             f"{t_rr['rerun_windows']}")
    rr_widths = rerun_widths(t_rr)
    require("2^20 rerun", rr_launches,
            level_kernels(t_rr["level_pairs"], rr_widths, thr))
    paths["rerun_2^20"] = (rr_launches, rr_widths)
    phase("rerun_msm", n=n, collision_window=w0, bases=[i_b, j_b],
          moved_from_bucket=int(moved.size), rerun_windows=spoiled,
          level_pairs=t_rr["level_pairs"], rerun_level_pairs=rr_widths,
          seconds=dt_r, phases=floats(t_rr), correct=True)

    # ---- edge MSMs on the card: the small-MSM path --------------------
    p0 = G.mul_raw(random.Random(SEED).randrange(1, bls.R))
    m_eq = 300
    sub = TPoints(*(t[:, :m_eq].contiguous() for t in points))
    s_eq = 0x1234567890ABCDEF
    t_dup, t_eq = {}, {}

    def edges():
        return (msm_v2.msm_device_scheduled(bls.G1, [p0] * 8, [7] * 8,
                                            timings=t_dup),
                msm_v2.msm_device_scheduled(bls.G1, sub, [s_eq] * m_eq,
                                            timings=t_eq))

    (dup, eq_res), edge_launches = drive(counted, edges)
    if dup != p0.mul_raw(56):
        raise AssertionError("duplicate-base MSM disagrees with the host")
    if eq_res != G.mul_raw(s_eq * sum(logs[:m_eq]) % bls.R):
        raise AssertionError("all-equal-scalar MSM disagrees with the host")
    if 0 not in t_dup["rerun_windows"] \
            or t_dup["rerun_windows"] != spoiled_windows(t_dup) \
            or t_eq["rerun_windows"]:
        raise AssertionError(f"edge MSMs: rerun {t_dup['rerun_windows']} "
                             f"and {t_eq['rerun_windows']}")
    edge_widths = t_dup["level_pairs"] + t_eq["level_pairs"]
    edge_safe = rerun_widths(t_dup)
    require("edge MSM", edge_launches,
            level_kernels(edge_widths, edge_safe, thr)
            | set(LEVEL_KERNELS[("narrow", True)]))
    paths["edge_msm"] = (edge_launches, edge_widths)
    phase("edge_msm", duplicate_bases=True, all_equal_scalars_n=m_eq,
          level_pairs=edge_widths, rerun_windows=t_dup["rerun_windows"],
          rerun_level_pairs=edge_safe, correct=True)

    # ---- the point kernels of make_add_fns at 2^20 rows -----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pts = points.X.shape[1]

    def level_inputs(M: int, pts=points, Fx=F):
        """M pairs of real points of `pts` (over the field `Fx`): generic
        pairs, doublings, P + (-P) and infinite operands on either or both
        sides."""
        i1 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        i2 = torch.randint(0, n_pts, (M,), generator=gen, device=dev)
        lane = torch.arange(M, device=dev)
        i2 = torch.where(lane % 7 < 2, i1, i2)             # same x
        x1, y1 = pts.X[:, i1], pts.Y[:, i1]
        x2, y2 = pts.X[:, i2], pts.Y[:, i2]
        y2 = torch.where((lane % 7 == 1)[None], Fx.neg(y2), y2)  # P + (-P)
        m1 = ((lane % 11 == 3) | (lane % 13 == 5)).to(torch.int32)
        m2 = ((lane % 17 == 4) | (lane % 13 == 5)).to(torch.int32)
        return x1, y1, m1, x2, y2, m2

    def point_inputs(M: int):
        """`jacobian_inputs` over level_inputs' pairs, Z an x of the
        bench points."""
        pairs = level_inputs(M)
        return jacobian_inputs(F, pairs, points.X[:, torch.randint(
            0, n_pts, (M,), generator=gen, device=dev)])

    pt_in = point_inputs(n)
    add_fn, affine_add_fn, double_fn = pk.make_add_fns(tc)
    J, Q, aff = pt_in
    (s_add, s_mix, s_dbl), af_launches = drive(counted, lambda: (
        add_fn(TPoints(*J), TPoints(*Q)),
        affine_add_fn(TPoints(aff[0], aff[1], J[2]),
                      TPoints(aff[2], aff[3], J[2])),
        double_fn(TPoints(*J))))
    require("add_fns", af_launches, ("jacobian_add", "jacobian_add_mixed",
                                     "jacobian_double"))
    if not (int(s_add[1]) and int(s_mix[1])):
        raise AssertionError("make_add_fns: P + P did not raise the flag")
    paths["add_fns_2^20"] = (af_launches, [])
    phase("add_fns", rows=n, full_add_flag=int(s_add[1]),
          mixed_add_flag=int(s_mix[1]), launches={
              k: af_launches[k] for k in ("jacobian_add",
                                          "jacobian_add_mixed",
                                          "jacobian_double")})

    # ---- G2 bench points: 2^20 points over Fq2 -------------------------
    tc2 = tcurve_for(bls.G2, dev)
    F2 = tc2.F
    G2 = bls.G2.generator()
    not_g2 = G1_LEVEL_KERNELS + ("jacobian_add", "jacobian_add_mixed",
                                 "jacobian_double", "jacobian_normalize")
    t0 = time.time()
    (points2, dlog2), bp2_launches = drive(
        counted, lambda: make_bench_points(tc2, n))
    torch.cuda.synchronize()
    t_points2 = time.time() - t0
    require("G2 bench points", bp2_launches, ("fq2_mul", "fq2_sqr",
                                              "mont_mul", "mont_pow"))
    if any(bp2_launches[k] for k in not_g2):
        raise AssertionError(f"G2 bench points launched a G1 kernel: "
                             f"{bp2_launches}")
    logs2 = [dlog2(i) for i in range(n)]
    sample2 = list(range(0, n, n // 16))
    got2 = tc2.unpack(TPoints(*(t[:, sample2] for t in points2)))
    t0 = time.perf_counter()
    want2 = [G2.mul_raw(logs2[i]) for i in sample2]
    t_mul2 = (time.perf_counter() - t0) / len(sample2)  # one host G2 mul
    if got2 != want2:
        raise AssertionError("G2 bench points disagree with their discrete "
                             "logs")
    paths["g2_bench_points_2^20"] = (bp2_launches, [])
    phase("g2_bench_points", n=n, seconds=round(t_points2, 3),
          fq2_mul_launches=bp2_launches["fq2_mul"],
          fq2_sqr_launches=bp2_launches["fq2_sqr"],
          mont_mul_launches=bp2_launches["mont_mul"],
          mont_pow_launches=bp2_launches["mont_pow"],
          host_g2_mul_raw_s=t_mul2, sample_checked=len(sample2),
          correct=True)

    # ---- the G2 MSM: 2^20 points, c = 16, the reference's Fq2 levels ----
    def g2_msm_checks(where: str, launches: dict, timings: dict) -> None:
        """A G2 MSM runs the Fq2 kernels, the gather, mont_mul and
        mont_pow, no G1 level or point kernel, and no flag or rerun."""
        require(where, launches, G2_KERNELS)
        if any(launches[k] for k in not_g2) or timings["rerun_windows"] \
                or "zero_chunks" in timings:
            raise AssertionError(f"{where}: a G1 kernel, a flag or a rerun: "
                                 f"{launches}, rerun "
                                 f"{timings['rerun_windows']}")

    _, warm2 = make_bench_scalars(bls.R, n, SEED + 60)
    msm_v2.msm_device_scheduled(bls.G2, points2, warm2, c=16)
    secs2, g2_runs = [], []
    for run in range(G2_MSM_RUNS):
        sc2, sb2 = make_bench_scalars(bls.R, n, SEED + 61 + run)
        t2 = {}
        torch.cuda.synchronize()

        def timed2():
            t = time.perf_counter()
            res = msm_v2.msm_device_scheduled(bls.G2, points2, sb2, c=16,
                                              timings=t2)
            return res, time.perf_counter() - t

        (result, dt), launches = drive(counted, timed2)
        expect = G2.mul_raw(sum(s * d for s, d in zip(sc2, logs2)) % bls.R)
        if result != expect:
            raise AssertionError("2^20 G2 MSM disagrees with the known-dlog "
                                 "result")
        g2_msm_checks("2^20 G2 MSM", launches, t2)
        secs2.append(dt)
        g2_runs.append((launches, t2))
        phase("g2_msm_run", run=run, seconds=dt, points_per_s=n / dt,
              phases=floats(t2), rerun_windows=[], correct=True)
    g2_launches, t2 = g2_runs[0]
    g2_widths = t2["level_pairs"]
    paths["g2_msm_2^20"] = (g2_launches, g2_widths)
    med2 = statistics.median(secs2)
    phase("g2_msm", n=n, c=16, runs=G2_MSM_RUNS, seconds=secs2,
          median_s=med2, spread=max(secs2) / min(secs2),
          points_per_s=n / med2, g1_points_per_s=n / med,
          g2_over_g1_time=med2 / med, level_pairs=g2_widths,
          slots=t2["slots"], launches={k: g2_launches[k] for k in G2_KERNELS},
          card=repr(card), correct=True)

    # ---- G2 edge MSMs: duplicates, P and -P, infinity, zero scalars, and
    # all-equal scalars (the grid path); the total formula, no rerun
    hr = random.Random(SEED + 70)
    q0, q1, *qs = (G2.mul_raw(hr.randrange(1, bls.R)) for _ in range(8))
    e_pts = [q0] * 6 + [q1, -q1, bls.G2.infinity(), q0.double()] + qs
    e_sc = [7] * 6 + [9, 9, 5, 0, 0, 3, 7, 11, 2, 13]
    e_expect = bls.G2.infinity()
    for p, s in zip(e_pts, e_sc):
        e_expect = e_expect + p.mul_raw(s)
    sub2 = TPoints(*(t[:, :m_eq].contiguous() for t in points2))
    t_e1, t_e2 = {}, {}
    (e_res, eq2_res), edge2_launches = drive(counted, lambda: (
        msm_v2.msm_device_scheduled(bls.G2, e_pts, e_sc, timings=t_e1),
        msm_v2.msm_device_scheduled(bls.G2, sub2, [s_eq] * m_eq,
                                    timings=t_e2)))
    if e_res != e_expect:
        raise AssertionError("G2 edge MSM disagrees with the host sum")
    if eq2_res != G2.mul_raw(s_eq * sum(logs2[:m_eq]) % bls.R):
        raise AssertionError("G2 all-equal-scalar MSM disagrees with the "
                             "host")
    for tt in (t_e1, t_e2):
        g2_msm_checks("G2 edge MSM", edge2_launches, tt)
    g2_edge_widths = t_e1["level_pairs"] + t_e2["level_pairs"]
    paths["g2_edge_msm"] = (edge2_launches, g2_edge_widths)
    phase("g2_edge_msm", points=len(e_pts), all_equal_scalars_n=m_eq,
          level_pairs=g2_edge_widths, rerun_windows=[], correct=True)

    # ---- the QAP witness map at 2^20, and the LegoGroth16 setup and
    # proves at 2^16 constraints
    paths["qap_h_2^20"] = (qap_h_phase(counted, dev), [])

    # ---- BASELINE config 5's sharded MSM and NTT, in a world of one on
    # NCCL (a HashStore: no address, no network) and as shards in turn
    import torch.distributed as dist
    t0 = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dist.all_reduce(torch.zeros(1, device=dev))   # NCCL's communicator
        torch.cuda.synchronize()
        phase("nccl_world1", seconds=round(time.time() - t0, 3))
        sh_paths, sh_captured = sharded_msm_phase(counted, dev, points, logs,
                                                  *main_scalars)
        ntt_paths, ntt_captured = sharded_ntt_phase(counted, dev)
    finally:
        dist.destroy_process_group()
    paths.update(sh_paths)
    paths.update(ntt_paths)
    sharded_captured = {**sh_captured, **ntt_captured}
    phase("sharded_phases", seconds=round(time.time() - t0, 3))
    lego_keep = {}
    lego, _ = legogroth16_phases(counted, dev, keep=lego_keep)
    paths.update((k, (v, [])) for k, v in lego.items())
    pair_paths, bbs_widths = pairing_phases(counted, dev)
    paths.update((k, (v, bbs_widths if k.startswith("bbs") else []))
                 for k, v in pair_paths.items())
    t0 = time.time()
    pok_paths, pok_widths, pok_lanes = bbs_pok_phases(counted, dev)
    paths.update((k, (v, pok_widths if k.startswith("bbs_pok_batch") else []))
                 for k, v in pok_paths.items())
    phase("bbs_pok_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    saver_paths, captured, saver_keep = saver_aggregate_phases(counted,
                                                                   dev)
    paths.update((k, (v, [])) for k, v in saver_paths.items())
    captured.update(sharded_captured)
    phase("saver_aggregate_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    acc_paths, acc_keep = accumulator_phases(counted, dev)
    paths.update((k, (v, [])) for k, v in acc_paths.items())
    phase("accumulator_phases", seconds=round(time.time() - t0, 3))
    threshold_ot_phase(acc_keep)
    t0 = time.time()
    ps_paths, ps_captured = proof_system_phase(counted, dev, saver_keep,
                                             acc_keep)
    paths.update((k, (v, [])) for k, v in ps_paths.items())
    captured.update(ps_captured)
    phase("proof_system_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    pr_paths, pr_captured = proof_system_ranges_phase(counted, dev,
                                                      lego_keep["pk"])
    paths.update((k, (v, [])) for k, v in pr_paths.items())
    captured.update(pr_captured)
    phase("proof_system_ranges_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    kb_paths, kb_captured, kb_keep = accumulator_kb_universal_phase(
        counted, dev, acc_keep)
    paths.update((k, (v, [])) for k, v in kb_paths.items())
    captured.update(kb_captured)
    phase("accumulator_kb_universal_phases",
          seconds=round(time.time() - t0, 3))
    t0 = time.time()
    pm_paths, pm_captured = proof_system_more_phase(counted, dev, kb_keep)
    paths.update((k, (v, [])) for k, v in pm_paths.items())
    captured.update(pm_captured)
    phase("proof_system_more_phases", seconds=round(time.time() - t0, 3))
    t0 = time.time()
    split_paths, split_captured = proof_system_split_phase(counted, dev,
                                                           acc_keep, kb_keep)
    paths.update((k, (v, [])) for k, v in split_paths.items())
    captured.update(split_captured)
    phase("proof_system_split_phases", seconds=round(time.time() - t0, 3))

    # ---- BN254: the 2^20 G1 MSMs and the edge MSMs, the LegoGroth16
    # setup, proves and verifier at 2^16 constraints, the 64-pair pairing
    t0 = time.time()
    bn_paths, bn_data = bn254_msm_phases(counted, dev)
    paths.update(bn_paths)
    bn_lego, bn_data["prove_g2_msm"] = legogroth16_phases(
        counted, dev, bn, "bn254_", BN254_LEGO_LOG)
    paths.update((k, (v, [])) for k, v in bn_lego.items())
    bn_pairing, _ = bn254_pairing_phase(counted, dev)
    paths["bn254_pairing_64"] = (bn_pairing, [])
    bn_union = {f.__name__: sum(v[0][f.__name__] for k, v in paths.items()
                                if k.startswith("bn254_")) for f in counted}
    require("BN254", bn_union, BN254_KERNELS)
    if any(v[0][k] for p, v in paths.items() for k in POINT_KERNELS
           if p.startswith("bn254_") and p != "bn254_bench_points_2^20"):
        raise AssertionError(f"a BN254 path other than the bench points "
                             f"launched a point kernel: {bn_union}")
    phase("bn254_phases", seconds=round(time.time() - t0, 3),
          launches={k: v for k, v in bn_union.items() if v})
    phase("launches", **{k: v[0] for k, v in paths.items()})
    never = [f.__name__ for f in counted
             if not any(v[0][f.__name__] for v in paths.values())]
    if never:
        raise AssertionError(f"kernels launched on no path: {never}")

    # ---- kernels vs plain, at the shapes a path gave them -------------
    def row(name, src, rep, path, err, ms, plain_ms, args, shape,
            library_ms=None):
        """The kernels-line entry of `name`, its bound from `work` on the
        wrapper arguments `args` it was timed on."""
        bound = bound_ms(*work(name, args))
        return dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=paths[path][0][name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                    library_ms=library_ms, path=path, shape=shape)

    rows = []
    csrc = "crypto_tpu_torch/csrc/"
    ref = "crypto_tpu/ops/pallas/curve_kernels.py:"

    def agree(name, kernel_out, plain_out, where):
        err = max_err(kernel_out, plain_out)
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"{where}")
        return err

    # mont_mul at the tail's width (16 windows x 2^15 buckets), Fq and Fr,
    # at the 2^20 NTT's Fr shapes: a stage's (8, 2^19) odd halves by
    # their twiddles, the (8, 2^20) pointwise and coset products; and at
    # the witness update's: the scans' (8, 8192), the double-and-add's
    # (12, 16384) over [C_i | V], and a ragged width
    for fld, M, path in ((bls.Fq, 16 << 15, "msm_2^20"),
                         (bls.Fr, 1 << 16, None),
                         (bls.Fr, 1 << (QAP_LOG - 1), "qap_h_2^20"),
                         (bls.Fr, 1 << QAP_LOG, "qap_h_2^20"),
                         (bls.Fr, NMEMBERS, "accumulator_update"),
                         (bls.Fq, 2 * NMEMBERS, "accumulator_update"),
                         (bls.Fq, 2 * NMEMBERS - 3, None)):
        Fx = tfield_for(fld, dev)
        L = Fx.L
        # random field elements, then the edges 0, 1, p-1 and all-ones limbs
        hr = random.Random(SEED)
        ra = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        rb = Fx.pack([hr.randrange(fld.p) for _ in range(M)])
        edges_ = Fx.pack([0, 1, fld.p - 1, fld.p - 1], mont=False)
        ra[:, :4] = edges_
        rb[:, :4] = edges_.flip(1)
        ra[:, 4] = -1
        rb[:, 5] = -1
        rb[:, 6] = -1
        ra[:, 6] = -1
        plain, plain_ms = timed_call(lambda: fk.mont_mul_plain(ra, rb,
                                                               Fx.mod))
        err = agree("mont_mul", (fk.mont_mul(ra, rb, Fx.mod),), (plain,),
                    f"on {fld.name}")
        if path is not None:
            rows.append(row(
                "mont_mul", csrc + "mont_mul.cu",
                "crypto_tpu/ops/pallas/field_kernels.py:386", path,
                err, cuda_ms(lambda: fk.mont_mul(ra, rb, Fx.mod)), plain_ms,
                (ra, rb, Fx.mod), [L, M]))
    phase("check_mont_mul", fq_pairs=[16 << 15, 2 * NMEMBERS,
                                      2 * NMEMBERS - 3],
          fr_pairs=[1 << 16, 1 << (QAP_LOG - 1), 1 << QAP_LOG, NMEMBERS],
          bit_exact=True)

    # mont_pow's Fermat root at 1 element (each batch_inv_t root), 16 (the
    # tail's to_affine), 2^16 and, on Fq, the witness update's to_affine
    # (8,192), with zeros (0 -> 0), Fq and Fr, against its plain version
    # on the card.  The plain version goes lane by lane through 608
    # dependent products whatever the width, so it runs once over all the
    # widths' inputs side by side, and again alone at each row's shape
    for fld in (bls.Fq, bls.Fr):
        Fx = tfield_for(fld, dev)
        e = fld.p - 2
        hr = random.Random(SEED + 3)
        update = ((NMEMBERS, False),) if fld is bls.Fq else ()
        xs = []
        for M, zero in ((1, False), (1, True), (16, False),
                        (1 << 16, False)) + update:
            x = Fx.pack([0 if zero else hr.randrange(1, fld.p)
                         for _ in range(M)])
            x[:, 3::5] = 0
            xs.append((M, zero, x))
        whole = fk.mont_pow_plain(torch.cat([x for *_, x in xs], 1), e,
                                  Fx.mod)
        at = 0
        for M, zero, x in xs:
            err = agree("mont_pow", (fk.mont_pow(x, e, Fx.mod),),
                        (whole[:, at:at + M],), f"on {fld.name} at M={M}")
            at += M
            if fld is bls.Fq and (M, zero) in ((1, False),
                                               (NMEMBERS, False)):
                plain, plain_ms = timed_call(
                    lambda: fk.mont_pow_plain(x, e, Fx.mod))
                err = agree("mont_pow", (fk.mont_pow(x, e, Fx.mod),),
                            (plain,), f"on {fld.name} at M={M}")
                if M == 1:
                    root_1 = (x, plain, plain_ms)
                rows.append(row(
                    "mont_pow", csrc + "mont_mul.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:386",
                    "msm_2^20" if M == 1 else "accumulator_update",
                    err, cuda_ms(lambda: fk.mont_pow(x, e, Fx.mod)),
                    plain_ms, (x, e, Fx.mod), [Fx.L, M]))
    phase("check_mont_pow", elements=[1, 16, 1 << 16, NMEMBERS], zeros=True,
          fields=["Fq", "Fr"], bit_exact=True)

    # the one-launch narrow levels: each at the edge MSMs' widest narrow
    # width (its row), at every narrow width of the other G1 paths of its
    # formula and at LEVEL_WIDTHS, then the split level against it
    def narrow(*lists):
        return sorted({w for ws in lists for w in ws if w < thr})

    for fast, edge_w, more in (
            (False, edge_safe, narrow(edge_safe, paths["msm_safe_2^20"][1],
                                      rr_widths)),
            (True, edge_widths, narrow(edge_widths, main_widths))):
        rows.extend(check_narrow_levels(row, agree, F, level_inputs, fast,
                                        "edge_msm", max(narrow(edge_w)),
                                        more))
    level_timings(F, level_inputs)

    def chunked_inputs(M: int):
        pad = (-M) % msm_v2.CHUNK_PAD
        x1, y1, m1, x2, y2, m2 = level_inputs(M)
        x1, y1, x2, y2 = (msm_v2._pad_cols(t, pad, 0)
                          for t in (x1, y1, x2, y2))
        m1, m2 = msm_v2._pad_cols(m1, pad, 1), msm_v2._pad_cols(m2, pad, 1)
        return x1, y1, m1, x2, y2, m2

    def infinite_warps(ins):
        """chunked_inputs with masks by warp: in every strip (pairs t +
        j*T), warps of threads all with P1 infinite, all with P2, all
        with both, and warps that mix the three with finite pairs."""
        Mp = ins[0].shape[1]
        lane = torch.arange(Mp, device=dev)
        warp = lane % (Mp // ck.CHUNK_K) // 32
        m1 = (warp % 4 == 0) | (warp % 4 == 2) \
            | ((warp % 4 == 3) & (lane % 3 == 0))
        m2 = (warp % 4 == 1) | (warp % 4 == 2) \
            | ((warp % 4 == 3) & (lane % 3 == 1))
        return ins[:2] + (m1.to(torch.int32),) + ins[3:5] \
            + (m2.to(torch.int32),)

    def check_chunked(M: int, path: str | None, fast: bool,
                      inf_warps: bool = False):
        ins = chunked_inputs(M)
        if inf_warps:
            ins = infinite_warps(ins)
        Mp = ins[0].shape[1]
        if fast:
            prefix, down = (ck.chunked_level_prefix_fast,
                            ck.chunked_level_down_fast)
            prefix_p = ck.chunked_level_prefix_fast_plain
            down_p = ck.chunked_level_down_fast_plain
        else:
            prefix, down = ck.chunked_level_prefix, ck.chunked_level_down
            prefix_p = ck.chunked_level_prefix_plain
            down_p = ck.chunked_level_down_plain
        kq = prefix(F, *ins)
        pq, prefix_ms = timed_call(lambda: prefix_p(F, *ins))
        e_pre = agree(prefix.__name__, kq, pq, f"at M={M}")
        total = kq[1].clone()
        total[0] |= F.is_zero(total).to(torch.int32)    # as pair_add_t does
        tinv = msm_v2.batch_inv_t(F, total)
        args = ins + (kq[0], tinv) + (() if fast else (kq[2],))
        pdn, down_ms = timed_call(lambda: down_p(F, *args))
        e_down = agree(down.__name__, down(F, *args), pdn, f"at M={M}")
        if path is None:
            return
        lines = ("669", "683") if fast else ("844", "860")
        rows.append(row(prefix.__name__, csrc + "chunked_level.cu",
                        ref + lines[0], path, e_pre,
                        cuda_ms(lambda: prefix(F, *ins)), prefix_ms,
                        (F,) + ins, [12, Mp]))
        rows.append(row(down.__name__, csrc + "chunked_level.cu",
                        ref + lines[1], path, e_down,
                        cuda_ms(lambda: down(F, *args)), down_ms,
                        (F,) + args, [12, Mp]))

    for fast, path, widths in ((False, "rerun_2^20", rr_widths),
                               (True, "msm_2^20", main_widths)):
        w_chunk = min(w for w in widths if w >= thr)
        check_chunked(w_chunk, path, fast)
        check_chunked(w_chunk + 5, None, fast)
        check_chunked(w_chunk, None, fast, inf_warps=True)
        phase("check_chunked_level_fast" if fast else "check_chunked_level",
              pairs=[w_chunk, w_chunk + 5], path=path,
              infinite_operand_in_every_warp=True, bit_exact=True)
    # the PoK batch verify's two 256-point MSMs: every fast level width
    # they ran (chunked from the threshold up, affine below it; the
    # phase found none to rerun), a row at each
    pok_path = "bbs_pok_batch_verify_256"
    for w in sorted(set(pok_widths)):
        if w >= thr:
            check_chunked(w, pok_path, True)
        else:
            rows.extend(check_narrow_level(row, agree, F, level_inputs(w),
                                           True, pok_path))
    phase("check_level_fast", path=pok_path,
          pairs=sorted(set(pok_widths)), bit_exact=True)

    # the fast down pass at each level width of the 2^20 MSM: where its
    # per-MSM time and its gap to the bound live
    per_width = []
    for w in main_widths:
        ins = chunked_inputs(w)
        fq = ck.chunked_level_prefix_fast(F, *ins)
        tot = fq[1].clone()
        tot[0] |= F.is_zero(tot).to(torch.int32)
        args = ins + (fq[0], msm_v2.batch_inv_t(F, tot))
        t_down = cuda_ms(lambda: ck.chunked_level_down_fast(F, *args))
        bound = bound_ms(*work("chunked_level_down_fast", (F,) + args))[0]
        per_width.append([ins[0].shape[1], t_down, bound, t_down / bound])
        del ins, fq, tot, args
    phase("down_fast_widths", pairs_ms_bound_ms_ratio=json.dumps(per_width),
          ms_sum=sum(r[1] for r in per_width),
          bound_sum=sum(r[2] for r in per_width))

    # the safe and the fast chunked level on the same 2^20 level's inputs,
    # timed in turns (safe, fast, fast, safe)
    ins = chunked_inputs(min(main_widths))
    sq = ck.chunked_level_prefix(F, *ins)
    s_args = ins + (sq[0], msm_v2.batch_inv_t(F, sq[1]), sq[2])
    fq = ck.chunked_level_prefix_fast(F, *ins)
    f_tot = fq[1].clone()
    f_tot[0] |= F.is_zero(f_tot).to(torch.int32)
    f_args = ins + (fq[0], msm_v2.batch_inv_t(F, f_tot))
    turns = {"safe": [[], []], "fast": [[], []]}
    for kind in ("safe", "fast", "fast", "safe"):
        pre_fn, down_fn, a = (
            (ck.chunked_level_prefix, ck.chunked_level_down, s_args)
            if kind == "safe" else
            (ck.chunked_level_prefix_fast, ck.chunked_level_down_fast,
             f_args))
        turns[kind][0].append(cuda_ms(lambda: pre_fn(F, *ins)))
        turns[kind][1].append(cuda_ms(lambda: down_fn(F, *a)))
    phase("compare_chunked", pairs=ins[0].shape[1],
          safe_prefix_ms=turns["safe"][0], fast_prefix_ms=turns["fast"][0],
          safe_down_ms=turns["safe"][1], fast_down_ms=turns["fast"][1])

    # the point kernels: full add at the bench points' 2^14 and 2^20 rows,
    # mixed add, double and normalize at 2^20
    for M in (1 << 14, n):
        Jm, Qm, _ = pt_in if M == n else point_inputs(M)
        args = Jm + Qm
        pa, add_ms = timed_call(lambda: pk.jacobian_add_plain(F, *args))
        e_add = agree("jacobian_add", pk.jacobian_add(F, *args), pa,
                      f"at M={M}")
        if int(pa[3].sum()) == 0:
            raise AssertionError("full-add check inputs hold no P + P")
    rows.append(row("jacobian_add", csrc + "jacobian.cu", ref + "334",
                    "bench_points_2^20", e_add,
                    cuda_ms(lambda: pk.jacobian_add(F, *args)), add_ms,
                    (F,) + args, [12, n]))
    # and on warps of one kind each
    add_warps_ms = check_full_add_warps(F, pt_in[0], pt_in[1], agree)
    pm, mix_ms = timed_call(lambda: pk.jacobian_add_mixed_plain(F, *aff))
    e_mix = agree("jacobian_add_mixed", pk.jacobian_add_mixed(F, *aff), pm,
                  f"at M={n}")
    rows.append(row("jacobian_add_mixed", csrc + "jacobian.cu", ref + "347",
                    "add_fns_2^20", e_mix,
                    cuda_ms(lambda: pk.jacobian_add_mixed(F, *aff)), mix_ms,
                    (F,) + aff, [12, n]))
    pdb, dbl_ms = timed_call(lambda: pk.jacobian_double_plain(F, *J))
    e_dbl = agree("jacobian_double", pk.jacobian_double(F, *J), pdb,
                  f"at M={n}")
    rows.append(row("jacobian_double", csrc + "jacobian.cu", ref + "360",
                    "add_fns_2^20", e_dbl,
                    cuda_ms(lambda: pk.jacobian_double(F, *J)), dbl_ms,
                    (F,) + J, [12, n]))
    # and with Y1 = 0 lanes (no point of G1 has one: raw coordinates)
    lane = torch.arange(n, device=dev)
    J_y0 = (J[0], torch.where((lane % 29 == 7)[None], 0, J[1]), J[2])
    agree("jacobian_double", pk.jacobian_double(F, *J_y0),
          pk.jacobian_double_plain(F, *J_y0), "with Y1 = 0 lanes")
    phase("check_jacobian", full_add_rows=[1 << 14, n], mixed_add_rows=n,
          double_rows=n, double_y1_zero_lanes=int((lane % 29 == 7).sum()),
          full_add_warps_of_one_kind=True,
          full_add_warps_ms=add_warps_ms, bit_exact=True)
    pn, norm_ms = timed_call(lambda: pk.jacobian_normalize_plain(F, *J))
    e_norm = agree("jacobian_normalize", pk.jacobian_normalize(F, *J), pn,
                   f"at M={n}")
    rows.append(row("jacobian_normalize", csrc + "normalize.cu",
                    ref + "390", "bench_points_2^20", e_norm,
                    cuda_ms(lambda: pk.jacobian_normalize(F, *J), reps=5),
                    norm_ms, (F,) + J, [12, n]))
    zs = check_normalize_cases(F, J, pn, agree)
    phase("check_normalize", points=n, infinite=int(F.is_zero(J[2]).sum()),
          chunk=pk.NORMALIZE_CHUNK, threads=pk.NORMALIZE_THREADS,
          shape="B (one chain a block)",
          checked=zs, bound_squares_products_per_point=[1, 6],
          bound_chain_squares_products=list(chain_ops(bls.P - 2)),
          bit_exact=True)

    # ---- the Fq2 mul at the first product-tree width of the G2 MSM's
    # narrowest level, and a ragged count; random curve coordinates, the
    # edges 0, 1, u, (p-1)(1 + u) and a square, and the canonical limbs
    # that bound the lazy reduction: a0 + a1 >= p ((p-1)(1 + u) squared),
    # v0 = 0 with v1 = (p-1)^2 ((p-1)u squared), 0, 1 and p - 1 + u
    w_fq2 = min(g2_widths) // 2
    gen2 = torch.Generator(device=dev).manual_seed(SEED + 2)
    P = bls.P
    fq2_edges = F2.pack([bls.Fq2(0, 0), bls.Fq2(1, 0), bls.Fq2(0, 1),
                         bls.Fq2(P - 1, P - 1)])
    fq2_limb_edges = F2.pack([bls.Fq2(P - 1, P - 1), bls.Fq2(0, P - 1),
                              bls.Fq2(0, 0), bls.Fq2(1, 0),
                              bls.Fq2(P - 1, 1)], mont=False)
    for M in (w_fq2, w_fq2 - 3):
        a = points2.X[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        b = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4], b[:, :4] = fq2_edges, fq2_edges.flip(1)
        b[:, 4] = a[:, 4]
        a[:, 5:10], b[:, 5:10] = fq2_limb_edges, fq2_limb_edges
        a[:, 10:15], b[:, 10:15] = fq2_limb_edges, fq2_limb_edges.flip(1)
        pm, fq2_ms = timed_call(lambda: fk.fq2_mul_plain(F2.base, a, b))
        e_fq2 = agree("fq2_mul", (fk.fq2_mul(F2.base, a, b),), (pm,),
                      f"at M={M}")
        if M == w_fq2:
            rows.append(row(
                "fq2_mul", csrc + "fq2_mul.cu", ref + "1066", "g2_msm_2^20",
                e_fq2, cuda_ms(lambda: fk.fq2_mul(F2.base, a, b)), fq2_ms,
                (F2.base, a, b), [24, M]))
    phase("check_fq2_mul", pairs=[w_fq2, w_fq2 - 3], path="g2_msm_2^20",
          limb_edges=True, bit_exact=True)

    # ---- the Fq2 square at the G2 tail's widest (the first reduction of
    # 16 windows x 2^15 buckets: 2^18 sums), and a ragged count, on the
    # same kind of inputs, with a0 = a1, a1 = 0, (p-1) + 0u and 0 + (p-1)u
    # beside the edges and the canonical limbs of the product check
    w_sq = 16 << 14
    sqr_edges = F2.pack([bls.Fq2(P - 1, 0), bls.Fq2(0, P - 1)])
    for M in (w_sq, w_sq - 5):
        a = points2.Y[:, torch.randint(0, n, (M,), generator=gen2,
                                       device=dev)]
        a[:, :4] = fq2_edges
        a[:, 4:6] = sqr_edges
        a[12:, 6] = a[:12, 6]                        # a0 = a1
        a[12:, 7] = 0                                # a1 = 0
        a[:, 8:13] = fq2_limb_edges
        ps, sqr_ms = timed_call(lambda: fk.fq2_sqr_plain(F2.base, a))
        e_sq = agree("fq2_sqr", (fk.fq2_sqr(F2.base, a),), (ps,),
                     f"at M={M}")
        if M == w_sq:
            rows.append(row(
                "fq2_sqr", csrc + "fq2_mul.cu", ref + "908", "g2_msm_2^20",
                e_sq, cuda_ms(lambda: fk.fq2_sqr(F2.base, a)), sqr_ms,
                (F2.base, a), [24, M]))
    phase("check_fq2_sqr", elements=[w_sq, w_sq - 5], path="g2_msm_2^20",
          edges="a0=a1,a1=0,(p-1)+0u,0+(p-1)u", bit_exact=True)

    # ---- the pairing paths' narrow batches at n lanes (65 in the
    # multi-pairing, 2 in the PoK batch verify's 2-pairing, 44 in the PoK
    # checker's Miller product): Fq2 products 15 a lane (the line
    # product, the row), 12 a lane (the Fq12 square) and 18 at one lane
    # (the final exponentiation's Fq12 product); squares 4 a lane (the
    # doubling step, the row), 2 a lane and 9 at one lane (the
    # cyclotomic square); mont_mul 4 base products a lane (the lines'
    # scaling, the row) and 2; mont_pow's Fq inverse at one element.
    # Random elements with the edges 0, 1 and p - 1 first; each path's
    # rows at its widest batch of each kernel.
    hr = random.Random(SEED + 110)
    Fq_ = F2.base

    def fq2_rand(M: int) -> torch.Tensor:
        t = F2.pack([bls.Fq2(hr.randrange(P), hr.randrange(P))
                     for _ in range(M)])
        k = min(M, 4)
        t[:, :k] = fq2_edges[:, :k]
        return t

    def check_pairing_kernels(lanes: int, path: str) -> None:
        for M in (15 * lanes, 12 * lanes, 18):
            a, b = fq2_rand(M), fq2_rand(M).flip(1)
            pm, pm_ms = timed_call(lambda: fk.fq2_mul_plain(Fq_, a, b))
            err = agree("fq2_mul", (fk.fq2_mul(Fq_, a, b),), (pm,),
                        f"on {path} at M={M}")
            if M == 15 * lanes:
                rows.append(row(
                    "fq2_mul", csrc + "fq2_mul.cu", ref + "1066", path, err,
                    cuda_ms(lambda: fk.fq2_mul(Fq_, a, b)), pm_ms,
                    (Fq_, a, b), [24, M]))
        for M in (4 * lanes, 2 * lanes, 9):
            a = fq2_rand(M)
            ps, ps_ms = timed_call(lambda: fk.fq2_sqr_plain(Fq_, a))
            err = agree("fq2_sqr", (fk.fq2_sqr(Fq_, a),), (ps,),
                        f"on {path} at M={M}")
            if M == 4 * lanes:
                rows.append(row(
                    "fq2_sqr", csrc + "fq2_mul.cu", ref + "908", path, err,
                    cuda_ms(lambda: fk.fq2_sqr(Fq_, a)), ps_ms, (Fq_, a),
                    [24, M]))
        for M in (4 * lanes, 2):
            a, b = fq2_rand(M)[:FQ_LIMBS], fq2_rand(M)[FQ_LIMBS:]
            pm, pm_ms = timed_call(lambda: fk.mont_mul_plain(a, b, Fq_.mod))
            err = agree("mont_mul", (fk.mont_mul(a, b, Fq_.mod),), (pm,),
                        f"on {path} at M={M}")
            if M == 4 * lanes:
                rows.append(row(
                    "mont_mul", csrc + "mont_mul.cu",
                    "crypto_tpu/ops/pallas/field_kernels.py:386", path, err,
                    cuda_ms(lambda: fk.mont_mul(a, b, Fq_.mod)), pm_ms,
                    (a, b, Fq_.mod), [FQ_LIMBS, M]))
        phase("check_pairing_kernels", path=path, lanes=lanes,
              fq2_mul=[15 * lanes, 12 * lanes, 18],
              fq2_sqr=[4 * lanes, 2 * lanes, 9], mont_mul=[4 * lanes, 2],
              bit_exact=True)

    check_pairing_kernels(PAIRS + 1, "pairing_64")
    for path, lanes in pok_lanes.items():
        check_pairing_kernels(lanes, path)
    rows.extend(captured_kernel_checks(row, agree, captured))
    # the pairing's Fq inverse: one element, as `check_mont_pow`'s root at
    # M = 1, whose input, plain output and plain time it takes
    a, pw, pw_ms = root_1
    err = agree("mont_pow", (fk.mont_pow(a, P - 2, Fq_.mod),), (pw,),
                "at pairing_64's inverse")
    rows.append(row(
        "mont_pow", csrc + "mont_mul.cu",
        "crypto_tpu/ops/pallas/field_kernels.py:386", "pairing_64", err,
        cuda_ms(lambda: fk.mont_pow(a, P - 2, Fq_.mod)), pw_ms,
        (a, P - 2, Fq_.mod), [FQ_LIMBS, 1]))
    phase("check_pairing_inverse", mont_pow=[1], bit_exact=True)

    # ---- the Fq2 level at the G2 MSM's narrowest level, a ragged count
    # and the G2 edge MSMs' widest level
    def check_fq2_level(M: int, path: str | None):
        ins = level_inputs(M, points2, F2)
        kd = ck.affine_level_pre_fq2(F2, *ins)
        pd, pre_ms = timed_call(lambda: ck.affine_level_pre_plain(F2, *ins))
        e_pre = agree("affine_level_pre_fq2", kd, pd, f"at M={M}")
        x1, y1, m1, x2, y2, m2 = ins
        # every warp mixes doublings, P + (-P) and infinite operands
        warp = [kd[1][:32], kd[2][:32] & (m1[:32] == 0) & (m2[:32] == 0),
                m1[:32], m2[:32]]
        if M > 64 and not all(int(t.sum()) for t in warp):
            raise AssertionError("Fq2 level check inputs: a warp without a "
                                 "doubling, P + (-P) or an infinite operand")
        args = (x1, y1, x2, y2, msm_v2.batch_inv_t(F2, kd[0]), kd[1], m1,
                m2)
        pp, post_ms = timed_call(lambda: ck.affine_level_post_plain(F2,
                                                                    *args))
        e_post = agree("affine_level_post_fq2",
                       ck.affine_level_post_fq2(F2, *args), pp, f"at M={M}")
        if path is None:
            return
        rows.append(row("affine_level_pre_fq2", csrc + "affine_level_fq2.cu",
                        ref + "1014", path, e_pre,
                        cuda_ms(lambda: ck.affine_level_pre_fq2(F2, *ins)),
                        pre_ms, (F2,) + ins, [24, M]))
        rows.append(row("affine_level_post_fq2",
                        csrc + "affine_level_fq2.cu", ref + "1029", path,
                        e_post,
                        cuda_ms(lambda: ck.affine_level_post_fq2(F2, *args)),
                        post_ms, (F2,) + args, [24, M]))

    w_lvl = min(g2_widths)
    check_fq2_level(w_lvl, "g2_msm_2^20")
    check_fq2_level(w_lvl + 5, None)
    check_fq2_level(max(g2_edge_widths), None)
    check_fq2_level(96, None)
    phase("check_affine_level_fq2",
          pairs=[w_lvl, w_lvl + 5, max(g2_edge_widths), 96],
          path="g2_msm_2^20", bit_exact=True)

    # ---- the slot tables of each MSM's 2^20 points, and the gather at
    # each MSM's layout: the curve's point-major x table (2^20 rows of 12
    # or 24 words, as `slot_tables` builds it) into the MSM's largest slot
    # count, each point once a window at random slots, the rest empty
    # (-1); then a ragged count with indices past the table and below -1
    # (a zero column on both sides) and one all-dead tile of 256 slots.
    # The library call is index_select on the clamped index of the
    # point-major table with a zero fill, timed here and used nowhere.
    W2 = (bls.Fr.bits + 16) // 16
    g_line = {}
    for tag, Fx, pts, slots in (("g1", F, points, timings["slots"]),
                                ("g2", F2, points2, t2["slots"])):
        # the tables, with y = 0 at some points, and on G2 y's c1 alone
        # at others (-0 = 0 in each component)
        y = pts.Y.clone()
        y[:, ::4097] = 0
        if Fx.U == 24:
            y[12:, 5::4097] = 0
        pt, tables_ms = timed_call(lambda: fk.slot_tables_plain(Fx, pts.X,
                                                                 y))
        e_t = agree("slot_tables", fk.slot_tables(Fx, pts.X, y), pt,
                    f"on {tag}")
        t_tables = cuda_ms(lambda: fk.slot_tables(Fx, pts.X, y))
        g_line[tag + "_tables_ms"] = t_tables
        if tag == "g2":
            rows.append(row("slot_tables", csrc + "gather.cu",
                            "crypto_tpu/ops/msm_v2.py:719", "g2_msm_2^20",
                            e_t, t_tables, tables_ms, (Fx, pts.X, y),
                            [24, n]))
        tab = pt[0]
        for M in (max(slots), n + 3):
            live = min(M, W2 * n)
            idx = torch.full((M,), -1, dtype=torch.int64, device=dev)
            pos = torch.randperm(M, generator=gen2, device=dev)[:live]
            idx[pos] = torch.cat([torch.randperm(n, generator=gen2,
                                                 device=dev)
                                  for _ in range(W2)])[:live]
            if M == n + 3:
                idx[:3] = torch.tensor([n, n + 9, -5], device=dev)
                idx[256:512] = -1
            pg, gather_ms = timed_call(lambda: fk.gather_rows_t_plain(tab,
                                                                      idx))
            e_g = agree("gather_rows_t", (fk.gather_rows_t(tab, idx),), (pg,),
                        f"on {tag} at M={M}")
            if M == n + 3:  # index_select would fault on the indices >= N
                break

            def library():
                return tab.t().index_select(1, idx.clamp(min=0)) \
                    .masked_fill_(idx < 0, 0)

            agree("index_select", (library(),), (pg,), f"at M={M}")
            t_kernel = cuda_ms(lambda: fk.gather_rows_t(tab, idx))
            t_library = cuda_ms(library)
            g_line[tag] = dict(U=Fx.U, slots=M, live=live, ms=t_kernel,
                               plain_ms=gather_ms, library_ms=t_library,
                               bound_ms=bound_ms(*work("gather_rows_t",
                                                       (tab, idx)))[0])
            if tag == "g2":
                rows.append(row("gather_rows_t", csrc + "gather.cu",
                                "crypto_tpu/ops/pallas/field_kernels.py:356",
                                "g2_msm_2^20", e_g, t_kernel, gather_ms,
                                (tab, idx), [24, M], library_ms=t_library))
    phase("check_gather", ragged_slots=n + 3, dead_tile=[256, 512],
          **g_line, bit_exact=True)

    # ---- every L = 8 instantiation at the BN254 paths' shapes
    rows.extend(bn254_kernel_checks(row, agree, paths, bn_data, dev))

    # ---- device busy share of one more 2^20 G1 MSM, and each kernel's
    # device time and summed bound over one MSM -------------------------
    device, bounds = record_work(counted, lambda: device_profile(
        "profile", lambda: msm_v2.msm_device_scheduled(bls.G1, points, sb,
                                                       c=16)))
    phase("per_msm", launches_device_ms_bound_ms=json.dumps(
        {k: [cnt, round(device.get(k, (0, 0.0))[1], 4), round(b, 4)]
         for k, (cnt, b) in bounds.items() if cnt}))

    phase("total", seconds=round(time.time() - t_start, 3))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
