"""The port's row gather (`gather_rows_t`, its plain version on the CPU)
against the reference's `gather_rows_t_fn` run in Pallas interpret mode
at the sizes of `tests/test_pallas_interpret.py` (N = 300 rows of 26
words, M = 2,048 indices, some negative), and the wrapper's checks.

Both take the same contract: rows of an (N, C) point-major payload into
a transposed (C, M) output, and the same payload here.  A negative index
gives a zero column in both; in the port an index >= N does too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.ops.kernels import field_kernels as fk
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, C = 300, 2048, 26

SCRIPT = r"""
import os, sys
os.environ["CRYPTO_TPU_PALLAS_INTERPRET"] = "1"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from crypto_tpu.ops.pallas.field_kernels import gather_rows_t_fn
payload = np.load(sys.argv[1])
idx = np.load(sys.argv[2])
out = gather_rows_t_fn(payload.shape[1], block_b=1024, nchunk=8)(
    jnp.asarray(payload), jnp.asarray(idx))
np.save(sys.argv[3], np.asarray(out))
"""


def _inputs():
    rng = np.random.default_rng(0)
    payload = rng.integers(-(1 << 31), 1 << 31, size=(N, C), dtype=np.int64)
    idx = rng.integers(0, N, size=M).astype(np.int32)
    idx[rng.random(M) < 0.4] = -1                     # empty slots
    idx[:3] = (-1, 0, N - 1)
    return payload.astype(np.int32), idx


def test_gather_cols_vs_interpret_kernel(tmp_path):
    payload, idx = _inputs()
    files = [tmp_path / f for f in ("payload.npy", "idx.npy", "out.npy")]
    np.save(files[0], payload)
    np.save(files[1], idx)
    out = subprocess.run([sys.executable, "-c", SCRIPT, *map(str, files)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(files[2])
    assert ref.shape == (C, M)
    got = fk.gather_rows_t(torch.from_numpy(payload),
                           torch.from_numpy(idx.astype(np.int64)))
    assert got.dtype == torch.int32 and got.shape == (C, M)
    assert got.is_contiguous()
    assert np.array_equal(got.numpy(), ref)
    assert not got[:, idx < 0].any()
    assert np.array_equal(got[:, idx >= 0].numpy(),
                          payload[idx[idx >= 0]].T)


def test_gather_cols_plain_is_the_wrapper_on_cpu():
    payload, idx = _inputs()
    src = torch.from_numpy(payload)
    ix = torch.from_numpy(idx.astype(np.int64))
    assert torch.equal(fk.gather_rows_t(src, ix),
                       fk.gather_rows_t_plain(src, ix))
    empty = fk.gather_rows_t(src, torch.empty(0, dtype=torch.int64))
    assert empty.shape == (C, 0)
    assert not fk.gather_rows_t(src, torch.full((5,), -1)).any()


def test_gather_cols_checks():
    """The wrapper refuses what the kernel does not take: a payload that
    is not a contiguous int32 (N, C) matrix (a limb-major view of one
    included), an index that is not a contiguous int64 vector, and
    tensors on two devices or on a device with no kernel."""
    src = torch.zeros((N, C), dtype=torch.int32)
    ix = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        fk.gather_rows_t(src, ix.to(torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fk.gather_rows_t(src.to(torch.int64), ix)
    with pytest.raises(ValueError, match="contiguous"):
        fk.gather_rows_t(src.t(), ix)
    with pytest.raises(ValueError, match="contiguous"):
        fk.gather_rows_t(src, torch.zeros(8, dtype=torch.int64)[::2])
    with pytest.raises(ValueError):
        fk.gather_rows_t(src.unsqueeze(0), ix)
    with pytest.raises(ValueError):
        fk.gather_rows_t(src, ix.reshape(2, 2))
    with pytest.raises(ValueError, match="on cpu"):
        fk.gather_rows_t(src, ix.to("meta"))
    with pytest.raises(ValueError, match="device"):
        fk.gather_rows_t(src.to("meta"), ix.to("meta"))


def test_gather_rows_t_kernel_takes_coordinate_rows(monkeypatch):
    """Routed to the card (as a CUDA tensor is), a payload the kernel
    does not take raises before any launch: rows other than 12 or 24
    words (26 here), or a base off a 16-byte boundary."""
    monkeypatch.setattr(fk, "on_card", lambda name, device: True)
    ix = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="12 or 24"):
        fk.gather_rows_t(torch.zeros((N, C), dtype=torch.int32), ix)
    base = torch.zeros(12 * N + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        fk.gather_rows_t(base[1:].view(N, 12), ix)


def test_gather_cols_index_outside_source_gives_zero():
    """An index outside [0, N) gives a zero column, as the kernel gives
    one (it reads nothing outside the payload)."""
    payload, _ = _inputs()
    src = torch.from_numpy(payload)
    ix = torch.tensor([N, -1, 5, N + 7, -3, N - 1])
    got = fk.gather_rows_t(src, ix)
    assert torch.equal(got, fk.gather_rows_t_plain(src, ix))
    assert not got[:, [0, 1, 3, 4]].any()
    assert torch.equal(got[:, [2, 5]], src[[5, N - 1]].t())


@pytest.mark.parametrize("U", [12, 24])
def test_gather_rows_t_ragged_count_and_dead_tile(U):
    """The MSM's row widths (12 words on G1, 24 on G2) at a slot count
    that no tile of 256 slots divides, with one whole tile of empty slots
    and indices past both ends: the plain version equals payload[idx].T
    column by column, and zero on every dead slot."""
    rng = np.random.default_rng(U)
    n, m = 97, 3 * 256 + 45
    payload = rng.integers(-(1 << 31), 1 << 31, size=(n, U),
                           dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, n, size=m)
    idx[256:512] = -1                                 # an all-dead tile
    idx[[3, 600, m - 1]] = (n, -7, n + 100)           # outside [0, n)
    got = fk.gather_rows_t(torch.from_numpy(payload), torch.from_numpy(idx))
    assert got.shape == (U, m) and got.is_contiguous()
    live = (idx >= 0) & (idx < n)
    want = np.zeros((U, m), dtype=np.int32)
    want[:, live] = payload[idx[live]].T
    assert np.array_equal(got.numpy(), want)
    assert not got[:, 256:512].any()


@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_slot_tables_rows_against_host(curve):
    """The MSM's two payloads from its limb-major coordinates: x's rows,
    and y's rows over -y's, each -y the host's p - y in every base-field
    component (0 staying 0), on G1 (12 words a row) and G2 (24)."""
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tcurve import tcurve_for
    F = tcurve_for(getattr(tb, curve), "cpu").F
    rng = np.random.default_rng(7)
    n, P = 37, tb.P

    def vals():
        v = [int.from_bytes(rng.bytes(48), "little") % P
             for _ in range(2 * n)]
        v[0] = v[1] = v[n + 1] = 0                   # zero components
        return v if curve == "G1" else [tb.Fq2(v[k], v[n + k])
                                        for k in range(n)]

    xs, ys = vals()[:n], vals()[:n]
    neg = [(-v) % P for v in ys] if curve == "G1" else \
        [tb.Fq2(-int(v.c0) % P, -int(v.c1) % P) for v in ys]
    x, y = F.pack(xs), F.pack(ys)
    xtab, ytab = fk.slot_tables(F, x, y)
    assert xtab.shape == (n, F.U) and ytab.shape == (2 * n, F.U)
    assert xtab.is_contiguous() and ytab.is_contiguous()
    assert torch.equal(xtab, x.t()) and torch.equal(ytab[:n], y.t())
    assert torch.equal(ytab[n:], F.pack(neg).t())
    assert torch.equal(ytab[n:], fk.slot_tables_plain(F, x, y)[1][n:])
    with pytest.raises(ValueError, match="slot_tables"):
        fk.slot_tables(F, x, y[:, 1:])
    with pytest.raises(ValueError, match="slot_tables"):
        fk.slot_tables(F, x.to(torch.int64), y)
