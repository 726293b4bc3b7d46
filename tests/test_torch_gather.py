"""The port's column gather (`gather_cols`, its plain version on the CPU)
against the reference's `gather_rows_t_fn` run in Pallas interpret mode
at the sizes of `tests/test_pallas_interpret.py` (N = 300 rows of 26
words, M = 2,048 indices, some negative), and the wrapper's checks.

The reference gathers rows of an (N, ncols) payload into a transposed
(ncols, M) output; the port's payload is limb-major already, so it
gathers the columns of the (ncols, N) transpose.  A negative index gives
a zero column in both; in the port an index >= N does too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crypto_tpu_torch.ops.kernels import field_kernels as fk

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
    got = fk.gather_cols(torch.from_numpy(payload.T.copy()),
                         torch.from_numpy(idx.astype(np.int64)))
    assert got.dtype == torch.int32 and got.shape == (C, M)
    assert np.array_equal(got.numpy(), ref)
    assert not got[:, idx < 0].any()
    assert np.array_equal(got[:, idx >= 0].numpy(),
                          payload[idx[idx >= 0]].T)


def test_gather_cols_plain_is_the_wrapper_on_cpu():
    payload, idx = _inputs()
    src = torch.from_numpy(payload.T.copy())
    ix = torch.from_numpy(idx.astype(np.int64))
    assert torch.equal(fk.gather_cols(src, ix), fk.gather_cols_plain(src, ix))
    empty = fk.gather_cols(src, torch.empty(0, dtype=torch.int64))
    assert empty.shape == (C, 0)
    assert not fk.gather_cols(src, torch.full((5,), -1)).any()


def test_gather_cols_checks():
    src = torch.zeros((C, N), dtype=torch.int32)
    ix = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        fk.gather_cols(src, ix.to(torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fk.gather_cols(src.to(torch.int64), ix)
    with pytest.raises(ValueError, match="contiguous"):
        fk.gather_cols(src.t(), ix)
    with pytest.raises(ValueError):
        fk.gather_cols(src.unsqueeze(0), ix)
    with pytest.raises(ValueError):
        fk.gather_cols(src, ix.reshape(2, 2))
    with pytest.raises(ValueError, match="device"):
        fk.gather_cols(src.to("meta"), ix.to("meta"))


def test_gather_cols_index_outside_source_gives_zero():
    """An index outside [0, N) gives a zero column, as the kernel gives
    one (it reads nothing outside the source)."""
    payload, _ = _inputs()
    src = torch.from_numpy(payload.T.copy())
    ix = torch.tensor([N, -1, 5, N + 7, -3, N - 1])
    got = fk.gather_cols(src, ix)
    assert torch.equal(got, fk.gather_cols_plain(src, ix))
    assert not got[:, [0, 1, 3, 4]].any()
    assert torch.equal(got[:, [2, 5]], src[:, [5, N - 1]])
