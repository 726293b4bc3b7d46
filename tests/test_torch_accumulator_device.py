"""The port's device twin of the accumulator's batched witness update
(`crypto_tpu_torch/accumulator/device_update.py`) against the
reference's `crypto_tpu/accumulator/device_update.py`, on the CPU.

Exact (canonical integers), inputs from `random` seeds: the bit rows
(scalars near r - 1, near 2^254, at 0, with bit 31 of a limb set), both
polynomial scans at 3 members with empty batches, the zero-d_D case (a
member that is also removed: every factor 0 on both device paths, the
reference's host path raises), the routing rule, and one whole update
(mixed batch, 2 members) under CRYPTO_TPU_FORCE_DEVICE_ACCUM against the
reference's device function and its host path.  A whole update runs 255
double-and-add steps over 4 lanes (~25 s here), so this file runs one;
`test_torch_accumulator_update.py` runs the other two.
"""

import random

import numpy as np
import pytest
import torch

from crypto_tpu.accumulator import device_update as jdu
from crypto_tpu.accumulator import witness as jwit
from crypto_tpu.accumulator.setup import AccumSecretKey as JSecretKey
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.fields.jfield import jfield_for
from crypto_tpu_torch.accumulator import device_update as tdu
from crypto_tpu_torch.accumulator import witness as twit
from crypto_tpu_torch.accumulator.setup import AccumSecretKey as TSecretKey
from crypto_tpu_torch.convert import carry_point, point_ints
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.fields.tfield import tfield_for

FORCE, NO = "CRYPTO_TPU_FORCE_DEVICE_ACCUM", "CRYPTO_TPU_NO_DEVICE_ACCUM"
R = tb.R


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    monkeypatch.delenv(FORCE, raising=False)
    monkeypatch.delenv(NO, raising=False)


@pytest.fixture(scope="module")
def fields():
    return tfield_for(tb.Fr, "cpu"), jfield_for(jb.Fr)


def test_bits_msb_vs_reference(fields):
    T, Jr = fields
    rng = random.Random(21)
    vals = [0, 1, R - 1, R - 2, (1 << 254) - 1, 1 << 254, (1 << 254) + 1,
            0xFFFFFFFF, 0x80000000 << 32, rng.randrange(R)]
    nbits = jb.Fr.p.bit_length()
    port = tdu._bits_msb(T.pack(vals, mont=False), nbits)
    ref = np.asarray(jdu._bits_msb(Jr.pack(vals, mont=False), nbits))
    assert port.dtype == torch.int32 and port.shape == (nbits, len(vals))
    assert np.array_equal(port.numpy().T, ref)
    want = [[(v >> (nbits - 1 - i)) & 1 for i in range(nbits)] for v in vals]
    assert port.numpy().T.tolist() == want


@pytest.mark.parametrize("n", [0, 1, 4])
def test_eval_polys_vs_reference(fields, n):
    """d_A, v_A, d_D, v_D at 3 members: the port's loops against the
    reference's scans, and against the host polynomials."""
    from crypto_tpu_torch.accumulator import batch_utils as tbu
    T, Jr = fields
    rng = random.Random(22 + n)
    alpha = rng.randrange(1, R)
    members = [rng.randrange(R) for _ in range(3)]
    batch = [rng.randrange(R) for _ in range(n)]
    tx, jx = T.pack(members), Jr.pack(members)
    for tf, jf, hv in ((tdu._eval_add_polys, jdu._eval_add_polys,
                        tbu.poly_v_A_eval),
                       (tdu._eval_rem_polys, jdu._eval_rem_polys,
                        tbu.poly_v_D_eval)):
        td, tv = tf(T, tx, [tb.Fr(y) for y in batch], tb.Fr(alpha))
        jd, jv = jf(Jr, jx, [jb.Fr(y) for y in batch], jb.Fr(alpha))
        port = [list(T.unpack(td)), list(T.unpack(tv))]
        assert port == [list(Jr.unpack(jd)), list(Jr.unpack(jv))]
        host_d = [int(tbu.poly_d_eval([tb.Fr(y) for y in batch], tb.Fr(m)))
                  for m in members]
        host_v = [int(hv([tb.Fr(y) for y in batch], tb.Fr(alpha), tb.Fr(m)))
                  for m in members]
        assert port == [host_d, host_v]


def test_zero_dD_zeroes_every_factor(fields):
    """A member that is also removed has d_D = 0.  On the reference's device
    path `batch_inv` then inverts a zero root (inv(0) = 0), so every
    member's factor and scalar is 0 and every new witness is infinity; the
    port's twin computes the same scalars (zero bit rows, whose
    double-and-add is infinity: `test_torch_scalar_mul.py`), and the
    reference's host path raises."""
    T, _ = fields
    rng = random.Random(23)
    alpha = rng.randrange(1, R)
    members = [rng.randrange(R) for _ in range(3)]
    rems = [rng.randrange(R), members[1]]
    adds = [rng.randrange(R)]
    f, v = tdu._update_scalars(T, T.pack(members), [tb.Fr(y) for y in adds],
                               [tb.Fr(y) for y in rems], tb.Fr(alpha),
                               lambda key: None)
    assert list(T.unpack(f)) == [0] * 3 and list(T.unpack(v)) == [0] * 3
    jsk = JSecretKey(jb.Fr(alpha))
    G = jb.G1.generator()
    Cs = [G.mul_raw(rng.randrange(1, R)).normalize() for _ in members]
    V = G.mul_raw(rng.randrange(1, R)).normalize()
    args = ([jb.Fr(y) for y in adds], [jb.Fr(y) for y in rems],
            [jb.Fr(m) for m in members], Cs, V, jsk)
    d, pts = jdu.batch_update_with_sk_device(*args)
    assert [int(x) for x in d] == [0] * 3
    assert all(p.is_infinity() for p in pts)
    with pytest.raises(ZeroDivisionError):
        jwit._batch_update_with_sk(*args)


def test_enabled_routing(monkeypatch):
    """The reference's rule: from 512 members on CUDA, the environment
    overrides first; below it, and on the CPU, the host branch."""
    assert not tdu.enabled(10_000, "cpu")
    monkeypatch.setattr(tdu, "resolve_device",
                        lambda device: torch.device("cuda"))
    assert tdu.enabled(512) and not tdu.enabled(511)
    monkeypatch.setenv(NO, "1")
    assert not tdu.enabled(10_000)
    monkeypatch.delenv(NO)
    monkeypatch.setenv(FORCE, "1")
    assert tdu.enabled(1)


def update_inputs(seed: int, n_add: int, n_rem: int, n_members: int = 2):
    """Reference-side inputs of one update: a key, members with their
    witnesses against a random accumulator value, and the batches."""
    rng = random.Random(seed)
    alpha = rng.randrange(1, R)
    G = jb.G1.generator()
    lv = rng.randrange(1, R)
    members = [rng.randrange(R) for _ in range(n_members)]
    Cs = [G.mul_raw(lv * pow(m + alpha, -1, R) % R).normalize()
          for m in members]
    adds = [rng.randrange(R) for _ in range(n_add)]
    rems = [rng.randrange(R) for _ in range(n_rem)]
    return (jb.Fr(alpha), [jb.Fr(y) for y in adds], [jb.Fr(y) for y in rems],
            [jb.Fr(m) for m in members], Cs, G.mul_raw(lv).normalize())


def port_args(alpha, adds, rems, members, Cs, V):
    """The same inputs as the port's objects."""
    adds, rems, members = ([tb.Fr(int(x)) for x in xs]
                           for xs in (adds, rems, members))
    return (adds, rems, members, [carry_point(c, tb.G1) for c in Cs],
            carry_point(V, tb.G1), TSecretKey(tb.Fr(int(alpha))))


def test_mixed_update_vs_reference_device_and_host(monkeypatch):
    """One whole mixed update (3 additions, 2 removals, 2 members) through
    the port's `_batch_update_with_sk` on the CPU with the device path
    forced: equal to the reference's `batch_update_with_sk_device` and to
    its host path."""
    alpha, adds, rems, members, Cs, V = update_inputs(24, 3, 2)
    jsk = JSecretKey(alpha)
    host = jwit._batch_update_with_sk(adds, rems, members, Cs, V, jsk)
    monkeypatch.setenv(FORCE, "1")
    ref = jdu.batch_update_with_sk_device(adds, rems, members, Cs, V, jsk)
    timings = {}
    calls = []
    real = tdu.batch_update_with_sk_device

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw, timings=timings)

    monkeypatch.setattr(tdu, "batch_update_with_sk_device", spy)
    d, pts = twit._batch_update_with_sk(*port_args(alpha, adds, rems,
                                                   members, Cs, V),
                                        device="cpu")
    assert calls == [torch.device("cpu")]
    assert set(timings) == {"scans", "batch_inv", "bits", "scalar_mul",
                            "add", "to_affine", "unpack"}
    for want in (ref, host):
        assert [int(x) for x in d] == [int(x) for x in want[0]]
        assert [point_ints(p.normalize()) for p in pts] == \
            [point_ints(p.normalize()) for p in want[1]]
