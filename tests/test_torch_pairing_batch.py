"""The port's batched multi-pairing and its router
(`crypto_tpu_torch/curves/tpairing.py` `TPairing.multi_pairings`,
`pairing_route`, `multi_pairings_routed`).

* Four groups of 1, 2 (one pair at infinity), 3 and 0 pairs as one batch
  through the plain kernels on the CPU (3 x 4 lanes, the short groups
  filled with inactive lanes): each group's Miller product equals the
  host Miller loop of its pairs, and each result the host
  `multi_pairing`, bit for bit.
* The router on both sides of `PAIRING_BATCH_THRESHOLD` (lowered to the
  call's weight, 6 pairs and 4 products at `HOST_GROUP_PAIRS` each, then
  one above it) with `CRYPTO_TPU_PAIRING_BACKEND` unset, and the
  variable's "host" and other values on either side; the shipped
  threshold's side for a SAVER decryption and a commitment check; BBS+'s
  batch verify takes its 2-pair product through the router.
"""

import random

import pytest

from crypto_tpu_torch.bbs_plus import batch
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import tpairing
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"


@pytest.fixture(scope="module")
def groups():
    rng = random.Random(1591)
    p = [tb.G1.rand(rng).normalize() for _ in range(5)]
    q = [tb.G2.rand(rng).normalize() for _ in range(5)]
    return [[(p[0], q[0])], [(p[1], q[1]), (tb.G1.infinity(), q[2])],
            [(p[2], q[2]), (p[3], q[3]), (p[4], q[4])], []]


def test_multi_pairings_on_the_plain_kernels(groups, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(tpairing, "PAIRING_BATCH_THRESHOLD",
                        6 + 4 * tpairing.HOST_GROUP_PAIRS)
    tp = tpairing.tpairing_for("bls12_381", "cpu")
    seen = {}
    real = tpairing.TPairing.miller_products

    def spy(self, gs):
        seen["f"] = real(self, gs)
        return seen["f"]

    monkeypatch.setattr(tpairing.TPairing, "miller_products", spy)
    assert tpairing.pairing_route(6, 4) == "device"
    out = tpairing.multi_pairings_routed(groups, device="cpu")
    assert tuple(seen["f"].shape) == (12 * tp.tf.L, 4)
    millers = tp.t12.unpack_host(seen["f"])
    for g, f, e in zip(groups, millers, out):
        assert f == (tb.miller_loop(g) if g else tb.Fq12.one())
        assert e == tb.multi_pairing(g)
    assert out[3].is_one()


class _Stub:
    """A device pairing that pairs on the host and counts its calls."""

    def __init__(self):
        self.calls = 0

    def multi_pairings(self, gs):
        self.calls += 1
        return [tb.multi_pairing(g) for g in gs]


@pytest.mark.parametrize("env, above, npairs, route", [
    (None, 1, 6, "host"), (None, 0, 6, "device"), ("host", -20, 6, "host"),
    ("device", 100, 2, "device"), ("jax", 100, 2, "device")])
def test_router(groups, monkeypatch, env, above, npairs, route):
    """`above`: the threshold's distance above the call's weight."""
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    gs = groups if npairs == 6 else [groups[1]]
    weight = npairs + tpairing.HOST_GROUP_PAIRS * len(gs)
    monkeypatch.setattr(tpairing, "PAIRING_BATCH_THRESHOLD", weight + above)
    stub = _Stub()
    monkeypatch.setattr(tpairing, "tpairing_for", lambda name, dev: stub)
    assert tpairing.pairing_route(npairs, len(gs)) == route
    out = tpairing.multi_pairings_routed(gs, device="cpu")
    assert stub.calls == (route == "device")
    assert out == [tb.multi_pairing(g) for g in gs]


def test_shipped_threshold(monkeypatch):
    """At 8-bit chunks a SAVER decryption (96 pairs in 64 products) goes
    to the device, a commitment check (34 pairs in one) and a 2-pair
    product stay on the host."""
    monkeypatch.delenv(ENV, raising=False)
    assert tpairing.pairing_route(96, 64) == "device"
    assert tpairing.pairing_route(34, 1) == "host"
    assert tpairing.pairing_route(2, 1) == "host"


def test_bbs_batch_takes_the_router(groups, monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(tpairing, "tpairing_for", lambda name, dev: stub)
    monkeypatch.delenv(ENV, raising=False)
    pairs = groups[2][:2]
    assert batch._multi_pairing(pairs, "cpu") == tb.multi_pairing(pairs)
    assert stub.calls == 0
    monkeypatch.setenv(ENV, "device")
    assert batch._multi_pairing(pairs, "cpu") == tb.multi_pairing(pairs)
    assert stub.calls == 1


def test_empty_groups_need_no_device():
    tp = tpairing.tpairing_for("bls12_381", "cpu")
    assert tp.multi_pairings([]) == []
    assert tp.multi_pairings([[], []]) == [tb.Fq12.one()] * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        if not __import__("torch").cuda.is_available():
            tpairing.multi_pairings_routed([[]])
