"""The port's SnarkPack aggregation against the reference's
(`crypto_tpu_torch/legogroth16/aggregation.py`,
`crypto_tpu/legogroth16/aggregation.py`).

Two LegoGroth16 proofs of x * y = out (out public, x committed in D), made
by the port's prover on the CPU and carried to the reference; the
`GenericSRS` from the same seed in both packages.  At n = 2, with
`CRYPTO_TPU_PAIRING_BACKEND=host` (the reference's lazy checker would
otherwise send its pairs to the JAX pairing):

* the SRS and its specialisation equal the reference's;
* `aggregate_proofs` with D folded equals the reference's
  `AggregateProof` element for element, so every transcript challenge
  does; both verifiers accept it, and the port's rejects a wrong public
  input (one of the reference's own spoiled cases; the other, a wrong
  transcript label, is `test_torch_aggregation_groth16.py`'s);
* the prover's pairing products in three routed calls (the commitments,
  z_ab, the one GIPA round), and its pairs;
* the port's checker's device branch (the variable unset): its 21
  deferred pairs sent to `TPairing.miller_product`.

The forms without D are `test_torch_aggregation_groth16.py`'s.  The
8-proof aggregate against the reference is in the slow lane, as the
reference's own aggregation tests are.
"""

import random

import pytest

from crypto_tpu.legogroth16 import aggregation as jagg
from crypto_tpu.transcript.transcript import Transcript as JTranscript
from crypto_tpu_torch.convert import canonical
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import tpairing
from crypto_tpu_torch.legogroth16 import aggregation as tagg
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.testing import cap_threads
from crypto_tpu_torch.transcript.transcript import Transcript as TTranscript
from test_torch_saver import to_ref

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
F = tb.Fr


def mul_circuit(x=None, y=None):
    def circuit(cs):
        out = cs.new_input(None if x is None else x * y)
        a = cs.new_witness(x)
        b = cs.new_witness(y)
        cs.enforce(a.lc(), b.lc(), out.lc())
    return circuit


def _state(n: int, seed: int):
    """A proving key, n proofs and their public inputs (the port's), the
    SRS specialised to n in both packages."""
    rng = random.Random(seed)
    pk = tsnark.generate_random_parameters(mul_circuit(), 1, rng,
                                           device="cpu")
    proofs, publics = [], []
    for _ in range(n):
        x, y = F.rand(rng), F.rand(rng)
        proofs.append(tsnark.create_proof(mul_circuit(x, y), pk, rng,
                                          device="cpu")[0])
        publics.append([x * y])
    srs_p = tagg.GenericSRS.setup(random.Random(seed + 1), n)
    srs_r = jagg.GenericSRS.setup(random.Random(seed + 1), n)
    return dict(pk=pk, proofs=proofs, publics=publics, srs_p=srs_p,
                srs_r=srs_r, vk_r=to_ref(pk.vk), proofs_r=to_ref(proofs),
                publics_r=to_ref(publics), spec_p=srs_p.specialize(n),
                spec_r=srs_r.specialize(n))


@pytest.fixture(scope="module")
def two():
    return _state(2, 1551)


@pytest.fixture
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


def _verify(pkg, T, st, agg, label=b"agg", publics=None, **kw):
    port = pkg is tagg
    vk = st["pk"].vk if port else st["vk_r"]
    pub = publics if publics is not None else \
        st["publics"] if port else st["publics_r"]
    extra = {"device": "cpu"} if port else {}
    return pkg.verify_aggregate_proof(
        (st["spec_p"] if port else st["spec_r"])[1], vk, pub, agg,
        random.Random(1553), T(label), **kw, **extra)


def test_srs_equals_reference(two):
    assert canonical(two["srs_p"]) == canonical(two["srs_r"])
    assert canonical(two["spec_p"]) == canonical(two["spec_r"])
    with pytest.raises(tagg.AggregationError):
        two["srs_p"].specialize(3)


@pytest.fixture(scope="module")
def with_d(two):
    """The n = 2 aggregate with D folded, by the port (its `timings`) and
    by the reference, the pairings on the host."""
    mp = pytest.MonkeyPatch()
    mp.setenv(ENV, "host")
    try:
        timings = {}
        agg = tagg.aggregate_proofs(two["spec_p"][0], TTranscript(b"agg"),
                                    two["proofs"], device="cpu",
                                    timings=timings)
        want = jagg.aggregate_proofs(two["spec_r"][0], JTranscript(b"agg"),
                                     two["proofs_r"])
    finally:
        mp.undo()
    return agg, want, timings


def test_aggregate_with_d(two, with_d, host_pairing):
    """Equal to the reference's; both verifiers accept it, the port's
    rejects a wrong public input."""
    agg, want, timings = with_d
    assert canonical(agg) == canonical(want)
    assert agg.com_d is not None and len(agg.gipa.comms_d) == 1
    assert [c[:2] for c in timings["pairing_calls"]] == \
        [(6, 16), (1, 2), (14, 18)]
    assert timings["pairing_s"] > 0 and timings["msm_s"] > 0
    assert _verify(tagg, TTranscript, two, agg)
    assert _verify(jagg, JTranscript, two, want)
    bad = [[p[0] + F(1)] for p in two["publics"]]
    assert not _verify(tagg, TTranscript, two, agg, publics=bad)


def test_checker_device_branch(two, with_d, monkeypatch):
    """The variable unset: the verifier's lazy checker holds 21 deferred
    pairs, over its 8, so its Miller product goes to `TPairing` (a
    stand-in here that records the call and runs the host Miller loop:
    `TPairing.miller_product` on the plain kernels is
    `test_torch_checkers.py`'s and `test_torch_pairing.py`'s)."""
    monkeypatch.delenv(ENV, raising=False)
    seen = []

    def spy(self, pairs):
        seen.append(len(pairs))
        return tb.miller_loop(pairs)

    monkeypatch.setattr(tpairing.TPairing, "miller_product", spy)
    assert _verify(tagg, TTranscript, two, with_d[0])
    assert seen == [21]


@pytest.mark.slow
def test_aggregate_8_vs_reference(monkeypatch):
    """n = 8 with D: three GIPA rounds."""
    monkeypatch.setenv(ENV, "host")
    st = _state(8, 1555)
    agg = tagg.aggregate_proofs(st["spec_p"][0], TTranscript(b"agg"),
                                st["proofs"], device="cpu")
    want = jagg.aggregate_proofs(st["spec_r"][0], JTranscript(b"agg"),
                                 st["proofs_r"])
    assert canonical(agg) == canonical(want)
    assert _verify(tagg, TTranscript, st, agg)
    assert _verify(jagg, JTranscript, st, want)
