"""The port's LegoGroth16 prover (`crypto_tpu_torch/legogroth16/snark.py`
`create_proof`) against the reference's, on the CPU, on the chain
circuit and trapdoors of `test_torch_legogroth16.py` (whose helpers it
imports); the setup side is held to the reference there.

The port proves from the reference's proving key carried across by
`convert.proving_key_to_port`, with the same rng draws as the
reference's prover, and with its MSM threshold lowered to NC + 2 = 14
points so that the NTTs and the 15-point h query MSM run its device code
on the plain versions (a CPU MSM costs seconds; the others stay on the
host).  The proof must equal the reference's, and the reference's
verifier must accept it, carried back by `convert.proof_ints`, and
reject it tampered.  What `_msm_query` hands the device MSM for the
other queries, G1 and G2, at offsets 0 and 1, is checked against a
stand-in MSM.
"""

import random

import pytest
import torch

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.legogroth16 import snark as rsnark
from crypto_tpu.r1cs import cs as rcs
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves.tcurve import tcurve_for
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.r1cs import cs as tcs
from test_torch_legogroth16 import NC, TRAPDOORS, X0, chain_circuit
from crypto_tpu_torch.testing import cap_threads

cap_threads()


def public_input(F) -> list:
    v = F(X0)
    for i in range(NC):
        v = v * v + v + F(i)
    return [v]


@pytest.fixture(scope="module")
def run():
    ref_pk = rsnark.generate_parameters_with_trapdoors(
        chain_circuit(rcs, rb.Fr, NC), 1, random.Random(6),
        *(rb.Fr(t) for t in TRAPDOORS))
    ref_proof = rsnark.create_proof(chain_circuit(rcs, rb.Fr, NC, X0),
                                    ref_pk, random.Random(7))
    pk = convert.proving_key_to_port(ref_pk)
    msms = []
    real_msm = tsnark.msm_device_scheduled

    def msm(curve, points, scalars, **kw):
        msms.append((curve.name, points.X.shape[1], kw["device"]))
        return real_msm(curve, points, scalars, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsnark, "DEVICE_MSM_THRESHOLD", NC + 2)
        mp.setattr(tsnark, "msm_device_scheduled", msm)
        proof = tsnark.create_proof(chain_circuit(tcs, tb.Fr, NC, X0), pk,
                                    random.Random(7), device="cpu")
    return dict(ref_pk=ref_pk, ref_proof=ref_proof, pk=pk, proof=proof,
                msms=msms)


def test_h_query_msm_ran_on_the_device_code(run):
    """The h query MSM went through the device code (on the CPU), its
    query packed into the key's device cache."""
    assert run["msms"] == [("bls12_381.G1", 15, run["msms"][0][2])]
    assert str(run["msms"][0][2]) == "cpu"
    assert list(run["pk"].device_cache) == [("h_query", "cpu")]


@pytest.mark.parametrize("name,offset", [("a_query", 1), ("b_g2_query", 1),
                                         ("l_query", 0)])
def test_msm_query_hands_the_cached_slice_to_the_device_msm(run, name,
                                                            offset):
    """`_msm_query` packs the whole query once (Z = 1 or 0) and hands the
    device MSM columns [offset, offset + k) with the scalars as ints."""
    pk = convert.proving_key_to_port(run["ref_pk"])
    full = getattr(pk, name)
    k = len(full) - offset
    scalars = [tb.Fr(3 * i + 1) for i in range(k)]
    seen = []

    def fake(curve, points, sc, **kw):
        seen.append((curve, points, sc, kw["device"]))
        return curve.infinity()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsnark, "DEVICE_MSM_THRESHOLD", 1)
        mp.setattr(tsnark, "msm_device_scheduled", fake)
        for _ in range(2):
            tsnark._msm_query(pk, name, scalars, offset, device="cpu")
    tc = tcurve_for(full[0].curve, "cpu")
    want = tc.pack_points(full[offset:])
    assert len(seen) == 2 and list(pk.device_cache) == [(name, "cpu")]
    for curve, points, sc, dev in seen:
        assert curve is full[0].curve and str(dev) == "cpu"
        assert all(torch.equal(a, b) for a, b in zip(points, want))
        assert sc == [3 * i + 1 for i in range(k)]


def test_proof_equals_reference(run):
    proof, v, committed = run["proof"]
    ref_proof, ref_v, ref_committed = run["ref_proof"]
    assert int(v) == int(ref_v)
    assert [int(w) for w in committed] == [int(w) for w in ref_committed] \
        == [X0]
    for k in ("a", "b", "c", "d"):
        got = getattr(proof, k)
        assert got == convert.carry_point(getattr(ref_proof, k), got.curve)


def _ref_proof(proof):
    ints = convert.proof_ints(proof)
    return rsnark.Proof(**{k: convert.point_from_ints(
        v, rb.G2 if k == "b" else rb.G1) for k, v in ints.items()})


def test_reference_verifier_accepts_port_proof_and_rejects_tampering(run):
    proof, v, committed = run["proof"]
    ref_pk = run["ref_pk"]
    pvk = rsnark.PreparedVerifyingKey.from_vk(ref_pk.vk)
    pub = public_input(rb.Fr)
    rp = _ref_proof(proof)
    assert rsnark.verify_proof(pvk, rp, pub)
    assert rsnark.verify_commitment(ref_pk.vk, rp, pub,
                                    [rb.Fr(int(w)) for w in committed],
                                    rb.Fr(int(v)))
    G = rb.G1.generator()
    bad = rsnark.Proof(a=rp.a, b=rp.b, c=(rp.c + G).normalize(), d=rp.d)
    assert not rsnark.verify_proof(pvk, bad, pub)
    assert not rsnark.verify_proof(pvk, rp, [pub[0] + rb.Fr(1)])
    assert not rsnark.verify_commitment(ref_pk.vk, rp, pub,
                                        [rb.Fr(int(committed[0]) + 1)],
                                        rb.Fr(int(v)))
