"""The port's LegoGroth16 over both curves (`ctx` = the port's
`curves.bls12_381` or `curves.bn254`), set up, proved, verified and
rerandomised on the CPU, against the reference's over the same curve.

A chain circuit of 12 constraints (`test_torch_legogroth16.py`'s, one
public input, the first witness committed), the same trapdoors and the
same rng draws on both sides:

* the proving key and the proof equal the reference's, point by point
  (over BN254 with the MSM threshold at NC + 2 = 14 points, so that the
  15-point h query MSM runs the device code on the plain versions at 8
  limbs);
* the port's verifier (`verify_proof`, on the host pairing of `ctx`, as
  the reference's) accepts the reference's proof and its own, and
  rejects a spoiled C and a spoiled public input; `verify_commitment`
  opens D with v and refuses another witness;
* the reference's verifier accepts the port's proof;
* `rerandomize_proof` and `rerandomize_proof_1` equal the reference's
  for the same rng, their outputs verify, and the second opens with the
  new v;
* `verify_proof_with_checker` (BLS12-381: the checkers are BLS12-381
  only, as the reference's) agrees with `verify_proof`.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.curves import bn254 as rbn
from crypto_tpu.legogroth16 import snark as rsnark
from crypto_tpu.r1cs import cs as rcs
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.r1cs import cs as tcs
from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
from test_torch_legogroth16 import NC, TRAPDOORS, X0, chain_circuit
from crypto_tpu_torch.testing import cap_threads

cap_threads()

CURVES = {"bls12_381": (rb, tb), "bn254": (rbn, tbn)}


def _public_input(F) -> list:
    v = F(X0)
    for i in range(NC):
        v = v * v + v + F(i)
    return [v]


def _to_port(proof, mod):
    return tsnark.Proof(**{k: convert.carry_point(
        getattr(proof, k), mod.G2 if k == "b" else mod.G1)
        for k in ("a", "b", "c", "d")})


def _to_ref(proof, mod):
    return rsnark.Proof(**{k: convert.carry_point(
        getattr(proof, k), mod.G2 if k == "b" else mod.G1)
        for k in ("a", "b", "c", "d")})


_RUNS: dict = {}


def _setup_and_prove(name: str) -> dict:
    """Both packages' key and proof over the curve `name` (built once)."""
    if name in _RUNS:
        return _RUNS[name]
    rmod, tmod = CURVES[name]
    ref_pk = rsnark.generate_parameters_with_trapdoors(
        chain_circuit(rcs, rmod.Fr, NC), 1, random.Random(6),
        *(rmod.Fr(t) for t in TRAPDOORS), ctx=rmod)
    ref_proof = rsnark.create_proof(chain_circuit(rcs, rmod.Fr, NC, X0),
                                    ref_pk, random.Random(7), ctx=rmod)
    pk = tsnark.generate_parameters_with_trapdoors(
        chain_circuit(tcs, tmod.Fr, NC), 1, random.Random(6),
        *(tmod.Fr(t) for t in TRAPDOORS), ctx=tmod, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if tmod is tbn:
            mp.setattr(tsnark, "DEVICE_MSM_THRESHOLD", NC + 2)
        proof = tsnark.create_proof(chain_circuit(tcs, tmod.Fr, NC, X0), pk,
                                    random.Random(7), ctx=tmod,
                                    device="cpu")
    assert list(pk.device_cache) == ([("h_query", "cpu")] if tmod is tbn
                                     else [])
    pvk = tsnark.PreparedVerifyingKey.from_vk(pk.vk, ctx=tmod)
    _RUNS[name] = dict(rmod=rmod, tmod=tmod, ref_pk=ref_pk,
                       ref_proof=ref_proof, pk=pk, proof=proof, pvk=pvk,
                       pub=_public_input(tmod.Fr))
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(CURVES))
def run(request):
    return _setup_and_prove(request.param)


def test_key_and_proof_equal_reference(run):
    tmod = run["tmod"]
    assert run["pk"] == convert.proving_key_to_port(run["ref_pk"], tmod)
    assert run["pk"].h_query[0].curve is tmod.G1
    (proof, v, committed), (ref, ref_v, ref_committed) = \
        run["proof"], run["ref_proof"]
    assert int(v) == int(ref_v)
    assert [int(w) for w in committed] == [int(w) for w in ref_committed]
    assert proof == _to_port(ref, tmod)


def test_port_verifier_accepts_and_rejects(run):
    tmod, pvk, pub = run["tmod"], run["pvk"], run["pub"]
    proof, v, committed = run["proof"]
    assert convert.fp12_ints(pvk.alpha_beta) == convert.fp12_ints(
        rsnark.PreparedVerifyingKey.from_vk(run["ref_pk"].vk,
                                            ctx=run["rmod"]).alpha_beta)
    ref_proof = _to_port(run["ref_proof"][0], tmod)
    assert tsnark.verify_proof(pvk, ref_proof, pub, ctx=tmod)
    assert tsnark.verify_proof(pvk, proof, pub, ctx=tmod)
    G = tmod.G1.generator()
    bad = tsnark.Proof(a=proof.a, b=proof.b, c=(proof.c + G).normalize(),
                       d=proof.d)
    assert not tsnark.verify_proof(pvk, bad, pub, ctx=tmod)
    assert not tsnark.verify_proof(pvk, proof, [pub[0] + tmod.Fr(1)],
                                   ctx=tmod)
    vk = run["pk"].vk
    assert tsnark.verify_commitment(vk, proof, pub, committed, v, ctx=tmod)
    assert not tsnark.verify_commitment(vk, proof, pub,
                                        [committed[0] + tmod.Fr(1)], v,
                                        ctx=tmod)
    with pytest.raises(tsnark.LegoGroth16Error):
        tsnark.prepare_inputs(vk, pub + pub, ctx=tmod)


def test_reference_verifier_accepts_port_proof(run):
    rmod = run["rmod"]
    ref_pvk = rsnark.PreparedVerifyingKey.from_vk(run["ref_pk"].vk, ctx=rmod)
    proof, v, committed = run["proof"]
    rp = _to_ref(proof, rmod)
    pub = [rmod.Fr(int(x)) for x in run["pub"]]
    assert rsnark.verify_proof(ref_pvk, rp, pub, ctx=rmod)
    assert rsnark.verify_commitment(run["ref_pk"].vk, rp, pub,
                                    [rmod.Fr(int(committed[0]))],
                                    rmod.Fr(int(v)), ctx=rmod)


def test_rerandomised_proofs_equal_reference_and_verify(run):
    rmod, tmod, pvk, pub = run["rmod"], run["tmod"], run["pvk"], run["pub"]
    pk, ref_pk = run["pk"], run["ref_pk"]
    proof, v, committed = run["proof"]
    ref, ref_v, _ = run["ref_proof"]
    re = tsnark.rerandomize_proof(proof, pk.vk, random.Random(8), ctx=tmod)
    ref_re = rsnark.rerandomize_proof(ref, ref_pk.vk, random.Random(8),
                                      ctx=rmod)
    assert re == _to_port(ref_re, tmod) and re != proof
    assert tsnark.verify_proof(pvk, re, pub, ctx=tmod)
    new_v = tmod.Fr(0x5EED)
    re1 = tsnark.rerandomize_proof_1(proof, v, new_v, pk.vk,
                                     pk.eta_delta_inv_g1, random.Random(9),
                                     ctx=tmod)
    ref_re1 = rsnark.rerandomize_proof_1(
        ref, ref_v, rmod.Fr(0x5EED), ref_pk.vk, ref_pk.eta_delta_inv_g1,
        random.Random(9), ctx=rmod)
    assert re1 == _to_port(ref_re1, tmod)
    assert tsnark.verify_proof(pvk, re1, pub, ctx=tmod)
    assert tsnark.verify_commitment(pk.vk, re1, pub, committed, new_v,
                                    ctx=tmod)
    assert not tsnark.verify_commitment(pk.vk, re1, pub, committed, v,
                                        ctx=tmod)


def test_verify_with_checker_agrees_with_verify_proof():
    run = _setup_and_prove("bls12_381")
    pvk, pub = run["pvk"], run["pub"]
    proof = run["proof"][0]
    G = tb.G1.generator()
    bad = tsnark.Proof(a=proof.a, b=proof.b, c=(proof.c + G).normalize(),
                       d=proof.d)
    for p, want in ((proof, True), (bad, False)):
        checker = RandomizedPairingChecker(tb.Fr(0xC0FFEE), device="cpu")
        tsnark.verify_proof_with_checker(pvk, p, pub, checker)
        assert checker.verify() is want
        assert tsnark.verify_proof(pvk, p, pub) is want


def test_ctx_must_be_a_port_curve_module():
    for ctx in (tb, tbn):
        tsnark._check_ctx(ctx)
    for ctx in (rb, rbn, None):
        with pytest.raises(tsnark.LegoGroth16Error):
            tsnark._check_ctx(ctx)
