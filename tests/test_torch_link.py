"""The port's LegoGroth16 bound check and cp_link against the reference's
(`crypto_tpu_torch/legogroth16/{bound_check,link}.py`,
`crypto_tpu/legogroth16/{bound_check,link}.py`).

* The bound-check circuit's constraint rows and assignment equal the
  reference's, and a value out of bounds is refused by both;
* the bound-check CRS from the same rng equals the reference's; a proof
  of min <= w < max (the port's prover on the CPU; in the default lane
  the reference's prover a stand-in returning it, as in
  `test_torch_saver_proof.py`, in the slow lane the reference's own)
  equals the reference's, both verifiers accept it, the port's refuses
  other bounds;
* the subspace SNARK on a 2 x 3 matrix with a zero entry: keys and proof
  equal the reference's, both verifiers accept, a wrong statement fails;
* cp_link over that CRS: `LinkKeys`, `create_proof_incl_cp_link` equal to
  the reference's (its prover a stand-in or its own, as above), both verifiers accept it and the port's refuses a
  spoiled link commitment; `verify_link_commitment` opens it.
"""

import dataclasses
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.legogroth16 import bound_check as jbc
from crypto_tpu.legogroth16 import link as jlink
from crypto_tpu.legogroth16 import snark as jsnark
from crypto_tpu.r1cs import cs as jcs
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16 import bound_check as tbc
from crypto_tpu_torch.legogroth16 import link as tlink
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.r1cs import cs as tcs
from crypto_tpu_torch.testing import cap_threads
from test_torch_saver import stand_in_prover, to_ref

cap_threads()

LO, HI, W = 18, 1 << 40, 123456789


def test_bound_check_circuit():
    for vals in ((None, None, None), (LO, HI, W)):
        mode = "setup" if vals[0] is None else "prove"
        got = tcs.ConstraintSystem(tb.Fr, mode=mode)
        want = jcs.ConstraintSystem(jb.Fr, mode=mode)
        tbc.bound_check_circuit(*vals)(got)
        jbc.bound_check_circuit(*vals)(want)
        assert (got.a_rows, got.b_rows, got.c_rows) == \
            (want.a_rows, want.b_rows, want.c_rows)
        if mode == "prove":
            assert got.is_satisfied()
            assert [int(v) for v in got.full_assignment()] == \
                [int(v) for v in want.full_assignment()]
    for pkg, mod, err in ((tbc, tcs, tsnark), (jbc, jcs, jsnark)):
        F = tb.Fr if pkg is tbc else jb.Fr
        with pytest.raises(err.LegoGroth16Error):
            pkg.bound_check_circuit(LO, HI, HI)(mod.ConstraintSystem(F))


@pytest.fixture(scope="module")
def srs():
    want = jbc.generate_snark_srs_bound_check(random.Random(1581))
    got = tbc.generate_snark_srs_bound_check(random.Random(1581),
                                             device="cpu")
    return got, want


def _bound_check(srs, monkeypatch, real_prover):
    pk, pk_r = srs
    assert canonical(pk) == canonical(pk_r)
    if not real_prover:
        stand_in_prover(monkeypatch)
    got = tbc.prove_bound_check(pk, W, LO, HI, random.Random(1582),
                                v=tb.Fr(1583), device="cpu")
    want = jbc.prove_bound_check(pk_r, W, LO, HI, random.Random(1582),
                                 v=jb.Fr(1583))
    assert canonical(got) == canonical(want)
    pvk = tsnark.PreparedVerifyingKey.from_vk(pk.vk)
    assert tbc.verify_bound_check(pvk, got[0], LO, HI)
    assert jbc.verify_bound_check(
        jsnark.PreparedVerifyingKey.from_vk(pk_r.vk), want[0], LO, HI)
    assert not tbc.verify_bound_check(pvk, got[0], LO + 1, HI)


def test_bound_check(srs, monkeypatch):
    _bound_check(srs, monkeypatch, False)


@pytest.mark.slow
def test_bound_check_real_reference_prover(srs, monkeypatch):
    _bound_check(srs, monkeypatch, True)


def test_subspace_snark():
    rng_p, rng_r = random.Random(1584), random.Random(1584)
    pts = [tb.G1.rand(rng_p).normalize() for _ in range(5)]
    m = [[pts[0], pts[1], pts[2]], [pts[3], tb.G1.infinity(), pts[4]]]
    for _ in range(5):
        jb.G1.rand(rng_r)
    ek, vk = tlink.subspace_keygen(rng_p, m)
    ek_r, vk_r = jlink.subspace_keygen(rng_r, to_ref(m))
    assert canonical((ek, vk)) == canonical((ek_r, vk_r))
    w = [tb.Fr(v) for v in (3, 5, 7)]
    x = [(m[0][0] * 3 + m[0][1] * 5 + m[0][2] * 7).normalize(),
         (m[1][0] * 3 + m[1][2] * 7).normalize()]
    pi = tlink.subspace_prove(ek, w)
    assert canonical(pi) == canonical(jlink.subspace_prove(ek_r, to_ref(w)))
    assert tlink.subspace_verify(vk, x, pi)
    assert jlink.subspace_verify(vk_r, to_ref(x), to_ref(pi))
    assert not tlink.subspace_verify(vk, [x[1], x[0]], pi)


def _cp_link(srs, monkeypatch, real_prover):
    pk, pk_r = srs
    keys = tlink.generate_link_keys(random.Random(1585), pk.vk)
    keys_r = jlink.generate_link_keys(random.Random(1585), pk_r.vk)
    assert canonical(keys) == canonical(keys_r)
    if not real_prover:
        stand_in_prover(monkeypatch)
    got = tlink.create_proof_incl_cp_link(
        tbc.bound_check_circuit(LO, HI, W), pk, keys, random.Random(1586),
        device="cpu")
    want = jlink.create_proof_incl_cp_link(
        jbc.bound_check_circuit(LO, HI, W), pk_r, keys_r,
        random.Random(1586))
    assert canonical(got) == canonical(want)
    proof, link_v, committed = got
    pvk = tsnark.PreparedVerifyingKey.from_vk(pk.vk)
    pub = [tb.Fr(LO), tb.Fr(HI)]
    assert tlink.verify_proof_incl_cp_link(pvk, keys, proof, pub)
    assert jlink.verify_proof_incl_cp_link(
        jsnark.PreparedVerifyingKey.from_vk(pk_r.vk), keys_r, want[0],
        to_ref(pub))
    bad = dataclasses.replace(proof, link_d=(proof.link_d
                                             + keys.link_h).normalize())
    assert not tlink.verify_proof_incl_cp_link(pvk, keys, bad, pub)
    assert tlink.verify_link_commitment(keys, proof.link_d, committed, link_v)
    assert not tlink.verify_link_commitment(keys, proof.link_d,
                                            [committed[0] + tb.Fr(1)], link_v)
    assert canonical(protocol_to_port(keys_r)) == canonical(keys)


def test_cp_link(srs, monkeypatch):
    _cp_link(srs, monkeypatch, False)


@pytest.mark.slow
def test_cp_link_real_reference_prover(srs, monkeypatch):
    _cp_link(srs, monkeypatch, True)
