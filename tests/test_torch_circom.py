"""The port's Circom frontend (`crypto_tpu_torch/legogroth16/circom.py`)
against the reference's (`crypto_tpu/legogroth16/circom.py`), on `.r1cs`
files that the tests write themselves (`testing.r1cs_bytes`, in iden3's
format): the reference's own vectors are not in this repository.

* Both packages parse the same bytes into equal circuits, over
  BLS12-381's r and BN254's (circom's default), and synthesize them into
  equal constraint systems; a satisfied and an unsatisfied assignment,
  and a curve mismatch, as the reference's `tests/test_circom*.py`.
* A multiply2 circuit (a * b = out, a committed) is set up and proved by
  both on each curve from the same rng and trapdoors: equal keys and
  proofs, each verifier accepts the other's proof and refuses another
  public input; D opens to a.
* `chip_smoke.py`'s `chain_circuit`, written out as `.r1cs` and read back
  through `circom_circuit`, is the same constraint system as the chain
  circuit itself (wires, order, rows, one committed witness), so the
  same proving key serves both: a proof over the Circom circuit verifies
  under the chain circuit's key.
"""

import random
import sys
from pathlib import Path

import pytest

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.curves import bn254 as rbn
from crypto_tpu.legogroth16 import circom as rcircom
from crypto_tpu.legogroth16 import snark as rsnark
from crypto_tpu.r1cs import cs as rcs
from crypto_tpu_torch import convert
from crypto_tpu_torch.convert import canonical
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import bn254 as tbn
from crypto_tpu_torch.legogroth16 import circom as tcircom
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.r1cs import cs as tcs
from crypto_tpu_torch.testing import cap_threads, r1cs_bytes, r1cs_of

cap_threads()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CURVES = {"bls12_381": (rb, tb), "bn254": (rbn, tbn)}
TRAPDOORS = (11, 13, 17, 19, 23)


def multiply2(prime: int) -> bytes:
    """circom's multiply2: wires [1, out, a, b], a * b = out."""
    return r1cs_bytes(prime, 1, 0, 2, 4,
                      [([(1, 2)], [(1, 3)], [(1, 1)])])


def other_circuit(prime: int) -> bytes:
    """Two outputs, a public input, three private inputs and an internal
    wire; coefficients up to p - 1 and several terms a side."""
    p = prime
    return r1cs_bytes(p, 2, 1, 3, 8, [
        ([(1, 4), (p - 1, 5)], [(3, 6), (1, 0)], [(1, 7)]),
        ([(1, 7)], [(1, 3)], [(1, 1), (p - 2, 4)]),
        ([(5, 0)], [(1, 5), (1, 6)], [(1, 2)])])


def parse_both(data: bytes, tmp_path):
    path = tmp_path / "circuit.r1cs"
    path.write_bytes(data)
    return rcircom.parse_r1cs(str(path)), tcircom.parse_r1cs(str(path))


@pytest.mark.parametrize("curve", list(CURVES))
@pytest.mark.parametrize("make", [multiply2, other_circuit])
def test_parse_equal(curve, make, tmp_path):
    rmod, tmod = CURVES[curve]
    data = make(tmod.R)
    ref, port = parse_both(data, tmp_path)
    assert canonical(ref) == canonical(port)
    assert canonical(convert.protocol_to_port(ref)) == canonical(port)
    assert canonical(tcircom.parse_r1cs_bytes(data)) == canonical(port)
    assert port.prime == tmod.R and port.n_public == ref.n_public
    with pytest.raises(tcs.SynthesisError):
        tcircom.parse_r1cs_bytes(b"r1cx" + data[4:])


def _synth(circom, cs_mod, F, r1cs, wires=None, mode="setup"):
    cs = cs_mod.ConstraintSystem(F, mode=mode)
    circom.circom_circuit(r1cs, field=F, wire_assignment=wires)(cs)
    return cs


def _rows(cs) -> tuple:
    return (cs.num_instance, cs.num_witness, cs.a_rows, cs.b_rows,
            cs.c_rows, [int(v) for v in cs.full_assignment()])


@pytest.mark.parametrize("curve", list(CURVES))
def test_synthesis_equal(curve, tmp_path):
    rmod, tmod = CURVES[curve]
    ref, port = parse_both(multiply2(tmod.R), tmp_path)
    rng = random.Random(21)
    a, b = rng.randrange(tmod.R), rng.randrange(tmod.R)
    good = [1, a * b % tmod.R, a, b]
    bad = [1, (a * b + 1) % tmod.R, a, b]
    for mode, wires in (("setup", None), ("prove", good), ("prove", bad)):
        r = _synth(rcircom, rcs, rmod.Fr, ref,
                   wires and [rmod.Fr(x) for x in wires], mode)
        t = _synth(tcircom, tcs, tmod.Fr, port,
                   wires and [tmod.Fr(x) for x in wires], mode)
        assert _rows(r) == _rows(t)
        if mode == "prove":
            assert t.is_satisfied() is (wires is good) is r.is_satisfied()
    with pytest.raises(tcs.SynthesisError):
        _synth(tcircom, tcs, tmod.Fr, port, mode="prove")
    other = tbn if tmod is tb else tb
    with pytest.raises(tcs.SynthesisError):
        tcircom.circom_circuit(port, field=other.Fr)


@pytest.mark.parametrize("curve", list(CURVES))
def test_prove_multiply2(curve, tmp_path):
    rmod, tmod = CURVES[curve]
    ref, port = parse_both(multiply2(tmod.R), tmp_path)
    rng = random.Random(22)
    a, b = rng.randrange(tmod.R), rng.randrange(tmod.R)
    out = a * b % tmod.R
    wires = [1, out, a, b]
    ref_pk = rsnark.generate_parameters_with_trapdoors(
        rcircom.circom_circuit(ref, field=rmod.Fr), 1, random.Random(23),
        *(rmod.Fr(x) for x in TRAPDOORS), ctx=rmod)
    pk = tsnark.generate_parameters_with_trapdoors(
        tcircom.circom_circuit(port, field=tmod.Fr), 1, random.Random(23),
        *(tmod.Fr(x) for x in TRAPDOORS), ctx=tmod, device="cpu")
    assert pk == convert.proving_key_to_port(ref_pk, tmod)
    ref_proof, ref_v, ref_committed = rsnark.create_proof(
        rcircom.circom_circuit(ref, field=rmod.Fr,
                               wire_assignment=[rmod.Fr(x) for x in wires]),
        ref_pk, random.Random(24), ctx=rmod)
    proof, v, committed = tsnark.create_proof(
        tcircom.circom_circuit(port, field=tmod.Fr,
                               wire_assignment=[tmod.Fr(x) for x in wires]),
        pk, random.Random(24), ctx=tmod, device="cpu")
    assert convert.proof_ints(proof) == convert.proof_ints(ref_proof)
    assert int(v) == int(ref_v) and [int(c) for c in committed] == \
        [int(c) for c in ref_committed] == [a]
    pvk = tsnark.PreparedVerifyingKey.from_vk(pk.vk, ctx=tmod)
    ref_pvk = rsnark.PreparedVerifyingKey.from_vk(ref_pk.vk, ctx=rmod)
    carried = tsnark.Proof(**{k: convert.carry_point(
        getattr(ref_proof, k), tmod.G2 if k == "b" else tmod.G1)
        for k in "abcd"})
    back = rsnark.Proof(**{k: convert.carry_point(
        getattr(proof, k), rmod.G2 if k == "b" else rmod.G1)
        for k in "abcd"})
    assert tsnark.verify_proof(pvk, carried, [tmod.Fr(out)], ctx=tmod)
    assert rsnark.verify_proof(ref_pvk, back, [rmod.Fr(out)], ctx=rmod)
    assert not tsnark.verify_proof(pvk, proof, [tmod.Fr(out + 1)], ctx=tmod)
    assert not rsnark.verify_proof(ref_pvk, back, [rmod.Fr(out + 1)],
                                   ctx=rmod)
    assert tsnark.verify_commitment(pk.vk, proof, [tmod.Fr(out)], committed,
                                    v, ctx=tmod)


@pytest.mark.parametrize("curve", list(CURVES))
@pytest.mark.parametrize("nc", [4, 28])
def test_chain_circuit_as_circom(curve, nc):
    """The chain circuit and its `.r1cs` synthesize the same system, in
    setup and prove mode (out, then x, then the chain's values)."""
    _, tmod = CURVES[curve]
    F = tmod.Fr
    chain = tcs.ConstraintSystem(F, mode="setup")
    chip_smoke.chain_circuit(nc, F=F)(chain)
    r1cs = tcircom.parse_r1cs_bytes(r1cs_of(chain, 1, 1))
    assert (r1cs.n_wires, r1cs.n_public, r1cs.n_prv_in) == (nc + 2, 1, 1)
    assert _rows(_synth(tcircom, tcs, F, r1cs)) == _rows(chain)
    x = F(0x1234567)
    proving = tcs.ConstraintSystem(F, mode="prove")
    chip_smoke.chain_circuit(nc, x, F)(proving)
    wires = proving.full_assignment()
    assert _rows(_synth(tcircom, tcs, F, r1cs, wires, "prove")) == \
        _rows(proving)
    assert proving.is_satisfied()


def test_chain_key_serves_circom():
    """One key from the chain circuit; a proof over its Circom form
    verifies under it and equals the chain circuit's proof from the same
    rng."""
    nc, F = 12, tb.Fr
    chain = tcs.ConstraintSystem(F, mode="setup")
    chip_smoke.chain_circuit(nc, F=F)(chain)
    r1cs = tcircom.parse_r1cs_bytes(r1cs_of(chain, 1, 1))
    pk = tsnark.generate_parameters_with_trapdoors(
        chip_smoke.chain_circuit(nc, F=F), 1, random.Random(25),
        *(F(x) for x in TRAPDOORS), device="cpu")
    assert pk == tsnark.generate_parameters_with_trapdoors(
        tcircom.circom_circuit(r1cs), 1, random.Random(25),
        *(F(x) for x in TRAPDOORS), device="cpu")
    x = F(99)
    proving = tcs.ConstraintSystem(F, mode="prove")
    chip_smoke.chain_circuit(nc, x, F)(proving)
    wires = proving.full_assignment()
    proof, v, committed = tsnark.create_proof(
        tcircom.circom_circuit(r1cs, wire_assignment=wires), pk,
        random.Random(26), device="cpu")
    same = tsnark.create_proof(chip_smoke.chain_circuit(nc, x, F), pk,
                               random.Random(26), device="cpu")
    assert (proof, v, committed) == same and committed == [x]
    pvk = tsnark.PreparedVerifyingKey.from_vk(pk.vk)
    assert tsnark.verify_proof(pvk, proof, [wires[1]])
