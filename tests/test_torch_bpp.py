"""The port's Bulletproofs++ (`crypto_tpu_torch/bulletproofs_pp/`: the
weighted norm linear argument, the perfect-range proof and the
arbitrary-range proof) against the reference's
(`crypto_tpu/bulletproofs_pp/`), at the sizes of the reference's
`tests/test_wnla.py`.

The generators, commitments and proofs of both packages, made from the
same `random.Random` seed on the same transcripts, are equal integer for
integer; each package verifies the other's proof; another transcript,
another c vector, reordered commitments, a spoiled norm-argument
response and an out-of-range value are refused by both.
"""

import dataclasses
import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

from test_torch_commitment_inequality import to_ref

cap_threads()


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("wnla", "bulletproofs_pp.wnla"), ("rp", "bulletproofs_pp.range_proof"),
        ("ar", "bulletproofs_pp.arbitrary_range"),
        ("tr", "transcript.transcript"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")
PKGS = {"ref": REF, "port": PORT}


def _wnla(P, nl, nn, seed):
    rng = random.Random(seed)
    F = P.b.Fr
    params = P.wnla.BppSetupParams.new(b"wnla-test", nn, nl)
    l = [F.rand(rng) for _ in range(nl)]
    n = [F.rand(rng) for _ in range(nn)]
    c = [F.rand(rng) for _ in range(nl)]
    rho = F.rand_nonzero(rng)
    v = P.wnla.inner_product(c, l) + P.wnla.weighted_norm(n, rho * rho)
    C = P.wnla.commit(params, v, l, n)
    arg = P.wnla.WeightedNormLinearArgument.new(l, n, c, rho, params,
                                                P.tr.Transcript(b"wnla"))
    return dict(params=params, c=c, rho=rho, C=C, arg=arg)


@pytest.mark.parametrize("nl,nn", [(4, 8), (1, 16), (4, 4)])
def test_wnla_parity(nl, nn):
    ref, port = _wnla(REF, nl, nn, 1111), _wnla(PORT, nl, nn, 1111)
    assert canonical(ref["params"]) == canonical(port["params"])
    assert canonical(ref["C"]) == canonical(port["C"])
    assert canonical(ref["arg"]) == canonical(port["arg"])
    assert len(port["arg"].l) == 1 and len(port["arg"].n) == 1
    # each verifies the other's argument
    assert protocol_to_port(ref["arg"]).verify(
        port["c"], port["rho"], port["C"], port["params"],
        PORT.tr.Transcript(b"wnla"))
    assert to_ref(port["arg"]).verify(
        ref["c"], ref["rho"], ref["C"], ref["params"],
        REF.tr.Transcript(b"wnla"))


@pytest.mark.parametrize("spoil", ["transcript", "c", "response"])
def test_wnla_refused(spoil):
    for P in (REF, PORT):
        w = _wnla(P, 4, 8, 1112)
        F = P.b.Fr
        arg, c, label = w["arg"], w["c"], b"wnla"
        if spoil == "transcript":
            label = b"ctx-B"
        elif spoil == "c":
            c = [x + F(1) for x in c]
        else:
            arg = dataclasses.replace(arg, n=[arg.n[0] + F(1)])
        assert not arg.verify(c, w["rho"], w["C"], w["params"],
                              P.tr.Transcript(label))


RANGE_CASES = [(2, 4, [7]), (16, 8, [243]), (2, 16, [12431]),
               (16, 16, [65535, 0]), (4, 8, [0, 255])]


def _range(P, base, num_bits, vals, seed):
    rng = random.Random(seed)
    F = P.b.Fr
    params = P.rp.SetupParams.new_for_perfect_range_proof(
        b"bpp-test", base, num_bits, len(vals))
    gamma = [F.rand(rng) for _ in vals]
    V = [params.compute_pedersen_commitment(v, g)
         for v, g in zip(vals, gamma)]
    prover = P.rp.Prover(base, num_bits, V, list(vals), gamma)
    proof = prover.prove(rng, params, P.tr.Transcript(b"bpp"))
    return dict(params=params, V=V, proof=proof)


@pytest.mark.parametrize("base,num_bits,vals", RANGE_CASES)
def test_range_proof_parity(base, num_bits, vals):
    ref, port = _range(REF, base, num_bits, vals, 99), \
        _range(PORT, base, num_bits, vals, 99)
    assert canonical(ref["params"]) == canonical(port["params"])
    assert canonical(ref["V"]) == canonical(port["V"])
    assert canonical(ref["proof"]) == canonical(port["proof"])
    assert port["proof"].verify(num_bits, port["V"], port["params"],
                                PORT.tr.Transcript(b"bpp"))
    assert protocol_to_port(ref["proof"]).verify(
        num_bits, port["V"], port["params"], PORT.tr.Transcript(b"bpp"))
    assert to_ref(port["proof"]).verify(num_bits, ref["V"], ref["params"],
                                        REF.tr.Transcript(b"bpp"))
    for P, w in ((REF, ref), (PORT, port)):
        assert not w["proof"].verify(num_bits, w["V"], w["params"],
                                     P.tr.Transcript(b"other"))
        if len(vals) > 1:
            assert not w["proof"].verify(num_bits, list(reversed(w["V"])),
                                         w["params"],
                                         P.tr.Transcript(b"bpp"))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_range_proof_out_of_range(pkg):
    P = PKGS[pkg]
    rng = random.Random(100)
    F = P.b.Fr
    params = P.rp.SetupParams.new_for_perfect_range_proof(b"bpp-oob", 16, 4,
                                                          1)
    gamma = [F.rand(rng)]
    V = [params.compute_pedersen_commitment(243, gamma[0])]
    with pytest.raises(P.wnla.BppError):
        P.rp.Prover(16, 4, V, [243], gamma).prove(rng, params,
                                                 P.tr.Transcript(b"bpp"))
    with pytest.raises(P.wnla.BppError):
        P.rp.Prover(3, 4, V, [1], gamma)


def _arbitrary(P, seed, bounds):
    rng = random.Random(seed)
    F = P.b.Fr
    params = P.rp.SetupParams.new_for_perfect_range_proof(
        b"bpp-arb", 4, 16, 2 * len(bounds))
    rand = [F.rand(rng) for _ in range(2 * len(bounds))]
    proof = P.ar.ProofArbitraryRange.new(rng, 16, bounds, rand, params,
                                         P.tr.Transcript(b"arb"), base=4)
    return dict(params=params, proof=proof)


def test_arbitrary_range_parity():
    bounds = [(35000, 100, 65536), (7, 7, 8)]
    ref, port = _arbitrary(REF, 101, bounds), _arbitrary(PORT, 101, bounds)
    assert canonical(ref["proof"]) == canonical(port["proof"])
    assert port["proof"].verify(16, port["params"], PORT.tr.Transcript(b"arb"))
    assert to_ref(port["proof"]).verify(16, ref["params"],
                                        REF.tr.Transcript(b"arb"))
    lo_hi = [(lo, hi) for _, lo, hi in bounds]
    assert canonical(port["proof"].get_commitments_to_values(
        lo_hi, port["params"])) == canonical(
        ref["proof"].get_commitments_to_values(lo_hi, ref["params"]))
    for P in (REF, PORT):
        with pytest.raises(P.wnla.BppError):
            _arbitrary(P, 102, [(99, 100, 65536)])
