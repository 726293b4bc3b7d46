"""The port stands alone: no module of crypto_tpu_torch (nor chip_smoke.py)
imports JAX or the JAX package, and its entry points refuse to run on the
CPU unless asked to.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import crypto_tpu_torch
names = [m.name for m in pkgutil.walk_packages(crypto_tpu_torch.__path__,
                                               "crypto_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "crypto_tpu."))
             or m == "crypto_tpu")
print("MODULES", len(names), " ".join(names))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1].split()[0])
    assert n >= 78
    for name in ("curves.bn254", "serialize", "hashing",
                 "schnorr.discrete_log", "schnorr.generalized",
                 "bbs_plus.setup", "bbs_plus.signature", "bbs_plus.proof",
                 "bbs_plus.batch", "bbs_plus.bbs23", "transcript.keccak",
                 "transcript.strobe", "transcript.merlin",
                 "transcript.transcript", "utils.elgamal", "saver.core",
                 "saver.lego", "legogroth16.aggregation", "legogroth16.link",
                 "legogroth16.bound_check", "short_group_sig.weak_bb",
                 "short_group_sig.bb_sig", "accumulator.proofs_cdh",
                 "accumulator.proofs_original", "accumulator.kb_positive",
                 "proof_system.base", "proof_system.derived_params",
                 "proof_system.statements", "proof_system.statements_snark",
                 "proof_system.statements_accum_original",
                 "proof_system.proof", "secret_sharing.common",
                 "secret_sharing.schemes", "utils.ecies",
                 "accumulator.kb_universal",
                 "accumulator.kb_universal_witness", "accumulator.keyed",
                 "coconut.core", "coconut.messages_pok", "kvac.bbdt16",
                 "kvac.keyed_proof", "proof_system.statements_more",
                 "proof_system.statements_kv", "hashing_rfc9380",
                 "bbs_plus.ietf", "verifiable_encryption.tz21",
                 "verifiable_encryption.rdkgith",
                 "proof_system.statements_split", "curves.extra_curves",
                 "utils.schnorr_signature", "kvac.bbs_sharp.setup",
                 "kvac.bbs_sharp.mac", "kvac.bbs_sharp.hol",
                 "kvac.bbs_sharp.proof", "parallel.sharded_msm_v2",
                 "parallel.sharded_ntt", "ot.configs", "ot.prg",
                 "ot.base_ot", "ot.base_ot_more", "ot.ot_extension",
                 "ot.kos_ote", "ot.gilboa", "ot.dkls", "ot.cointoss",
                 "ot.zero_sharing", "short_group_sig.threshold_weak_bb",
                 "accumulator.threshold"):
        assert f"crypto_tpu_torch.{name}" in out.stdout


def _msm():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.ops.msm_v2 import msm_device_scheduled
    G = tb.G1.generator()
    msm_device_scheduled(tb.G1, [G, G.double()], [1, 2])


def _tcurve_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tcurve import tcurve_for
    tcurve_for(tb.G1)


def _tcurve():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tcurve import TCurve
    TCurve(tb.G1)


def _tfield_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.tfield import tfield_for
    tfield_for(tb.Fr)


def _tfield():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.tfield import TField
    TField(tb.Fq)


def _jax_to_port():
    import numpy as np
    from crypto_tpu_torch import convert
    convert.jax_to_port(np.zeros((2, 17), np.int32), 97)


def _jax_to_port_fq2():
    import numpy as np
    from crypto_tpu_torch import convert
    convert.jax_to_port_fq2(np.zeros((2, 2, 26), np.int32), 97)


def _tquad_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.ttower import tquad_for
    tquad_for(tb.Fq2)


def _tquad_field():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.ttower import TQuadField
    TQuadField(tb.Fq2)


def _tcurve_for_g2():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tcurve import tcurve_for
    tcurve_for(tb.G2)


def _msm_g2():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.ops.msm_v2 import msm_device_scheduled
    G = tb.G2.generator()
    msm_device_scheduled(tb.G2, [G, G.double()], [1, 2])


def _mont_pow():
    """The Fermat root on a tensor the wrapper routes to the card, as it
    routes a CUDA tensor: it builds and launches the kernel or raises, and
    never falls back to the plain version."""
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.tfield import tfield_for
    from crypto_tpu_torch.ops.kernels import field_kernels as fk
    T = tfield_for(tb.Fq, "cpu")
    a = T.pack([3, 0])
    on_card = fk.on_card
    fk.on_card = lambda name, device: True
    try:
        fk.mont_pow(a, tb.Fq.p - 2, T.mod)
    finally:
        fk.on_card = on_card


def _domain_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.ops.ntt import domain_for
    domain_for(tb.Fr, 16)


def _poly_mul_ntt():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.ops.ntt import poly_mul_ntt
    poly_mul_ntt(tb.Fr, [1, 2], [3])


def _table_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.ops.fixed_base import table_for
    table_for(tb.G1, tb.G1.generator())


def _multiply_same_group_elem():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.utils.msm import \
        multiply_field_elems_with_same_group_elem
    multiply_field_elems_with_same_group_elem(tb.G1.generator(), [1, 2])


def _lego_pk():
    """A two-variable LegoGroth16 proving key on the host, built without
    the device path (x * x = z)."""
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.legogroth16 import snark
    G1, G2 = tb.G1.generator(), tb.G2.generator()
    return snark.ProvingKey(
        vk=snark.VerifyingKey(G1, G2, G2, G2, [G1, G1], G1, 0),
        beta_g1=G1, delta_g1=G1, eta_delta_inv_g1=G1, a_query=[G1] * 3,
        b_g1_query=[G1] * 3, b_g2_query=[G2] * 3, h_query=[G1],
        l_query=[G1])


def _square_circuit(cs):
    from crypto_tpu_torch.curves import bls12_381 as tb
    z = cs.new_input(tb.Fr(9) if cs.mode == "prove" else None)
    x = cs.new_witness(tb.Fr(3) if cs.mode == "prove" else None)
    cs.enforce(x.lc(), x.lc(), z.lc())


def _msm_query():
    from crypto_tpu_torch.legogroth16 import snark
    snark._msm_query(_lego_pk(), "a_query", [1, 2])


def _create_proof():
    import random
    from crypto_tpu_torch.legogroth16 import snark
    snark.create_proof(_square_circuit, _lego_pk(), random.Random(1))


def _generate_random_parameters():
    import random
    from crypto_tpu_torch.legogroth16 import snark
    snark.generate_random_parameters(_square_circuit, 0, random.Random(1))


def _witness_map():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.legogroth16 import snark
    from crypto_tpu_torch.r1cs.cs import ConstraintSystem
    cs = ConstraintSystem(tb.Fr, mode="prove")
    _square_circuit(cs)
    snark.witness_map(cs)


def _tcubic_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.ttower import tcubic_for
    tcubic_for(tb.Fq6)


def _tfield12_for():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.fields.ttower import tfield12_for
    tfield12_for(tb.Fq12)


def _tpairing_for():
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    tpairing_for("bls12_381")


def _tpairing():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tpairing import TPairing
    TPairing(tb)


def _jax_to_port_fq12():
    import numpy as np
    from crypto_tpu_torch import convert
    convert.jax_to_port_fq12(np.zeros((2, 3, 2, 26), np.int32), 97)


def _pairing_checker():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.utils.checkers import RandomizedPairingChecker
    RandomizedPairingChecker(tb.Fr(3), lazy=True)


def _batch_verify_signatures():
    from types import SimpleNamespace
    from crypto_tpu_torch.bbs_plus.batch import batch_verify_signatures
    batch_verify_signatures([], [], None, SimpleNamespace())


def _batch_verify_proofs():
    from types import SimpleNamespace
    from crypto_tpu_torch.bbs_plus.batch import batch_verify_proofs
    batch_verify_proofs([], [], [], None, SimpleNamespace())


def _accum_key():
    from crypto_tpu_torch.accumulator.setup import AccumSecretKey
    from crypto_tpu_torch.curves import bls12_381 as tb
    return AccumSecretKey(tb.Fr(5))


def _accum_enabled():
    from crypto_tpu_torch.accumulator import device_update
    device_update.enabled(1 << 13)


def _accum_update_device():
    from crypto_tpu_torch.accumulator import device_update
    from crypto_tpu_torch.curves import bls12_381 as tb
    G = tb.G1.generator()
    device_update.batch_update_with_sk_device(
        [tb.Fr(3)], [], [tb.Fr(1)], [G], G, _accum_key())


def _accum_update_membership():
    from crypto_tpu_torch.accumulator import witness
    from crypto_tpu_torch.accumulator.core import MembershipWitness
    from crypto_tpu_torch.curves import bls12_381 as tb
    G = tb.G1.generator()
    witness.update_membership_batch_with_sk(
        [tb.Fr(3)], [], [tb.Fr(1)], [MembershipWitness(G)], G, _accum_key())


def _accum_update_non_membership():
    from crypto_tpu_torch.accumulator import witness
    from crypto_tpu_torch.accumulator.core import NonMembershipWitness
    from crypto_tpu_torch.curves import bls12_381 as tb
    G = tb.G1.generator()
    witness.update_non_membership_batch_with_sk(
        [tb.Fr(3)], [], [tb.Fr(1)], [NonMembershipWitness(G, tb.Fr(2))], G,
        _accum_key())


def _accum_witnesses_for_batch():
    from crypto_tpu_torch.accumulator.core import PositiveAccumulator
    from crypto_tpu_torch.accumulator.persistence import InMemoryState
    from crypto_tpu_torch.curves import bls12_381 as tb
    state = InMemoryState()
    state.add(1)
    PositiveAccumulator(tb.G1.generator()).get_membership_witnesses_for_batch(
        [tb.Fr(1)], _accum_key(), state)


def _accum_omega():
    from crypto_tpu_torch.accumulator.batch_utils import Omega
    from crypto_tpu_torch.curves import bls12_381 as tb
    Omega.new([tb.Fr(3)], [tb.Fr(4)], tb.G1.generator(), _accum_key())


def _msm_bn254():
    from crypto_tpu_torch.curves import bn254 as tbn
    from crypto_tpu_torch.ops.msm_v2 import msm_device_scheduled
    G = tbn.G1.generator()
    msm_device_scheduled(tbn.G1, [G, G.double()], [1, 2])


def _msm_bn254_g2():
    from crypto_tpu_torch.curves import bn254 as tbn
    from crypto_tpu_torch.ops.msm_v2 import msm_device_scheduled
    G = tbn.G2.generator()
    msm_device_scheduled(tbn.G2, [G, G.double()], [1, 2])


def _tpairing_for_bn254():
    from crypto_tpu_torch.curves.tpairing import tpairing_for
    tpairing_for("bn254")


def _tpairing_bn():
    from crypto_tpu_torch.curves import bn254 as tbn
    from crypto_tpu_torch.curves.tpairing import TPairingBN
    TPairingBN(tbn)


def _tcubic_for_bn254():
    from crypto_tpu_torch.curves import bn254 as tbn
    from crypto_tpu_torch.fields.ttower import tcubic_for
    tcubic_for(tbn.Fq6)


def _generate_random_parameters_bn254():
    import random
    from crypto_tpu_torch.curves import bn254 as tbn
    from crypto_tpu_torch.legogroth16 import snark
    snark.generate_random_parameters(_square_circuit, 0, random.Random(1),
                                     ctx=tbn)


def _accum_coeffs():
    from crypto_tpu_torch.accumulator import batch_utils
    from crypto_tpu_torch.curves import bls12_381 as tb
    batch_utils.poly_v_D_coeffs([tb.Fr(3)], tb.Fr(5))


def _multi_pairings_routed():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.curves.tpairing import multi_pairings_routed
    multi_pairings_routed([[(tb.G1.generator(), tb.G2.generator())]])


def _saver_generate_srs():
    import random
    from crypto_tpu_torch.saver import core
    core.generate_srs(8, None, random.Random(1))


def _saver_decrypt():
    from types import SimpleNamespace
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.saver import core
    G1, G2 = tb.G1.generator(), tb.G2.generator()
    core.decrypt(core.Ciphertext(G1, [G1], G1), core.SaverSecretKey(tb.Fr(2)),
                 core.DecryptionKey(G2, [G2], [G2]), [G1], 8)


def _saver_lego_generate_srs():
    import random
    from crypto_tpu_torch.saver import lego
    lego.generate_srs(8, None, random.Random(1))


def _aggregate_proofs():
    from crypto_tpu_torch.legogroth16 import aggregation
    from crypto_tpu_torch.transcript.transcript import Transcript
    aggregation.aggregate_proofs(None, Transcript(b"t"), [])


def _verify_aggregate_proof():
    from crypto_tpu_torch.legogroth16 import aggregation
    aggregation.verify_aggregate_proof(None, None, [], None, None, None)


def _bound_check_srs():
    import random
    from crypto_tpu_torch.legogroth16 import bound_check
    bound_check.generate_snark_srs_bound_check(random.Random(1))


def _cp_link_proof():
    import random
    from crypto_tpu_torch.legogroth16 import link
    link.create_proof_incl_cp_link(_square_circuit, _lego_pk(), None,
                                   random.Random(1))


def _proof_new():
    import random
    from crypto_tpu_torch.proof_system.base import ProofSpec
    from crypto_tpu_torch.proof_system.proof import Proof
    Proof.new(random.Random(1), ProofSpec(), [])


def _proof_verify():
    import random
    from crypto_tpu_torch.proof_system.base import ProofSpec
    from crypto_tpu_torch.proof_system.proof import Proof
    Proof([]).verify(random.Random(1), ProofSpec())


def _original_membership_protocol():
    import random
    from crypto_tpu_torch.accumulator import proofs_original as po
    from crypto_tpu_torch.accumulator.core import MembershipWitness
    from crypto_tpu_torch.curves import bls12_381 as tb
    G1, G2 = tb.G1.generator(), tb.G2.generator()
    key = po.MembershipProvingKey(G1, G1, G1)
    po.MembershipProofProtocol.init(
        random.Random(1), tb.Fr(3), None, MembershipWitness(G1), G1,
        SimpleNamespace(Q_tilde=G2), SimpleNamespace(P_tilde=G2), key)


def _kb_accumulator():
    from crypto_tpu_torch.accumulator.kb_universal import \
        KBUniversalAccumulator
    from crypto_tpu_torch.accumulator.persistence import InMemoryState
    from crypto_tpu_torch.accumulator.setup import AccumSetupParams
    from crypto_tpu_torch.curves import bls12_381 as tb
    ms, ns = InMemoryState(), InMemoryState()
    kb = KBUniversalAccumulator.initialize(
        AccumSetupParams(tb.G1.generator(), tb.G2.generator()), _accum_key(),
        [tb.Fr(1), tb.Fr(2)], ms, ns)
    return kb, ms, ns


def _kb_witnesses_for_batch():
    kb, _, ns = _kb_accumulator()
    from crypto_tpu_torch.curves import bls12_381 as tb
    kb.get_non_membership_witnesses_for_batch([tb.Fr(1)], _accum_key(), ns)


def _kb_update_non_members():
    from crypto_tpu_torch.accumulator import kb_universal_witness as kbw
    from crypto_tpu_torch.accumulator.core import MembershipWitness
    from crypto_tpu_torch.curves import bls12_381 as tb
    G = tb.G1.generator()
    kbw.update_non_mem_wits_on_batch_updates(
        [tb.Fr(3)], [], [tb.Fr(1)], [MembershipWitness(G)], G, _accum_key())


def _kb_omega():
    from crypto_tpu_torch.accumulator import kb_universal_witness as kbw
    from crypto_tpu_torch.curves import bls12_381 as tb
    G = tb.G1.generator()
    kbw.KBUniversalOmega.new([tb.Fr(3)], [tb.Fr(4)], G, G, _accum_key())


def _ps_verify():
    from crypto_tpu_torch.coconut import core
    from crypto_tpu_torch.curves import bls12_381 as tb
    G1, G2 = tb.G1.generator(), tb.G2.generator()
    core.PSSignature(G1, G1).verify(
        [tb.Fr(1)], core.PSPublicKey(G2, [G1], [G2]),
        core.PSSignatureParams(G1, G2, [G1]))


def _keyed_proof_public_verify():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.kvac.keyed_proof import (KeyedProof,
                                                   PublicVerificationKey)
    G1, G2 = tb.G1.generator(), tb.G2.generator()
    KeyedProof(G1, G1).verify_with_public_verification_key(
        PublicVerificationKey(G2, G2))


def _dkgith_new():
    import random
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.utils.elgamal import ElgamalPublicKey
    from crypto_tpu_torch.verifiable_encryption.tz21 import DkgithProof
    G = tb.G1.generator()
    DkgithProof.new(random.Random(1), [tb.Fr(1)], G, [G],
                    ElgamalPublicKey(G), G, n_parties=2, reps=1)


def _dkgith_verify():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.utils.elgamal import ElgamalPublicKey
    from crypto_tpu_torch.verifiable_encryption.tz21 import (BatchCt,
                                                             DkgithProof)
    G = tb.G1.generator()
    DkgithProof(bytes(32), bytes(32), [[tb.Fr(0)]], [[bytes(16)]],
                [BatchCt(G, [tb.Fr(0)])], 2, 1).verify(
        G, [G], ElgamalPublicKey(G), G)


def _ietf_signed():
    from crypto_tpu_torch.bbs_plus.ietf import BLS12381_SHA256 as cs
    from crypto_tpu_torch.curves import bls12_381 as tb
    sk = tb.Fr(5)
    pk = cs.sk_to_pk(sk)
    return cs, pk, cs.sign(sk, pk, b"", [b"m0", b"m1"])


def _ietf_verify():
    cs, pk, sig = _ietf_signed()
    cs.verify(pk, sig, b"", [b"m0", b"m1"])


def _ietf_proof_verify():
    import random
    cs, pk, sig = _ietf_signed()
    proof = cs.proof_gen(pk, sig, b"", b"", [b"m0", b"m1"], [0],
                         random.Random(1))
    cs.proof_verify(pk, proof, b"", b"", {0: b"m0"}, 2)


def _shard_bucket_sums():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.parallel.sharded_msm_v2 import shard_bucket_sums
    G = tb.G1.generator()
    shard_bucket_sums(tb.G1, [G, G.double()], [1, 2])


def _msm_sharded_v2():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.parallel.sharded_msm_v2 import msm_sharded_v2
    G = tb.G1.generator()
    msm_sharded_v2(tb.G1, [G, G.double()], [1, 2])


def _msm_shards_in_turn():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.parallel.sharded_msm_v2 import msm_shards_in_turn
    G = tb.G1.generator()
    msm_shards_in_turn(tb.G1, [([G], [1]), ([G.double()], [2])])


def _sharded_ntt_plan():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.parallel.sharded_ntt import plan_for
    plan_for(tb.Fr, 16, 2)


def _sharded_ntt():
    from crypto_tpu_torch.curves import bls12_381 as tb
    from crypto_tpu_torch.parallel.sharded_ntt import sharded_ntt
    sharded_ntt(tb.Fr, [1, 2, 3, 4])


@pytest.mark.parametrize("entry", [_msm, _tcurve_for, _tcurve, _tfield_for,
                                   _tfield, _jax_to_port, _jax_to_port_fq2,
                                   _tquad_for, _tquad_field, _tcurve_for_g2,
                                   _msm_g2, _mont_pow, _domain_for,
                                   _poly_mul_ntt, _table_for,
                                   _multiply_same_group_elem, _msm_query,
                                   _create_proof,
                                   _generate_random_parameters,
                                   _witness_map, _tcubic_for,
                                   _tfield12_for, _tpairing_for, _tpairing,
                                   _jax_to_port_fq12, _pairing_checker,
                                   _batch_verify_signatures,
                                   _batch_verify_proofs,
                                   _accum_enabled, _accum_update_device,
                                   _accum_update_membership,
                                   _accum_update_non_membership,
                                   _accum_witnesses_for_batch, _accum_omega,
                                   _accum_coeffs, _msm_bn254, _msm_bn254_g2,
                                   _tpairing_for_bn254, _tpairing_bn,
                                   _tcubic_for_bn254,
                                   _generate_random_parameters_bn254,
                                   _multi_pairings_routed,
                                   _saver_generate_srs, _saver_decrypt,
                                   _saver_lego_generate_srs,
                                   _aggregate_proofs,
                                   _verify_aggregate_proof,
                                   _bound_check_srs, _cp_link_proof,
                                   _proof_new, _proof_verify,
                                   _original_membership_protocol,
                                   _kb_witnesses_for_batch,
                                   _kb_update_non_members, _kb_omega,
                                   _ps_verify, _keyed_proof_public_verify,
                                   _dkgith_new, _dkgith_verify,
                                   _ietf_verify, _ietf_proof_verify,
                                   _shard_bucket_sums, _msm_sharded_v2,
                                   _msm_shards_in_turn, _sharded_ntt_plan,
                                   _sharded_ntt],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_entry_point_raises_without_cuda(entry):
    """Every entry point defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
