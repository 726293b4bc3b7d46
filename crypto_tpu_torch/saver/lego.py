"""SAVER with LegoGroth16 (reference `saver/src/saver_legogroth16.rs:1-332`):
the port's copy of `crypto_tpu/saver/lego.py`.

Unlike the Groth16 wrapper (`saver/core.py`, `saver_groth16.rs`) where the
chunks are public inputs, here the message chunks are the circuit's
COMMITTED WITNESSES (``commit_witness_count = n``), the CRS is built over
the SAVER `EncryptionGens` bases G/H, and the chunk commitment bases
``g_i = vk.gamma_abc_g1[1:]`` double as the encryption-key bases.

Two protocol variants (both in the reference file):

* **protocol 1** (`saver_legogroth16.rs:70-133`): encryption unchanged, the
  proof carries one extra element ``v * (eta/gamma) G1`` so the verifier can
  fold the commitment randomness into the d-accumulator (commitment hiding
  becomes computational).
* **protocol 2** (`saver_legogroth16.rs:135-180`): the ciphertext instead
  also exposes ``X_r_sum = r * sum_i X_i`` (``encrypt_alt`` shape) and the
  LegoGroth16 proof's own D supplies the witness-commitment part.

The CRS and the proofs come from the port's `legogroth16/snark.py` on
`device` (CUDA unless the caller names the CPU; raises without a card);
the verifiers are its host `verify_qap_proof`, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..r1cs.cs import ConstraintSystem, LinearCombination, ONE
from ..legogroth16 import snark
from .core import (EncryptionGens, EncryptionKey, SaverError, Ciphertext,
                   chunks_count, decompose, keygen as _keygen,
                   encrypt as _encrypt)

F = bls.Fr


def bitsize_check_circuit_committed(chunk_bit_size: int, num_chunks: int,
                                    chunk_values=None):
    """Bitsize circuit with the chunks as the FIRST witnesses (committed by
    the LegoGroth16 D), matching `BitsizeCheckCircuit` with
    `values_as_input = false` (`saver/src/circuit.rs:12-85`)."""
    def circuit(cs: ConstraintSystem):
        vals = chunk_values
        chunk_vars = []
        for i in range(num_chunks):
            chunk_vars.append(
                cs.new_witness(None if vals is None else F(vals[i])))
        for i, chunk_var in enumerate(chunk_vars):
            bits = []
            for j in range(chunk_bit_size - 1, -1, -1):
                bv = None
                if vals is not None:
                    bv = F((int(vals[i]) >> j) & 1)
                b_var = cs.new_witness(bv)
                one_minus = LinearCombination.from_var(ONE) - b_var.lc()
                cs.enforce(b_var.lc(), one_minus, LinearCombination.zero())
                bits.append((b_var, 1 << j))
            lhs = LinearCombination([(F(w), v) for v, w in bits])
            cs.enforce(lhs, LinearCombination.from_var(ONE), chunk_var.lc())
    return circuit


@dataclass
class LegoSaverProvingKey:
    """`saver_legogroth16.rs:19-25` ProvingKey."""
    pk: snark.ProvingKey
    gamma_g1: Point     # -gamma * G (over EncryptionGens.G)


def generate_srs(chunk_bit_size: int, gens: EncryptionGens,
                 rng, device="cuda") -> LegoSaverProvingKey:
    """LegoGroth16 CRS over the `EncryptionGens` bases with the n chunks
    committed (`saver_legogroth16.rs:32-64` generate_srs)."""
    device = resolve_device(device)
    n = chunks_count(chunk_bit_size)
    alpha, beta, gamma, delta, eta = (F.rand(rng) for _ in range(5))
    pk = snark.generate_parameters_with_trapdoors(
        bitsize_check_circuit_committed(chunk_bit_size, n), n, rng,
        alpha, beta, gamma, delta, eta, g1=gens.G, g2=gens.H, device=device)
    gamma_g1 = (gens.G * int(-gamma)).normalize()
    return LegoSaverProvingKey(pk=pk, gamma_g1=gamma_g1)


def get_gs_for_encryption(vk: snark.VerifyingKey) -> list:
    """`saver_legogroth16.rs:27-30`: the chunk commitment bases."""
    return vk.gamma_abc_g1[1:]


def keygen(rng, chunk_bit_size: int, gens: EncryptionGens,
           srs: LegoSaverProvingKey):
    """SAVER keygen bound to the Lego CRS: g_i from gamma_abc, X_i over
    delta_g1, P_2 over -gamma*G (`saver_legogroth16.rs` test:221-229)."""
    g_i = get_gs_for_encryption(srs.pk.vk)
    return _keygen(rng, chunk_bit_size, gens, g_i,
                   srs.pk.delta_g1, srs.gamma_g1)


@dataclass
class CiphertextAlt:
    """`encryption.rs` CiphertextAlt: Ciphertext plus r * sum_i X_i."""
    X_r: Point
    enc_chunks: list
    commitment: Point
    X_r_sum: Point


def encrypt_alt(rng, message: Fp, ek: EncryptionKey, g_i: list,
                chunk_bit_size: int):
    """Encrypt and also output ``X_r_sum = r * sum X_i``
    (protocol 2's ciphertext shape)."""
    ct, r = _encrypt(rng, message, ek, g_i, chunk_bit_size)
    acc = bls.G1.infinity()
    for X in ek.X:
        acc = acc + X
    x_r_sum = (acc * int(r)).normalize()
    return CiphertextAlt(X_r=ct.X_r, enc_chunks=ct.enc_chunks,
                         commitment=ct.commitment, X_r_sum=x_r_sum), r


@dataclass
class Protocol1Proof:
    """`saver_legogroth16.rs:75-79` protocol_1::Proof."""
    proof: snark.Proof
    v_eta_gamma_inv: Point


def protocol1_create_proof(message: Fp, v: Fp, r: Fp,
                           srs: LegoSaverProvingKey, ek: EncryptionKey,
                           chunk_bit_size: int, rng,
                           device="cuda") -> Protocol1Proof:
    """`saver_legogroth16.rs:83-108`: Lego proof with C += r*P_2 plus the
    explicit v*(eta/gamma)G1 element."""
    chunks = decompose(message, chunk_bit_size)
    circuit = bitsize_check_circuit_committed(
        chunk_bit_size, len(chunks), chunks)
    proof, v_used, _ = snark.create_proof(circuit, srs.pk, rng, v=v,
                                          device=device)
    proof = snark.Proof(a=proof.a, b=proof.b,
                        c=(proof.c + ek.P_2 * int(r)).normalize(),
                        d=proof.d)
    return Protocol1Proof(
        proof=proof,
        v_eta_gamma_inv=(srs.pk.vk.eta_gamma_inv_g1 * int(v_used)).normalize())


def protocol1_verify_proof(pvk: snark.PreparedVerifyingKey,
                           proof: Protocol1Proof, ct: Ciphertext) -> bool:
    """`saver_legogroth16.rs:110-133`: d = X_r + sum c_i + gamma_abc[0]
    + v*(eta/gamma)G1, then the bare QAP check."""
    d = ct.X_r
    for c in ct.enc_chunks:
        d = d + c
    d = d + pvk.vk.gamma_abc_g1[0] + proof.v_eta_gamma_inv
    return snark.verify_qap_proof(pvk, proof.proof.a, proof.proof.b,
                                  proof.proof.c, d)


def protocol2_create_proof(message: Fp, v: Fp, r: Fp,
                           srs: LegoSaverProvingKey, ek: EncryptionKey,
                           chunk_bit_size: int, rng,
                           device="cuda") -> snark.Proof:
    """`saver_legogroth16.rs:141-165`: Lego proof with C += r*P_2 (the
    witness commitment D stays in the proof)."""
    chunks = decompose(message, chunk_bit_size)
    circuit = bitsize_check_circuit_committed(
        chunk_bit_size, len(chunks), chunks)
    proof, _v, _ = snark.create_proof(circuit, srs.pk, rng, v=v,
                                      device=device)
    return snark.Proof(a=proof.a, b=proof.b,
                       c=(proof.c + ek.P_2 * int(r)).normalize(),
                       d=proof.d)


def protocol2_verify_proof(pvk: snark.PreparedVerifyingKey,
                           proof: snark.Proof, ct: CiphertextAlt) -> bool:
    """`saver_legogroth16.rs:167-179`: d = D + X_r_sum + gamma_abc[0]
    + X_r."""
    d = proof.d + ct.X_r_sum + pvk.vk.gamma_abc_g1[0] + ct.X_r
    return snark.verify_qap_proof(pvk, proof.a, proof.b, proof.c, d)
