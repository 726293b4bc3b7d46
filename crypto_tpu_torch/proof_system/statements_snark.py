"""SNARK-backed proof-system statements, bound check (LegoGroth16) and
verifiable encryption (SAVER), with Schnorr linkage of the hidden value:
the port's own copy of `crypto_tpu/proof_system/statements_snark.py`
(reference `proof_system/src/sub_protocols/{bound_check_legogroth16,
saver}.rs`).

Linkage designs:
* BoundCheck: the LegoGroth16 proof's D commits the witness:
  D = gamma_abc[k]*w + (eta/gamma)*v.  A PokPedersenCommitment over D with
  externally-forced blinding on w makes the w-response shareable.
* Saver: prover publishes the ciphertext (+Groth16 proof) and a Pedersen
  commitment J = G*m + H*r_ped.  Schnorr A proves opening of psi
  (chunks..., r); Schnorr B proves opening of J (m, r_ped).  The chunk
  blindings are radix-linked to the m blinding
  (beta_m = sum b^{n-1-i} beta_i), so soundness of m = compose(chunks)
  follows from response consistency: resp_m == sum b^{n-1-i} resp_chunk_i,
  which the verifier checks.  External equality blindings on m are honored
  by back-solving beta_0.

On `Statement.device`: the SNARK provers (`legogroth16/snark.py`
`create_proof`, its MSMs on the device from its threshold on), and
SAVER's pairing checks through `curves.tpairing.multi_pairings_routed`.
The bound check's verification equation defers into the verifier's
shared `RandomizedPairingChecker` when there is one (three pairs and a
target), else pairs on the host; SAVER's two checks pair by the router,
as the reference's pair on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..legogroth16 import snark
from ..legogroth16.bound_check import bound_check_circuit
from ..saver import core as saver_core
from ..schnorr.discrete_log import (PokPedersenCommitment,
                                    PokPedersenCommitmentProtocol)
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..serialize import ByteWriter
from .base import ProofSystemError, Statement

F = bls.Fr


# ---------------------------------------------------------------------------
# Bound check (LegoGroth16)
# ---------------------------------------------------------------------------

@dataclass
class BoundCheckLegoGroth16(Statement):
    min_val: int
    max_val: int
    snark_pk: snark.ProvingKey  # verifier only needs .vk

    def init_subprotocol(self, rng, blindings, witness):
        """witness: the int/Fp value w."""
        w_val = int(witness)
        proof, v, committed = snark.create_proof(
            bound_check_circuit(self.min_val, self.max_val, w_val),
            self.snark_pk, rng, device=self.device)
        return self._make_sp(rng, blindings, committed[0], proof, v)

    def init_subprotocol_with_old(self, rng, blindings, witness, old):
        """Reuse path (`sub_protocols/bound_check_legogroth16.rs:108-137`):
        rerandomize the old proof with fresh commitment randomness instead
        of re-running the SNARK prover."""
        v = F.rand(rng)
        proof = snark.rerandomize_proof_1(
            old.proof, old.v, v, self.snark_pk.vk,
            self.snark_pk.eta_delta_inv_g1, rng)
        return self._make_sp(rng, blindings, F(int(witness)), proof, v)

    def _make_sp(self, rng, blindings, w_elem, proof, v):
        vk = self.snark_pk.vk
        comm_key = vk.get_commitment_key_for_witnesses()  # [base_w, eta/gamma]
        sc = PokPedersenCommitmentProtocol.init(
            w_elem, blindings.get(0, F.rand(rng)), comm_key[0],
            v, F.rand(rng), comm_key[1])
        stmt = self

        class SP:
            commitment_randomness = v

            def challenge_contribution(self, writer):
                stmt._contribution(proof.d, sc.t, writer)

            def gen_proof(self, challenge):
                return BoundCheckProof(snark_proof=proof,
                                       sc=sc.gen_proof(challenge))

        return SP()

    def _contribution(self, d, t, writer: ByteWriter):
        writer.points(self.snark_pk.vk.get_commitment_key_for_witnesses())
        writer.points((d, t))
        writer.fields((F(self.min_val), F(self.max_val)))

    @staticmethod
    def _d_of(proof):
        return proof.commitment if isinstance(proof, BoundCheckProofAggr) \
            else proof.snark_proof.d

    def proof_challenge_contribution(self, proof, writer):
        self._contribution(self._d_of(proof), proof.sc.t, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if isinstance(proof, BoundCheckProofAggr):
            raise ProofSystemError(
                "aggregated bound-check proof in non-aggregating spec")
        vk = self.snark_pk.vk
        pvk = self.derived("lego_pvk", vk, snark.PreparedVerifyingKey.from_vk)
        if pairing_checker is not None:
            snark.verify_proof_with_checker(
                pvk, proof.snark_proof, [F(self.min_val), F(self.max_val)],
                pairing_checker)
        elif not snark.verify_proof(pvk, proof.snark_proof,
                                    [F(self.min_val), F(self.max_val)]):
            raise ProofSystemError("bound check SNARK failed")
        self._verify_schnorr(proof, challenge)

    def _verify_schnorr(self, proof, challenge):
        ck = self.snark_pk.vk.get_commitment_key_for_witnesses()
        if not proof.sc.verify(self._d_of(proof), ck[0], ck[1], challenge):
            raise ProofSystemError("bound check commitment PoK failed")

    # -- SnarkPack aggregation hooks (`statement_proof.rs`
    #    BoundCheckLegoGroth16WithAggregation) --

    def strip_snark_proof(self, proof):
        return proof.snark_proof, BoundCheckProofAggr(
            commitment=proof.snark_proof.d, sc=proof.sc)

    def verify_proof_when_aggregating(self, proof, challenge,
                                      pairing_checker=None):
        self._verify_schnorr(proof, challenge)

    def aggregate_public_inputs(self, proof):
        return [F(self.min_val), F(self.max_val)]

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.sc.response1


@dataclass
class BoundCheckProof:
    snark_proof: snark.Proof
    sc: PokPedersenCommitment


@dataclass
class BoundCheckProofAggr:
    """Statement proof when the SNARK is folded into a SnarkPack aggregate:
    keeps only D (the witness commitment) and the Schnorr."""
    commitment: Point
    sc: PokPedersenCommitment


# ---------------------------------------------------------------------------
# SAVER verifiable encryption
# ---------------------------------------------------------------------------

@dataclass
class SaverStatement(Statement):
    chunk_bit_size: int
    enc_gens: saver_core.EncryptionGens
    ek: saver_core.EncryptionKey
    snark_pk: saver_core.SaverProvingKey
    comm_G: Point  # base for the linkage commitment J
    comm_H: Point

    def _radix_weights(self, n):
        b_radix = 1 << self.chunk_bit_size
        return [F(pow(b_radix, n - 1 - i, F.p)) for i in range(n)]

    def init_subprotocol(self, rng, blindings, witness):
        """witness: the message m (Fp)."""
        m = witness
        ct, r, g16_proof = saver_core.encrypt_with_proof(
            rng, m, self.ek, self.snark_pk, self.chunk_bit_size,
            device=self.device)
        return self._make_sp(rng, blindings, m, ct, r, g16_proof)

    def init_subprotocol_with_old(self, rng, blindings, witness, old):
        """Reuse path (`sub_protocols/saver.rs:149-187`): rerandomize the
        old ciphertext and Groth16 proof; the new total encryption
        randomness is old.v + r'."""
        ct, r_prime, proof = saver_core.rerandomize_ciphertext_and_proof(
            old.ciphertext, old.proof, self.snark_pk.pk.vk, self.ek, rng)
        return self._make_sp(rng, blindings, witness, ct, old.v + r_prime,
                             proof)

    def _make_sp(self, rng, blindings, m, ct, r, g16_proof):
        chunks = saver_core.decompose(m, self.chunk_bit_size)
        n = len(chunks)
        weights = self._radix_weights(n)

        r_ped = F.rand(rng)
        J = (self.comm_G * int(m) + self.comm_H * int(r_ped)).normalize()

        # chunk blindings, radix-linked to the (possibly external) m blinding
        beta_m = blindings.get(0, F.rand(rng))
        betas = [F.rand(rng) for _ in range(n)]
        # back-solve beta_0 so sum weights[i]*betas[i] == beta_m
        acc = F(0)
        for i in range(1, n):
            acc = acc + weights[i] * betas[i]
        betas[0] = (beta_m - acc) * weights[0].inverse()

        ck = self.ek.commitment_key()
        sc_psi = SchnorrCommitment.new(ck, betas + [F.rand(rng)])
        wits_psi = [F(c) for c in chunks] + [r]
        sc_J = PokPedersenCommitmentProtocol.init(
            m, beta_m, self.comm_G, r_ped, F.rand(rng), self.comm_H)
        stmt = self

        class SP:
            commitment_randomness = r

            def challenge_contribution(self, writer):
                stmt._contribution(ct, J, sc_psi.t, sc_J.t, writer)

            def gen_proof(self, challenge):
                return SaverProof(
                    ciphertext=ct, snark_proof=g16_proof, J=J,
                    t_psi=sc_psi.t,
                    resp_psi=sc_psi.response(wits_psi, challenge),
                    sc_J=sc_J.gen_proof(challenge))

        return SP()

    def _contribution(self, ct, J, t_psi, t_J, writer: ByteWriter):
        writer.point(ct.X_r)
        writer.points(ct.enc_chunks)
        writer.points((ct.commitment, J, t_psi, t_J, self.comm_G,
                       self.comm_H))

    def proof_challenge_contribution(self, proof, writer):
        self._contribution(proof.ciphertext, proof.J, proof.t_psi,
                           proof.sc_J.t, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if isinstance(proof, SaverProofAggr):
            raise ProofSystemError(
                "aggregated SAVER proof in non-aggregating spec")
        ct = proof.ciphertext
        self._verify_commitment(ct)
        pvk = self.derived("saver_pvk", self.snark_pk.pk.vk,
                           snark.PreparedVerifyingKey.from_vk)
        if not saver_core.verify_ciphertext_proof(ct, proof.snark_proof, pvk,
                                                  self.device):
            raise ProofSystemError("SAVER SNARK failed")
        self._verify_schnorr(proof, challenge)

    def _verify_commitment(self, ct):
        if not saver_core.verify_ciphertext_commitment(
                ct, self.ek, self.enc_gens, self.device):
            raise ProofSystemError("SAVER ciphertext commitment failed")

    def verify_proof_when_aggregating(self, proof, challenge,
                                      pairing_checker=None):
        """`verify_proof_contribution_..._when_aggregating_snark`: the
        Groth16 check moves into the aggregate; ciphertext commitment and
        Schnorr legs still verify per statement."""
        self._verify_commitment(proof.ciphertext)
        self._verify_schnorr(proof, challenge)

    def strip_snark_proof(self, proof):
        return proof.snark_proof, SaverProofAggr(
            ciphertext=proof.ciphertext, J=proof.J, t_psi=proof.t_psi,
            resp_psi=proof.resp_psi, sc_J=proof.sc_J)

    def prepared_aggregate_input(self, proof):
        """The Groth16 'prepared input' point for this SAVER proof:
        d = c_0 + sum(c_i) + gamma_abc[0] (`saver_groth16.rs`
        verify_aggregate_proof)."""
        vk = self.snark_pk.pk.vk
        d = proof.ciphertext.X_r
        for c in proof.ciphertext.enc_chunks:
            d = d + c
        return (d + vk.gamma_abc_g1[0]).normalize()

    def _verify_schnorr(self, proof, challenge):
        ct = proof.ciphertext
        ck = self.ek.commitment_key()
        if not proof.resp_psi.is_valid(ck, ct.commitment, proof.t_psi,
                                       challenge):
            raise ProofSystemError("SAVER psi opening failed")
        if not proof.sc_J.verify(proof.J, self.comm_G, self.comm_H, challenge):
            raise ProofSystemError("SAVER J opening failed")
        # radix consistency: resp_m == sum weights_i * resp_chunk_i
        n = len(ct.enc_chunks)
        weights = self._radix_weights(n)
        acc = F(0)
        for i in range(n):
            acc = acc + weights[i] * proof.resp_psi.get_response(i)
        if acc != proof.sc_J.response1:
            raise ProofSystemError("SAVER chunk-message consistency failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.sc_J.response1


@dataclass
class SaverProof:
    ciphertext: saver_core.Ciphertext
    snark_proof: snark.Proof
    J: Point
    t_psi: Point
    resp_psi: SchnorrResponse
    sc_J: PokPedersenCommitment


@dataclass
class SaverProofAggr:
    """SAVER statement proof when the Groth16 proof lives in a SnarkPack
    aggregate (`statement_proof.rs` SaverProofWhenAggregatingSnarks)."""
    ciphertext: saver_core.Ciphertext
    J: Point
    t_psi: Point
    resp_psi: SchnorrResponse
    sc_J: PokPedersenCommitment
