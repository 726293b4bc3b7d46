"""Proof-system statements backed by the range subsystems: the port's own
copy of `crypto_tpu/proof_system/statements_ranges.py` (reference
`proof_system/src/sub_protocols/{bound_check_bpp,bound_check_smc,
bound_check_smc_with_kv,r1cs_legogorth16,inequality}.rs`): the
Bulletproofs++ bound check, the CCS set-membership bound check (public
and keyed verification), Circom R1CS circuits under LegoGroth16, and
public-value inequality.

Transcript note: the BP++ range proof runs on a fresh transcript seeded
with the composite challenge (which already binds all round-1
commitments including the BP++ value commitments), keeping the Statement
API challenge-driven.

On `Statement.device`: the Circom statement's prover
(`legogroth16/snark.py` `create_proof`: the witness map on the device,
the query MSMs there from its threshold on) and the set-membership
digits' pairings (`smc_range_proof/ccs.py`: the prover's in one routed
call; the verifier's deferred into the shared `RandomizedPairingChecker`
when there is one, else in one routed call).  The SNARK's verification
equation defers into the checker too, else pairs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bulletproofs_pp.arbitrary_range import ProofArbitraryRange
from ..bulletproofs_pp.range_proof import Prover
from ..bulletproofs_pp.range_proof import SetupParams as BppSetupParams
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..legogroth16 import snark
from ..legogroth16.circom import CircomR1CS, circom_circuit
from ..schnorr.discrete_log import PokPedersenCommitmentProtocol
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..schnorr.inequality import (DiscreteLogInequalityProtocol,
                                  InequalityProof)
from ..serialize import ByteWriter
from ..smc_range_proof.ccs import (MemberCommitmentKey,
                                   SetMembershipCheckParams)
from ..smc_range_proof.kv import (CCSArbitraryRangeKVProtocol,
                                  SetMembershipCheckParamsKV)
from ..smc_range_proof.ranges_extra import (CCSArbitraryRangeProof,
                                            CCSArbitraryRangeProtocol)
from ..transcript.transcript import Transcript
from ..utils.commitment import PedersenCommitmentKey
from .base import Statement, ProofSystemError

F = bls.Fr


def _bpp_transcript(challenge: Fp) -> Transcript:
    t = Transcript(b"composite-bpp-range")
    t.append_message(b"challenge", challenge.to_bytes_le())
    return t


# ---------------------------------------------------------------------------
# Bulletproofs++ bound check
# ---------------------------------------------------------------------------

@dataclass
class BoundCheckBpp(Statement):
    """v in [min, max) with v linkable to other statements.  The BP++
    commitments V_lo/V_hi recombine into two Pedersen commitments to v over
    (G, H); two Schnorr proofs with a SHARED blinding on v expose one
    shared response (`bound_check_bpp.rs:48-230`).  The range proof's
    digits are bits (base 2); `bpp_params` must hold 128 G_vec generators
    (`SetupParams.new_for_perfect_range_proof(label, 2, 64, 2)`)."""
    min_val: int
    max_val: int
    bpp_params: BppSetupParams

    @property
    def num_bits(self) -> int:
        return 64

    def init_subprotocol(self, rng, blindings, witness):
        v = int(witness)
        rand = [F.rand(rng), F.rand(rng)]
        V, values = ProofArbitraryRange.compute_commitments_and_values(
            [(v, self.min_val, self.max_val)], rand, self.bpp_params)
        g, h = self.bpp_params.G, self.bpp_params.H_vec[0]
        msg_blinding = blindings.get(0, F.rand(rng))
        sc1 = SchnorrCommitment.new([g, h], [msg_blinding, F.rand(rng)])
        sc2 = SchnorrCommitment.new([g, h], [msg_blinding, F.rand(rng)])
        wits1 = [F(v), rand[0]]
        wits2 = [F(v), -rand[1]]
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                stmt._contribution(V, sc1.t, sc2.t, writer)

            def gen_proof(self, challenge):
                prover_t = _bpp_transcript(challenge)
                prover = Prover(2, stmt.num_bits, list(V),
                                list(values), list(rand))
                bpp = prover.prove(rng, stmt.bpp_params, prover_t)
                return BoundCheckBppProof(
                    V=V, bpp_proof=bpp,
                    sp1=sc1.response(wits1, challenge), t1=sc1.t,
                    sp2=sc2.response(wits2, challenge), t2=sc2.t)

        return SP()

    def _contribution(self, V, t1, t2, writer: ByteWriter):
        g, h = self.bpp_params.G, self.bpp_params.H_vec[0]
        comm_1 = (V[0] + g * self.min_val).normalize()
        comm_2 = (g * (self.max_val - 1) - V[1]).normalize()
        for p in (g, h, comm_1, t1, comm_2, t2):
            writer.point(p)

    def proof_challenge_contribution(self, proof, writer):
        self._contribution(proof.V, proof.t1, proof.t2, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        vt = _bpp_transcript(challenge)
        if not proof.bpp_proof.verify(self.num_bits, proof.V,
                                      self.bpp_params, vt):
            raise ProofSystemError("BP++ range proof failed")
        g, h = self.bpp_params.G, self.bpp_params.H_vec[0]
        comm_1 = (proof.V[0] + g * self.min_val).normalize()
        comm_2 = (g * (self.max_val - 1) - proof.V[1]).normalize()
        if not proof.sp1.is_valid([g, h], comm_1, proof.t1, challenge):
            raise ProofSystemError("BP++ bound Schnorr 1 failed")
        if not proof.sp2.is_valid([g, h], comm_2, proof.t2, challenge):
            raise ProofSystemError("BP++ bound Schnorr 2 failed")
        if proof.sp1.get_response(0) != proof.sp2.get_response(0):
            raise ProofSystemError("BP++ bound value responses differ")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.sp1.get_response(0)


@dataclass
class BoundCheckBppProof:
    V: list
    bpp_proof: object
    sp1: SchnorrResponse
    t1: Point
    sp2: SchnorrResponse
    t2: Point


# ---------------------------------------------------------------------------
# CCS set-membership (SMC) bound check
# ---------------------------------------------------------------------------

@dataclass
class BoundCheckSmc(Statement):
    """v in [min, max) via the CCS arbitrary-range proof over a fresh
    Pedersen commitment, plus a Schnorr opening with shared blinding on v
    (`bound_check_smc.rs`)."""
    min_val: int
    max_val: int
    params: SetMembershipCheckParams
    comm_key: MemberCommitmentKey
    base: int = 2

    def init_subprotocol(self, rng, blindings, witness):
        v = int(witness)
        r = F.rand(rng)
        commitment = self.comm_key.commit(F(v), r)
        prot = CCSArbitraryRangeProtocol.init(
            rng, v, r, self.min_val, self.max_val, self.base,
            self.comm_key, self.params, self.device)
        msg_blinding = blindings.get(0, F.rand(rng))
        sc = SchnorrCommitment.new([self.comm_key.g, self.comm_key.h],
                                   [msg_blinding, F.rand(rng)])
        wits = [F(v), r]
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                prot.challenge_contribution(commitment, stmt.comm_key,
                                            stmt.params, writer)
                writer.point(sc.t)

            def gen_proof(self, challenge):
                return BoundCheckSmcProof(
                    commitment=commitment,
                    range_proof=prot.gen_proof(challenge),
                    sc=sc.response(wits, challenge), t=sc.t)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.range_proof.challenge_contribution(
            proof.commitment, self.comm_key, self.params, writer)
        writer.point(proof.t)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.range_proof.verify(
                proof.commitment, challenge, self.min_val, self.max_val,
                self.comm_key, self.params, pairing_checker, self.device):
            raise ProofSystemError("SMC range proof failed")
        if not proof.sc.is_valid([self.comm_key.g, self.comm_key.h],
                                 proof.commitment, proof.t, challenge):
            raise ProofSystemError("SMC commitment opening failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.sc.get_response(0)


@dataclass
class BoundCheckSmcProof:
    commitment: Point
    range_proof: CCSArbitraryRangeProof
    sc: SchnorrResponse
    t: Point


# ---------------------------------------------------------------------------
# Circom R1CS via LegoGroth16
# ---------------------------------------------------------------------------

@dataclass
class R1CSCircomStatement(Statement):
    """Arbitrary circom-compiled circuit proven under LegoGroth16 with the
    first `commit_witness_count` private wires committed in D and exposed
    for cross-statement linking (`r1cs_legogorth16.rs`).

    Witness: full circom wire assignment [1, publics..., privates...]."""
    r1cs: CircomR1CS
    snark_pk: snark.ProvingKey
    public_inputs: list

    def init_subprotocol(self, rng, blindings, witness):
        cwc = self.snark_pk.vk.commit_witness_count
        proof, v, committed = snark.create_proof(
            circom_circuit(self.r1cs, wire_assignment=witness,
                           commit_witness_count=cwc),
            self.snark_pk, rng, device=self.device)
        ck = self.snark_pk.vk.get_commitment_key_for_witnesses()
        bl = [blindings.get(i, F.rand(rng)) for i in range(cwc)]
        bl.append(F.rand(rng))   # for v
        sc = SchnorrCommitment.new(ck, bl)
        wits = list(committed) + [v]
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                stmt._contribution_d(proof.d, sc.t, writer)

            def gen_proof(self, challenge):
                return R1CSCircomProof(snark_proof=proof, t=sc.t,
                                       sc=sc.response(wits, challenge))

        return SP()

    def _contribution_d(self, d, t, writer: ByteWriter):
        for p in self.snark_pk.vk.get_commitment_key_for_witnesses():
            writer.point(p)
        writer.point(d)
        writer.point(t)
        for x in self.public_inputs:
            writer.field(x)

    @staticmethod
    def _d_of(proof):
        return proof.commitment if isinstance(proof, R1CSCircomProofAggr) \
            else proof.snark_proof.d

    def proof_challenge_contribution(self, proof, writer):
        self._contribution_d(self._d_of(proof), proof.t, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if isinstance(proof, R1CSCircomProofAggr):
            raise ProofSystemError(
                "aggregated R1CS proof in non-aggregating spec")
        pvk = self.derived("r1cs_pvk", self.snark_pk.vk,
                           snark.PreparedVerifyingKey.from_vk)
        if pairing_checker is not None:
            snark.verify_proof_with_checker(pvk, proof.snark_proof,
                                            self.public_inputs,
                                            pairing_checker)
        elif not snark.verify_proof(pvk, proof.snark_proof,
                                    self.public_inputs):
            raise ProofSystemError("R1CS SNARK verification failed")
        self._verify_schnorr(proof, challenge)

    def _verify_schnorr(self, proof, challenge):
        ck = self.snark_pk.vk.get_commitment_key_for_witnesses()
        if not proof.sc.is_valid(ck, self._d_of(proof), proof.t,
                                 challenge):
            raise ProofSystemError("R1CS commitment PoK failed")

    # -- SnarkPack aggregation hooks (`statement_proof.rs`
    #    R1CSLegoGroth16WithAggregation) --

    def strip_snark_proof(self, proof):
        return proof.snark_proof, R1CSCircomProofAggr(
            commitment=proof.snark_proof.d, t=proof.t, sc=proof.sc)

    def verify_proof_when_aggregating(self, proof, challenge,
                                      pairing_checker=None):
        self._verify_schnorr(proof, challenge)

    def aggregate_public_inputs(self, proof):
        return [F(int(x)) for x in self.public_inputs]

    def response_for_witness(self, proof, wit_idx):
        return proof.sc.get_response(wit_idx)


@dataclass
class R1CSCircomProof:
    snark_proof: snark.Proof
    t: Point
    sc: SchnorrResponse


@dataclass
class R1CSCircomProofAggr:
    """R1CS statement proof when the LegoGroth16 proof is folded into a
    SnarkPack aggregate."""
    commitment: Point
    t: Point
    sc: SchnorrResponse


# ---------------------------------------------------------------------------
# public-value inequality
# ---------------------------------------------------------------------------

@dataclass
class PublicInequalityStatement(Statement):
    """Commitment opens to a value != public `inequal_to`
    (`inequality.rs`); message blinding shareable via the sc_c leg."""
    commitment: Point
    inequal_to: Fp
    comm_key: PedersenCommitmentKey

    def init_subprotocol(self, rng, blindings, witness):
        value, randomness = witness
        prot = DiscreteLogInequalityProtocol.init_with_public_value(
            rng, value, randomness, self.commitment, self.inequal_to,
            self.comm_key)
        if 0 in blindings:
            # re-init the committed-value leg with the forced blinding
            prot.sc_c = PokPedersenCommitmentProtocol.init(
                value, blindings[0], self.comm_key.g, randomness,
                F.rand(rng), self.comm_key.h)
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                prot.challenge_contribution(stmt.commitment,
                                            stmt.inequal_to,
                                            stmt.comm_key, writer)

            def gen_proof(self, challenge):
                return prot.gen_proof(challenge)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.challenge_contribution(self.commitment, self.inequal_to,
                                     self.comm_key, writer)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        if not proof.verify_with_public_value(
                self.commitment, self.inequal_to, challenge, self.comm_key):
            raise ProofSystemError("inequality proof failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.response_for_value()


# ---------------------------------------------------------------------------
# SMC bound check with keyed verification
# (`statement/bound_check_smc_with_kv.rs` + `sub_protocols/
# bound_check_smc_with_kv.rs`)
# ---------------------------------------------------------------------------

@dataclass
class BoundCheckSmcWithKVProver(Statement):
    """Same commitment + CCS arbitrary-range structure as `BoundCheckSmc`
    but the per-digit weak-BB signature checks are keyed-verification:
    no pairings anywhere.  The prover statement carries only the public
    KV params; a plain verifier can check only commitment consistency."""
    min_val: int
    max_val: int
    params: SetMembershipCheckParamsKV
    comm_key: MemberCommitmentKey
    base: int = 2

    def init_subprotocol(self, rng, blindings, witness):
        v = int(witness)
        r = F.rand(rng)
        commitment = self.comm_key.commit(F(v), r)
        prot = CCSArbitraryRangeKVProtocol.init(
            rng, v, r, self.min_val, self.max_val, self.base,
            self.comm_key, self.params)
        msg_blinding = blindings.get(0, F.rand(rng))
        sc = SchnorrCommitment.new([self.comm_key.g, self.comm_key.h],
                                   [msg_blinding, F.rand(rng)])
        wits = [F(v), r]
        stmt = self

        class SP:
            def challenge_contribution(self, writer):
                prot.challenge_contribution(commitment, stmt.comm_key,
                                            stmt.params, writer)
                writer.point(sc.t)

            def gen_proof(self, challenge):
                return BoundCheckSmcKVProof(
                    commitment=commitment,
                    range_proof=prot.gen_proof(challenge),
                    sc=sc.response(wits, challenge), t=sc.t)

        return SP()

    def proof_challenge_contribution(self, proof, writer):
        proof.range_proof.challenge_contribution(
            proof.commitment, self.comm_key, self.params, writer)
        writer.point(proof.t)

    def verify_proof(self, proof, challenge, pairing_checker=None):
        # without the secret key only the Schnorr opening is checkable
        if not proof.sc.is_valid([self.comm_key.g, self.comm_key.h],
                                 proof.commitment, proof.t, challenge):
            raise ProofSystemError("SMC-KV commitment opening failed")

    def response_for_witness(self, proof, wit_idx):
        assert wit_idx == 0
        return proof.sc.get_response(0)


@dataclass
class BoundCheckSmcWithKVVerifier(BoundCheckSmcWithKVProver):
    """Holds the weak-BB secret key and fully verifies the KV range
    proof (`bound_check_smc_with_kv.rs:75-118`)."""
    secret_key: object = None    # WeakBBSecretKey

    def verify_proof(self, proof, challenge, pairing_checker=None):
        super().verify_proof(proof, challenge, pairing_checker)
        if not proof.range_proof.verify(
                proof.commitment, challenge, self.min_val, self.max_val,
                self.comm_key, self.params, self.secret_key):
            raise ProofSystemError("SMC-KV range proof failed")


@dataclass
class BoundCheckSmcKVProof:
    commitment: Point
    range_proof: object
    sc: SchnorrResponse
    t: Point
