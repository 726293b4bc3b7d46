"""Original VB accumulator (non)membership proofs: the port's own copy of
`crypto_tpu/accumulator/proofs_original.py` (reference
`vb_accumulator/src/proofs.rs`, paper 2020/777 section 7).

Unlike the CDH variant, the Schnorr commitment itself holds a GT element
(R_E), so the prover pairs as well as the verifier.  Every pairing
product here goes through `curves.tpairing.multi_pairings_routed` on
`device` (CUDA unless the caller names the CPU): the router sends a call
to the batched device pairing or to the host by its pairs and products,
and either gives the host `multi_pairing`'s value.  The verifier can
instead defer its equation, R_E its target, into a shared
`RandomizedPairingChecker` (`verify_with_pairing_checker`): the checker
takes a GT target, so the equation defers like any other.

ProvingKey: agreed generators (X, Y, Z) in G1 hashed from a label.

Randomization (witness C, member y):
  sigma, rho random;  E_C = C + (sigma+rho)*Z;  T_sigma = sigma*X;
  T_rho = rho*Y;  delta_sigma = y*sigma;  delta_rho = y*rho.
Commitments:
  R_sigma = r_sigma*X;  R_rho = r_rho*Y;
  R_delta_sigma = r_y*T_sigma - r_delta_sigma*X;
  R_delta_rho   = r_y*T_rho   - r_delta_rho*Y;
  R_E = e(r_y*E_C + (-r_ds - r_dr)*Z, P_tilde) * e((-r_s - r_r)*Z, Q_tilde)
Responses s_* = r_* + c*witness_*; verification re-derives all five
commitments (R_E through the pairing identity with V folded in at power
c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..hashing import blake2b512, concat_slices, group_elem_from_try_and_incr
from ..serialize import ByteWriter
from .core import MembershipWitness
from .setup import AccumPublicKey, AccumSetupParams

F = bls.Fr


def _label_points(label: bytes, tags, digest) -> list:
    return [group_elem_from_try_and_incr(
        bls.G1, concat_slices(label, tag), digest).normalize()
        for tag in tags]


@dataclass
class MembershipProvingKey:
    X: Point
    Y: Point
    Z: Point

    @classmethod
    def new(cls, label: bytes, digest=blake2b512):
        return cls(*_label_points(label, (b" : X", b" : Y", b" : Z"),
                                  digest))


def _pairing_pairs(E_C, s_y, s_sigma, s_rho, s_delta_sigma, s_delta_rho, c,
                   V, params, pk, prk, extra_p=None):
    """The two pairs whose product the verifier holds against R_E:
    (s_y E_C - (s_ds + s_dr) Z - c V [+ extra_p], P_tilde),
    (-(s_sigma + s_rho) Z + c E_C, Q_tilde)."""
    p_part = (E_C * int(s_y) + prk.Z * int(-s_delta_sigma - s_delta_rho)
              - V * int(c))
    if extra_p is not None:
        p_part = p_part + extra_p
    q_part = prk.Z * int(-s_sigma - s_rho) + E_C * int(c)
    return [(p_part.normalize(), params.P_tilde),
            (q_part.normalize(), pk.Q_tilde)]


@dataclass
class MembershipProofProtocol:
    E_C: Point
    T_sigma: Point
    T_rho: Point
    R_E: object
    R_sigma: Point
    R_rho: Point
    R_delta_sigma: Point
    R_delta_rho: Point
    _wits: dict

    @classmethod
    def init(cls, rng, element: Fp, element_blinding: Optional[Fp],
             witness: MembershipWitness, accumulator_value: Point,
             pk: AccumPublicKey, params: AccumSetupParams,
             prk: MembershipProvingKey, device="cuda", extra_pairs=()):
        """`extra_pairs`: further (G1, G2) pairs multiplied into R_E in
        the same routed call (the non-membership proof's)."""
        sigma, rho = F.rand(rng), F.rand(rng)
        E_C = (witness.C + prk.Z * int(sigma + rho)).normalize()
        T_sigma = (prk.X * int(sigma)).normalize()
        T_rho = (prk.Y * int(rho)).normalize()
        delta_sigma = element * sigma
        delta_rho = element * rho

        r_y = element_blinding if element_blinding is not None \
            else F.rand(rng)
        r_s, r_ds = F.rand(rng), F.rand(rng)
        r_r, r_dr = F.rand(rng), F.rand(rng)

        p_part = (E_C * int(r_y) + prk.Z * int(-r_ds - r_dr)).normalize()
        q_part = (prk.Z * int(-r_s - r_r)).normalize()
        R_E = multi_pairings_routed(
            [[(p_part, params.P_tilde), (q_part, pk.Q_tilde),
              *extra_pairs]], device)[0]
        R_sigma = (prk.X * int(r_s)).normalize()
        R_rho = (prk.Y * int(r_r)).normalize()
        R_delta_sigma = (T_sigma * int(r_y) - prk.X * int(r_ds)).normalize()
        R_delta_rho = (T_rho * int(r_y) - prk.Y * int(r_dr)).normalize()

        return cls(E_C=E_C, T_sigma=T_sigma, T_rho=T_rho, R_E=R_E,
                   R_sigma=R_sigma, R_rho=R_rho,
                   R_delta_sigma=R_delta_sigma, R_delta_rho=R_delta_rho,
                   _wits=dict(y=element, sigma=sigma, rho=rho,
                              delta_sigma=delta_sigma, delta_rho=delta_rho,
                              r_y=r_y, r_s=r_s, r_r=r_r, r_ds=r_ds,
                              r_dr=r_dr))

    def challenge_contribution(self, accumulator_value: Point,
                               pk: AccumPublicKey, params: AccumSetupParams,
                               prk: MembershipProvingKey,
                               writer: ByteWriter):
        _orig_contribution(self.E_C, self.T_sigma, self.T_rho, self.R_E,
                           self.R_sigma, self.R_rho, self.R_delta_sigma,
                           self.R_delta_rho, accumulator_value, pk, params,
                           prk, writer)

    def gen_proof(self, challenge: Fp) -> "MembershipProofOriginal":
        w = self._wits
        return MembershipProofOriginal(
            E_C=self.E_C, T_sigma=self.T_sigma, T_rho=self.T_rho,
            R_E=self.R_E, R_sigma=self.R_sigma, R_rho=self.R_rho,
            R_delta_sigma=self.R_delta_sigma, R_delta_rho=self.R_delta_rho,
            s_y=w["r_y"] + challenge * w["y"],
            s_sigma=w["r_s"] + challenge * w["sigma"],
            s_rho=w["r_r"] + challenge * w["rho"],
            s_delta_sigma=w["r_ds"] + challenge * w["delta_sigma"],
            s_delta_rho=w["r_dr"] + challenge * w["delta_rho"])


def _orig_contribution(E_C, T_sigma, T_rho, R_E, R_sigma, R_rho, R_ds, R_dr,
                       V, pk, params, prk, writer: ByteWriter):
    writer.points((E_C, T_sigma, T_rho))
    writer.write(R_E.to_bytes_le())
    writer.points((R_sigma, R_rho, R_ds, R_dr, V, pk.Q_tilde, params.P,
                   params.P_tilde, prk.X, prk.Y, prk.Z))


@dataclass
class MembershipProofOriginal:
    E_C: Point
    T_sigma: Point
    T_rho: Point
    R_E: object
    R_sigma: Point
    R_rho: Point
    R_delta_sigma: Point
    R_delta_rho: Point
    s_y: Fp
    s_sigma: Fp
    s_rho: Fp
    s_delta_sigma: Fp
    s_delta_rho: Fp

    def challenge_contribution(self, accumulator_value, pk, params, prk,
                               writer: ByteWriter):
        _orig_contribution(self.E_C, self.T_sigma, self.T_rho, self.R_E,
                           self.R_sigma, self.R_rho, self.R_delta_sigma,
                           self.R_delta_rho, accumulator_value, pk, params,
                           prk, writer)

    def verify_schnorr(self, challenge: Fp, prk) -> bool:
        """The four G1 Schnorr re-derivations."""
        c = int(challenge)
        return ((prk.X * int(self.s_sigma) - self.T_sigma * c)
                == self.R_sigma
                and (prk.Y * int(self.s_rho) - self.T_rho * c) == self.R_rho
                and (self.T_sigma * int(self.s_y)
                     - prk.X * int(self.s_delta_sigma)) == self.R_delta_sigma
                and (self.T_rho * int(self.s_y)
                     - prk.Y * int(self.s_delta_rho)) == self.R_delta_rho)

    def pairing_pairs(self, accumulator_value, challenge, pk, params, prk,
                      extra_p=None) -> list:
        return _pairing_pairs(self.E_C, self.s_y, self.s_sigma, self.s_rho,
                              self.s_delta_sigma, self.s_delta_rho,
                              challenge, accumulator_value, params, pk, prk,
                              extra_p)

    def verify(self, accumulator_value: Point, challenge: Fp,
               pk: AccumPublicKey, params: AccumSetupParams,
               prk: MembershipProvingKey, device="cuda") -> bool:
        if not self.verify_schnorr(challenge, prk):
            return False
        pairs = self.pairing_pairs(accumulator_value, challenge, pk, params,
                                   prk)
        return multi_pairings_routed([pairs], device)[0] == self.R_E

    def verify_with_pairing_checker(self, accumulator_value: Point,
                                    challenge: Fp, pk: AccumPublicKey,
                                    params: AccumSetupParams,
                                    prk: MembershipProvingKey,
                                    checker) -> bool:
        if not self.verify_schnorr(challenge, prk):
            return False
        pairs = self.pairing_pairs(accumulator_value, challenge, pk, params,
                                   prk)
        checker.add_multiple_sources_and_target(
            [p for p, _ in pairs], [q for _, q in pairs], self.R_E)
        return True

    def response_for_element(self) -> Fp:
        return self.s_y


# ---------------------------------------------------------------------------
# Original non-membership proof (reference `proofs.rs:1100-1560`): the
# membership structure over the relation C(y+alpha) = V - d*P plus a
# commitment E_d = d*P + tau*K with proofs of knowledge of (d, tau) and of
# d != 0 via E_d_inv = (1/d)*P + pi*K and the product relation
# d*E_d_inv = P + (d*pi)*K.
# ---------------------------------------------------------------------------

@dataclass
class NonMembershipProvingKey:
    X: Point
    Y: Point
    Z: Point
    K: Point

    @classmethod
    def new(cls, label: bytes, digest=blake2b512):
        return cls(*_label_points(
            label, (b" : X", b" : Y", b" : Z", b" : K"), digest))

    def membership_key(self) -> MembershipProvingKey:
        return MembershipProvingKey(X=self.X, Y=self.Y, Z=self.Z)


@dataclass
class NonMembershipProofProtocol:
    mem: MembershipProofProtocol
    E_d: Point
    E_d_inv: Point
    R_A: Point
    R_B: Point
    _nm_wits: dict

    @classmethod
    def init(cls, rng, element: Fp, element_blinding, witness,
             accumulator_value: Point, pk: AccumPublicKey,
             params: AccumSetupParams, prk: NonMembershipProvingKey,
             device="cuda"):
        d = witness.d
        tau, pi = F.rand(rng), F.rand(rng)
        E_d = (params.P * int(d) + prk.K * int(tau)).normalize()
        E_d_inv = (params.P * int(d.inverse())
                   + prk.K * int(pi)).normalize()
        r_u, r_v, r_w = F.rand(rng), F.rand(rng), F.rand(rng)
        R_A = (params.P * int(r_u) + prk.K * int(r_v)).normalize()
        R_B = (E_d_inv * int(r_u) + prk.K * int(r_w)).normalize()
        # e(-r_v*K, P_tilde) folds into R_E (`proofs.rs:1141-1150`), in
        # the membership commitment's own routed call
        mem = MembershipProofProtocol.init(
            rng, element, element_blinding, MembershipWitness(C=witness.C),
            accumulator_value, pk, params, prk.membership_key(), device,
            extra_pairs=[((prk.K * int(-r_v)).normalize(), params.P_tilde)])
        return cls(mem=mem, E_d=E_d, E_d_inv=E_d_inv, R_A=R_A, R_B=R_B,
                   _nm_wits=dict(d=d, tau=tau, pi=pi, r_u=r_u, r_v=r_v,
                                 r_w=r_w))

    def challenge_contribution(self, accumulator_value, pk, params, prk,
                               writer: ByteWriter):
        self.mem.challenge_contribution(accumulator_value, pk, params,
                                        prk.membership_key(), writer)
        writer.points((self.E_d, self.E_d_inv, self.R_A, self.R_B, prk.K))

    def gen_proof(self, challenge: Fp) -> "NonMembershipProofOriginal":
        w = self._nm_wits
        cd = challenge * w["d"]
        return NonMembershipProofOriginal(
            mem=self.mem.gen_proof(challenge), E_d=self.E_d,
            E_d_inv=self.E_d_inv, R_A=self.R_A, R_B=self.R_B,
            s_u=w["r_u"] + cd,
            s_v=w["r_v"] + challenge * w["tau"],
            s_w=w["r_w"] - cd * w["pi"])


@dataclass
class NonMembershipProofOriginal:
    mem: MembershipProofOriginal
    E_d: Point
    E_d_inv: Point
    R_A: Point
    R_B: Point
    s_u: Fp
    s_v: Fp
    s_w: Fp

    def challenge_contribution(self, accumulator_value, pk, params, prk,
                               writer: ByteWriter):
        self.mem.challenge_contribution(accumulator_value, pk, params,
                                        prk.membership_key(), writer)
        writer.points((self.E_d, self.E_d_inv, self.R_A, self.R_B, prk.K))

    def _schnorr_and_pairs(self, accumulator_value, challenge, pk, params,
                           prk):
        """The G1 Schnorr checks (the E_d opening, d != 0, the membership
        legs) and, where they hold, the pairs held against R_E: the
        membership's with the extra c*E_d - s_v*K term
        (`proofs.rs:964-980`); else None."""
        c = int(challenge)
        if (params.P * int(self.s_u) + prk.K * int(self.s_v)
                - self.E_d * c) != self.R_A:
            return None
        if (prk.K * int(self.s_w) + self.E_d_inv * int(self.s_u)
                - params.P * c) != self.R_B:
            return None
        if not self.mem.verify_schnorr(challenge, prk):
            return None
        return self.mem.pairing_pairs(
            accumulator_value, challenge, pk, params, prk,
            extra_p=self.E_d * c + prk.K * int(-self.s_v))

    def verify(self, accumulator_value: Point, challenge: Fp,
               pk: AccumPublicKey, params: AccumSetupParams,
               prk: NonMembershipProvingKey, device="cuda") -> bool:
        pairs = self._schnorr_and_pairs(accumulator_value, challenge, pk,
                                        params, prk)
        return pairs is not None and multi_pairings_routed(
            [pairs], device)[0] == self.mem.R_E

    def verify_with_pairing_checker(self, accumulator_value: Point,
                                    challenge: Fp, pk: AccumPublicKey,
                                    params: AccumSetupParams,
                                    prk: NonMembershipProvingKey,
                                    checker) -> bool:
        pairs = self._schnorr_and_pairs(accumulator_value, challenge, pk,
                                        params, prk)
        if pairs is None:
            return False
        checker.add_multiple_sources_and_target(
            [p for p, _ in pairs], [q for _, q in pairs], self.mem.R_E)
        return True

    def response_for_element(self) -> Fp:
        return self.mem.s_y
