"""Full Boneh-Boyen signatures and their proof of knowledge: the port's
own copy of `crypto_tpu/short_group_sig/bb_sig.py` (reference
`short_group_sig/src/{bb_sig,bb_sig_pok_cdh}.rs`).

sk = (x, y); pk = (X_hat = g2*x, Y_hat = g2*y).
Signature on m: randomness r, A = g1 * 1/(x + m + y*r); sig = (A, r).
Verify: e(A, X_hat + g2*m + Y_hat*r) == e(g1, g2).

PoK (pairing-free prover): publish A' = A*rho, A_r = A'*r,
A_bar = g1*rho - A'*m.  From A*(x+m+y*r) = g1 it follows that
A_bar = A'*x + A_r*y; the verifier checks
e(A_bar, g2) == e(A', X_hat) * e(A_r, Y_hat) (on the host) plus two
Schnorr relations: (rho, m) in A_bar = g1*rho + (-A')*m and r in
A_r = A'*r.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..hashing import blake2b512, concat_slices, group_elem_from_try_and_incr
from ..schnorr.generalized import SchnorrCommitment, SchnorrResponse
from ..serialize import ByteWriter

F = bls.Fr


@dataclass
class BBSigParams:
    g1: Point
    g2: Point

    @classmethod
    def new(cls, label: bytes, digest=blake2b512):
        return cls(
            g1=group_elem_from_try_and_incr(
                bls.G1, concat_slices(label, b" : g1"), digest).normalize(),
            g2=group_elem_from_try_and_incr(
                bls.G2, concat_slices(label, b" : g2"), digest).normalize())


@dataclass
class BBSecretKey:
    x: Fp
    y: Fp

    @classmethod
    def generate(cls, rng):
        return cls(F.rand_nonzero(rng), F.rand_nonzero(rng))


@dataclass
class BBPublicKey:
    X_hat: Point
    Y_hat: Point

    @classmethod
    def generate(cls, sk: BBSecretKey, params: BBSigParams):
        return cls(X_hat=(params.g2 * int(sk.x)).normalize(),
                   Y_hat=(params.g2 * int(sk.y)).normalize())


@dataclass
class BBSig:
    A: Point
    r: Fp

    @classmethod
    def new(cls, rng, message: Fp, sk: BBSecretKey,
            params: BBSigParams) -> "BBSig":
        while True:
            r = F.rand(rng)
            denom = sk.x + message + sk.y * r
            if not denom.is_zero():
                break
        return cls(A=(params.g1 * int(denom.inverse())).normalize(), r=r)

    def verify(self, message: Fp, pk: BBPublicKey,
               params: BBSigParams) -> bool:
        rhs = (pk.X_hat + params.g2 * int(message)
               + pk.Y_hat * int(self.r)).normalize()
        return bls.multi_pairing([(self.A, rhs),
                                  (-params.g1, params.g2)]).is_one()


@dataclass
class PoKBBSigProtocol:
    """Knowledge of (A, r) and the message m, pairing-free for the
    prover (the module's relations)."""
    A_prime: Point
    A_r: Point
    A_bar: Point
    sc1: SchnorrCommitment
    sc2: SchnorrCommitment
    wits1: list
    wits2: list

    @classmethod
    def init(cls, rng, sig: BBSig, message: Fp, params: BBSigParams,
             m_blinding: Optional[Fp] = None,
             r_blinding: Optional[Fp] = None):
        rho = F.rand_nonzero(rng)
        A_prime = (sig.A * int(rho)).normalize()
        A_r = (A_prime * int(sig.r)).normalize()
        A_bar = (params.g1 * int(rho) - A_prime * int(message)).normalize()
        sc1 = SchnorrCommitment.new(
            [params.g1, (-A_prime).normalize()],
            [F.rand(rng),
             m_blinding if m_blinding is not None else F.rand(rng)])
        sc2 = SchnorrCommitment.new(
            [A_prime],
            [r_blinding if r_blinding is not None else F.rand(rng)])
        return cls(A_prime=A_prime, A_r=A_r, A_bar=A_bar, sc1=sc1, sc2=sc2,
                   wits1=[rho, message], wits2=[sig.r])

    def challenge_contribution(self, params: BBSigParams,
                               writer: ByteWriter):
        _bb_contribution(self.A_prime, self.A_r, self.A_bar, self.sc1.t,
                         self.sc2.t, params, writer)

    def gen_proof(self, challenge: Fp) -> "PoKBBSig":
        return PoKBBSig(A_prime=self.A_prime, A_r=self.A_r, A_bar=self.A_bar,
                        t1=self.sc1.t, t2=self.sc2.t,
                        resp1=self.sc1.response(self.wits1, challenge),
                        resp2=self.sc2.response(self.wits2, challenge))


def _bb_contribution(A_prime, A_r, A_bar, t1, t2, params,
                     writer: ByteWriter):
    writer.points((A_prime, A_r, A_bar, t1, t2, params.g1))


@dataclass
class PoKBBSig:
    A_prime: Point
    A_r: Point
    A_bar: Point
    t1: Point
    t2: Point
    resp1: SchnorrResponse
    resp2: SchnorrResponse

    def challenge_contribution(self, params: BBSigParams,
                               writer: ByteWriter):
        _bb_contribution(self.A_prime, self.A_r, self.A_bar, self.t1,
                         self.t2, params, writer)

    def verify(self, challenge: Fp, pk: BBPublicKey,
               params: BBSigParams) -> bool:
        if self.A_prime.is_infinity():
            return False
        if not self.resp1.is_valid([params.g1, (-self.A_prime).normalize()],
                                   self.A_bar, self.t1, challenge):
            return False
        if not self.resp2.is_valid([self.A_prime], self.A_r, self.t2,
                                   challenge):
            return False
        # e(A_bar, g2) == e(A', X_hat) * e(A_r, Y_hat)
        return bls.multi_pairing([
            ((-self.A_bar).normalize(), params.g2),
            (self.A_prime, pk.X_hat),
            (self.A_r, pk.Y_hat)]).is_one()

    def response_for_message(self) -> Fp:
        return self.resp1.get_response(1)
