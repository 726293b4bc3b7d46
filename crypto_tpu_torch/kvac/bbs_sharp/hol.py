"""BBS# half-offline (HOL) mode (reference `kvac/src/bbs_sharp/hol.rs`).

The user pre-randomizes a batch of tokens (A_hat, B_bar, D), sends BLINDED
challenges c_0 = c/u to the signer, who answers a standard Schnorr response
on its key; the user unblinds to get, per token, a proof of validity
(c, r) of the statement "B_bar = A_hat * x" — verifiable by anyone against
the signer public key, without contacting the signer at presentation time.
Blinding with (u, v) prevents the signer correlating issuance with
presentations.

The port's own copy of `crypto_tpu/kvac/bbs_sharp/hol.py`; host
code (no device field is built for secp256r1)."""

from __future__ import annotations

from dataclasses import dataclass

from ...curves.sw import Point
from ...fields.host import Fp
from ...hashing import blake2b512, compute_random_oracle_challenge
from ...serialize import serialize_point
from ..bbdt16 import KVACError
from .mac import MAC
from .setup import MACParams, SecretKey, SignerPublicKey, UserPublicKey


@dataclass
class PreChallengeData:
    A_0: list
    B_0: list


@dataclass
class TokenPrivateData:
    D: Point
    r1: Fp
    r3: Fp
    minus_e: Fp


@dataclass
class ProofOfValidity:
    """(A_hat, B_bar) with Schnorr proof (c, r) that B_bar = A_hat * x."""
    A_hat: Point
    B_bar: Point
    c: Fp
    r: Fp

    def verify(self, signer_pk: SignerPublicKey, params: MACParams,
               nonce: bytes = None, digest=blake2b512) -> bool:
        return self.verify_given_destructured(
            self.A_hat, self.B_bar, self.c, self.r, signer_pk.point,
            params.g_tilde, nonce, digest)

    @staticmethod
    def verify_given_destructured(A_hat: Point, B_bar: Point, c: Fp, r: Fp,
                                  pk: Point, g_tilde: Point,
                                  nonce: bytes = None,
                                  digest=blake2b512) -> bool:
        buf = serialize_point(A_hat) + serialize_point(B_bar)
        buf += serialize_point(
            (g_tilde * int(r) - pk * int(c)).normalize())
        buf += serialize_point(
            (A_hat * int(r) - B_bar * int(c)).normalize())
        if nonce is not None:
            buf += nonce
        return compute_random_oracle_challenge(c.f, buf, digest) == c


@dataclass
class HOLUserProtocol:
    A_hat: list
    B_bar: list
    D: list
    r1: list
    r3: list
    l: list
    minus_e: Fp
    u: list
    v: list
    c: list = None

    @classmethod
    def init(cls, rng, num_tokens: int, mac: MAC, messages,
             user_public_key: UserPublicKey, params: MACParams):
        if len(messages) != params.supported_message_count:
            raise KVACError("message count mismatch")
        F = params.scalar_field
        u = [F.rand_nonzero(rng) for _ in range(num_tokens)]
        v = [F.rand(rng) for _ in range(num_tokens)]
        minus_e = -mac.e
        B = params.b(list(enumerate(messages)), user_public_key)
        A_hat, B_bar, D, r1s, r3s, ls = [], [], [], [], [], []
        for _ in range(num_tokens):
            r1 = F.rand(rng)
            r2 = F.rand_nonzero(rng)
            r3 = r2.inverse()
            l_i = r1 * r2
            A_hat.append((mac.A * int(l_i)).normalize())
            D.append((B * int(r2)).normalize())
            B_bar.append((B * int(l_i)
                          + mac.A * int(l_i * minus_e)).normalize())
            r1s.append(r1)
            r3s.append(r3)
            ls.append(l_i)
        return cls(A_hat=A_hat, B_bar=B_bar, D=D, r1=r1s, r3=r3s, l=ls,
                   minus_e=minus_e, u=u, v=v)

    def compute_challenge(self, pre_chal: PreChallengeData,
                          params: MACParams, nonces: list = None,
                          digest=blake2b512) -> list:
        """Returns the blinded challenges c_0_i = c_i / u_i for the signer."""
        n = len(self.A_hat)
        assert len(pre_chal.A_0) == n and len(pre_chal.B_0) == n
        if nonces is not None:
            assert len(nonces) == n
        F = params.scalar_field
        c, c_0 = [], []
        for i in range(n):
            uv = self.u[i] * self.v[i]
            A_0_um = (pre_chal.A_0[i] * int(self.u[i])
                      + params.g_tilde * int(uv)).normalize()
            B_0_um = (pre_chal.B_0[i] * int(self.u[i] * self.l[i])
                      + self.A_hat[i] * int(uv)).normalize()
            buf = serialize_point(self.A_hat[i]) \
                + serialize_point(self.B_bar[i]) \
                + serialize_point(A_0_um) + serialize_point(B_0_um)
            if nonces is not None:
                buf += nonces[i]
            c_i = compute_random_oracle_challenge(F, buf, digest)
            c.append(c_i)
            c_0.append(c_i * self.u[i].inverse())
        self.c = c
        return c_0

    def process_response(self, responses: list):
        """Unblind the signer's responses into per-token
        (TokenPrivateData, ProofOfValidity)."""
        assert len(responses) == len(self.A_hat)
        tokens, proofs = [], []
        for i, r_0 in enumerate(responses):
            r = (r_0 + self.v[i]) * self.u[i]
            tokens.append(TokenPrivateData(D=self.D[i], r1=self.r1[i],
                                           r3=self.r3[i],
                                           minus_e=self.minus_e))
            proofs.append(ProofOfValidity(A_hat=self.A_hat[i],
                                          B_bar=self.B_bar[i],
                                          c=self.c[i], r=r))
        return tokens, proofs


@dataclass
class HOLSignerProtocol:
    s: list

    @classmethod
    def init(cls, rng, num_tokens: int, A: Point, params: MACParams):
        """A is the MAC's A for this user (signer stores it at issuance)."""
        F = params.scalar_field
        s = [F.rand(rng) for _ in range(num_tokens)]
        A_0 = [(params.g_tilde * int(s_i)).normalize() for s_i in s]
        B_0 = [(A * int(s_i)).normalize() for s_i in s]
        return cls(s=s), PreChallengeData(A_0=A_0, B_0=B_0)

    def compute_response(self, blinded_challenges: list,
                         signer_secret_key: SecretKey) -> list:
        assert len(blinded_challenges) == len(self.s)
        return [s_i + c_i * signer_secret_key.x
                for c_i, s_i in zip(blinded_challenges, self.s)]
