"""TZ21 Robust-DKG-in-the-head verifiable encryption (reference
`verifiable_encryption/src/tz_21/rdkgith.rs`): the port's own copy of
`crypto_tpu/verifiable_encryption/rdkgith.py`.  Host code: one instance
of N parties makes N + T small products, below the device threshold.

Unlike DKGitH (tau parallel repetitions, 1-of-N unopened), RDkgith runs a
SINGLE instance with an (T+1)-of-N Shamir sharing of each witness: the
challenge hides N-T parties (their ciphertexts stay secret); the other T
parties' shares + encryption randomness are revealed.  Verification
recomputes the revealed ciphertexts and checks a random-linear-combination
polynomial identity against Feldman-style coefficient commitments:
  MSM([C, PC_1..PC_T, ck...], [power_sums..., -evals...]) == 0,
where C is the witness commitment, PC_k commits the k-th Shamir
coefficients of all witnesses, and evals are the RLC of revealed shares.

Decryption: compress to SUBSET_SIZE hidden ciphertexts, each Lagrange-
scaled and offset by the revealed shares so ONE decryption yields the
witnesses directly (checked against the commitment)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..secret_sharing.common import (lagrange_basis_at_0,
                                     lagrange_basis_at_0_for_all)
from ..secret_sharing.schemes import shamir_deal_secret
from ..serialize import serialize_point
from ..utils.elgamal import (ElgamalPublicKey, ElgamalSecretKey,
                             _hash_shared_secret)
from ..utils.ff import powers, powers_starting_from
from ..utils.msm import msm
from .tz21 import BatchCt

F = bls.Fr


class VerEncError(Exception):
    pass


def _indices_to_hide(challenge: bytes, num: int, num_parties: int) -> list:
    """Unique bounded indices from 2-byte chunks, re-hashing until enough
    (reference `util.rs` `get_unique_indices_to_hide`)."""
    out = []
    seen = set()
    c = bytes(challenge)
    while len(out) < num:
        for i in range(0, len(c) - 1, 2):
            v = int.from_bytes(c[i:i + 2], "little") % num_parties
            if v not in seen:
                seen.add(v)
                out.append(v)
                if len(out) == num:
                    break
        if len(out) < num:
            c = hashlib.blake2b(c, digest_size=64).digest()
    return sorted(out)


def _ct_multiply(ct: BatchCt, m: Fp) -> BatchCt:
    return BatchCt(eph=ct.eph, cts=[c * m for c in ct.cts])


def _ct_add(ct: BatchCt, deltas) -> BatchCt:
    return BatchCt(eph=ct.eph,
                   cts=[c + d for c, d in zip(ct.cts, deltas)])


def _ct_decrypt_after_multiplying_otp(ct: BatchCt, m: Fp,
                                      sk: ElgamalSecretKey):
    shared = ct.eph * int(sk.x)
    return [c - m * _hash_shared_secret(shared, i.to_bytes(4, "little"))
            for i, c in enumerate(ct.cts)]


@dataclass
class RdkgithProof:
    num_parties: int
    threshold: int         # number of REVEALED parties
    challenge: bytes
    poly_commitments: list
    ciphertexts: list      # [(party_idx, BatchCt)] for hidden parties
    shares_and_enc_rands: list  # [(party_idx, [shares], eph_r)]

    @classmethod
    def new(cls, rng, witnesses: list, comm_key: list,
            enc_pk: ElgamalPublicKey, enc_gen: Point,
            num_parties: int = 16, threshold: int = 12) -> "RdkgithProof":
        if len(comm_key) != len(witnesses):
            raise VerEncError("commitment key size mismatch")
        wc = len(witnesses)
        num_hidden = num_parties - threshold
        shares = [[None] * wc for _ in range(num_parties)]
        coeffs_per_wit = []
        for i, w in enumerate(witnesses):
            sh, poly = shamir_deal_secret(rng, w, threshold + 1,
                                          num_parties)
            for j in range(num_parties):
                shares[j][i] = sh.shares[j].share
            coeffs_per_wit.append(poly[1:])   # drop the constant term
        poly_commitments = [
            msm(comm_key, [coeffs_per_wit[i][k] for i in range(wc)]
                ).normalize()
            for k in range(threshold)]
        enc_rands = [F.rand(rng) for _ in range(num_parties)]
        cts = [BatchCt.encrypt(shares[j], enc_rands[j], enc_pk, enc_gen)
               for j in range(num_parties)]
        buf = bytearray()
        for c in poly_commitments:
            buf += serialize_point(c)
        for ct in cts:
            buf += serialize_point(ct.eph)
            for c in ct.cts:
                buf += c.to_bytes_le()
        challenge = hashlib.shake_256(b"rdkgith" + bytes(buf)).digest(
            num_hidden * 2)
        hidden = set(_indices_to_hide(challenge, num_hidden, num_parties))
        ciphertexts, revealed = [], []
        for j in range(num_parties):
            if j in hidden:
                ciphertexts.append((j, cts[j]))
            else:
                revealed.append((j, shares[j], enc_rands[j]))
        return cls(num_parties=num_parties, threshold=threshold,
                   challenge=challenge, poly_commitments=poly_commitments,
                   ciphertexts=ciphertexts, shares_and_enc_rands=revealed)

    def verify(self, commitment: Point, comm_key: list,
               enc_pk: ElgamalPublicKey, enc_gen: Point) -> bool:
        wc = len(comm_key)
        num_hidden = self.num_parties - self.threshold
        if len(self.poly_commitments) != self.threshold:
            return False
        if len(self.ciphertexts) != num_hidden or \
                len(self.shares_and_enc_rands) != self.threshold:
            return False
        hidden = set(_indices_to_hide(self.challenge, num_hidden,
                                      self.num_parties))
        if {i for i, _ in self.ciphertexts} != hidden:
            return False
        cts = [None] * self.num_parties
        for i, ct in self.ciphertexts:
            cts[i] = ct
        for i, s, r in self.shares_and_enc_rands:
            if len(s) != wc:
                return False
            cts[i] = BatchCt.encrypt(s, r, enc_pk, enc_gen)
        buf = bytearray()
        for c in self.poly_commitments:
            buf += serialize_point(c)
        for ct in cts:
            buf += serialize_point(ct.eph)
            for c in ct.cts:
                buf += c.to_bytes_le()
        challenge = hashlib.shake_256(b"rdkgith" + bytes(buf)).digest(
            num_hidden * 2)
        if challenge != self.challenge:
            return False
        # RLC polynomial-consistency check
        seed = hashlib.blake2b(self.challenge, digest_size=64).digest()
        random = F(int.from_bytes(seed, "little") % F.p)
        randoms = powers(random, self.threshold)
        evals = []
        for i in range(wc):
            acc = F(0)
            for j, (_, s, _) in enumerate(self.shares_and_enc_rands):
                acc = acc + s[i] * randoms[j]
            evals.append(acc)
        power_sums = [F(0)] * (self.threshold + 1)
        for j, (idx, _, _) in enumerate(self.shares_and_enc_rands):
            pows = powers_starting_from(randoms[j], F(idx + 1),
                                        self.threshold + 1)
            for k in range(self.threshold + 1):
                power_sums[k] = power_sums[k] + pows[k]
        bases = [commitment] + self.poly_commitments + list(comm_key)
        scalars = power_sums + [-e for e in evals]
        return msm(bases, scalars).is_infinity()

    def compress(self, subset_size: int = 2) -> "RdkgithCompressed":
        num_hidden = self.num_parties - self.threshold
        if subset_size > num_hidden:
            raise VerEncError("subset larger than hidden count")
        hidden_sorted = sorted(i for i, _ in self.ciphertexts)
        opened_ids = [i + 1 for i, _, _ in
                      sorted(self.shares_and_enc_rands)]
        buf = bytearray(self.challenge)
        for i, s, r in self.shares_and_enc_rands:
            buf += i.to_bytes(2, "little")
            for s_i in s:
                buf += s_i.to_bytes_le()
            buf += r.to_bytes_le()
        sub_sel = _indices_to_hide(
            hashlib.blake2b(bytes(buf), digest_size=64).digest(),
            subset_size, num_hidden)
        subset = [hidden_sorted[i] for i in sub_sel]
        lag_opened = lagrange_basis_at_0_for_all(opened_ids)
        cts_by_idx = dict(self.ciphertexts)
        shares_by_idx = {i: s for i, s, _ in self.shares_and_enc_rands}
        wc = len(next(iter(shares_by_idx.values())))
        out_cts, out_lags = [], []
        for h in subset:
            party_id = h + 1
            l_h = lagrange_basis_at_0(opened_ids + [party_id], party_id)
            # deltas: contribution of opened shares interpolated at 0,
            # adjusted for the hidden party's membership in the basis
            p = F(party_id)
            deltas = []
            for j, o in enumerate(opened_ids):
                deltas.append(lag_opened[j] * p * (p - F(o)).inverse())
            offset = []
            for w_i in range(wc):
                acc = F(0)
                for j, o in enumerate(opened_ids):
                    acc = acc + deltas[j] * shares_by_idx[o - 1][w_i]
                offset.append(acc)
            ct = _ct_add(_ct_multiply(cts_by_idx[h], l_h), offset)
            out_cts.append(ct)
            out_lags.append(l_h)
        return RdkgithCompressed(cts=out_cts, lagrange=out_lags)


@dataclass
class RdkgithCompressed:
    cts: list
    lagrange: list

    def decrypt(self, sk: ElgamalSecretKey, commitment: Point,
                comm_key: list) -> list:
        """Try each compressed ciphertext; return witnesses matching the
        commitment."""
        for ct, l in zip(self.cts, self.lagrange):
            wits = _ct_decrypt_after_multiplying_otp(ct, l, sk)
            if msm(comm_key, wits).normalize() == commitment.normalize():
                return wits
        raise VerEncError("no compressed ciphertext decrypted correctly")
