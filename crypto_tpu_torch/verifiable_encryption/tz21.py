"""TZ21 verifiable encryption from MPC-in-the-head, DKG-in-the-head
(Protocol 4 of paper 2021/1704; reference
`verifiable_encryption/src/tz_21/{dkgith,seed_tree,encryption}.rs`): the
port's own copy of `crypto_tpu/verifiable_encryption/tz21.py`.

Encrypts the openings (x_1..x_k) of a generalized Pedersen commitment
Y = sum G_i * x_i under a batched hashed-ElGamal public key, with a proof
that the ciphertext encrypts exactly the committed values.

Per repetition:
  * a GGM seed tree expands one root into N party seeds
  * party j's share of witness i and its ElGamal randomness derive from its
    seed; a per-witness delta fixes party 0's share so shares sum to x_i
  * commitments C_j = sum G_i * s_{i,j}; ciphertexts are batched ElGamal
  * Fiat-Shamir picks one party per repetition to HIDE; the proof reveals
    the seed-tree opening for all other leaves + the hidden party's
    ciphertext (its commitment is implied: C_hidden = Y - sum C_revealed)
  * ciphertext compression: for a challenge-chosen subset of repetitions,
    revealed shares are summed into the hidden party's ciphertext,
    homomorphically producing an encryption of the witnesses themselves.

The group work of one `new` or `verify` is (k + 2) fixed-base products a
party instance: the k commitment terms, pk.y * r and g * r.  From
`DEVICE_FIXED_BASE_THRESHOLD` products on they go to the device in one
batch (`_party_products`): a cached `ops/fixed_base.py` table a base,
`mul_many` a base, the commitment terms summed by `TCurve.add`, one
`to_affine`; below it, host `msm` and `mul_raw` as the reference does.
`device` is CUDA unless the caller names the CPU and raises without a
card.

Randomness: the reference draws the salt and the root seeds from
`os.urandom` and ignores its `rng`.  Here they come from the caller's
`rng` (`rng.randbytes`); the same bytes give the reference's proof byte
for byte.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tcurve import TPoints
from ..fields.host import Fp
from ..ops.fixed_base import table_for
from ..serialize import serialize_point
from ..utils.elgamal import (ElgamalPublicKey, ElgamalSecretKey,
                             _hash_shared_secret)
from ..utils.msm import DEVICE_FIXED_BASE_THRESHOLD, msm

F = bls.Fr

SEED_SIZE = 16
SALT_SIZE = 32


# ---------------------------------------------------------------------------
# GGM seed tree (`seed_tree.rs`)
# ---------------------------------------------------------------------------

def _expand(seed: bytes, salt: bytes, rep: int, node: int) -> bytes:
    return hashlib.shake_256(
        b"seed-tree" + salt + rep.to_bytes(4, "little")
        + node.to_bytes(4, "little") + seed).digest(2 * SEED_SIZE)


class SeedTree:
    """Full binary tree with num_leaves (power of 2) leaves; node 0 = root."""

    def __init__(self, nodes: list, num_leaves: int):
        self.nodes = nodes
        self.num_leaves = num_leaves

    @classmethod
    def create(cls, root_seed: bytes, salt: bytes, rep: int,
               num_leaves: int) -> "SeedTree":
        total = 2 * num_leaves - 1
        nodes = [b""] * total
        nodes[0] = root_seed
        for i in range(num_leaves - 1):
            both = _expand(nodes[i], salt, rep, i)
            nodes[2 * i + 1] = both[:SEED_SIZE]
            nodes[2 * i + 2] = both[SEED_SIZE:]
        return cls(nodes, num_leaves)

    def leaf(self, j: int) -> bytes:
        return self.nodes[self.num_leaves - 1 + j]

    def open_all_but(self, hidden: int) -> list:
        """Sibling path covering every leaf except `hidden`."""
        path = []
        idx = self.num_leaves - 1 + hidden
        while idx > 0:
            sibling = idx + 1 if idx % 2 == 1 else idx - 1
            path.append(self.nodes[sibling])
            idx = (idx - 1) // 2
        return path

    @classmethod
    def reconstruct_leaves(cls, opening: list, hidden: int, salt: bytes,
                           rep: int, num_leaves: int) -> dict:
        """{leaf_index: seed} for all leaves except `hidden`."""
        total = 2 * num_leaves - 1
        nodes = [None] * total
        idx = num_leaves - 1 + hidden
        for sib_seed in opening:
            sibling = idx + 1 if idx % 2 == 1 else idx - 1
            nodes[sibling] = sib_seed
            idx = (idx - 1) // 2
        for i in range(num_leaves - 1):
            if nodes[i] is not None:
                both = _expand(nodes[i], salt, rep, i)
                nodes[2 * i + 1] = both[:SEED_SIZE]
                nodes[2 * i + 2] = both[SEED_SIZE:]
        out = {}
        for j in range(num_leaves):
            if j != hidden and nodes[num_leaves - 1 + j] is not None:
                out[j] = nodes[num_leaves - 1 + j]
        return out


# ---------------------------------------------------------------------------
# share / randomness derivation
# ---------------------------------------------------------------------------

def _share_from_seed(seed: bytes, wit_idx: int) -> Fp:
    d = hashlib.shake_256(b"tz21-share" + seed
                          + wit_idx.to_bytes(4, "little")).digest(64)
    return F(int.from_bytes(d, "little") % F.p)


def _eph_from_seed(seed: bytes) -> Fp:
    d = hashlib.shake_256(b"tz21-eph" + seed).digest(64)
    return F(int.from_bytes(d, "little") % F.p)


@dataclass
class BatchCt:
    """Batched hashed ElGamal: one ephemeral key, OTP per message index."""
    eph: Point
    cts: list  # [Fp]

    @classmethod
    def encrypt(cls, shares, eph_r: Fp, pk: ElgamalPublicKey, g: Point):
        return cls.from_products(shares, pk.y * int(eph_r),
                                 (g * int(eph_r)).normalize())

    @classmethod
    def from_products(cls, shares, shared: Point, eph: Point):
        """The ciphertext of `shares` given the products shared = pk.y * r
        and eph = g * r."""
        cts = [s + _hash_shared_secret(shared, i.to_bytes(4, "little"))
               for i, s in enumerate(shares)]
        return cls(eph=eph, cts=cts)

    def decrypt(self, sk: ElgamalSecretKey):
        shared = self.eph * int(sk.x)
        return [c - _hash_shared_secret(shared, i.to_bytes(4, "little"))
                for i, c in enumerate(self.cts)]


def _party_products(gens, shares, ephs, enc_pk: ElgamalPublicKey,
                    enc_g: Point, device) -> tuple:
    """For party instances i: (commitments sum_b gens[b] * shares[i][b],
    shared secrets enc_pk.y * ephs[i], ephemeral keys enc_g * ephs[i]), as
    host points with Z = 1.  On `device` in one batch from
    `DEVICE_FIXED_BASE_THRESHOLD` products on, else on the host."""
    dev = resolve_device(device)
    n = len(ephs)
    if n * (len(gens) + 2) < DEVICE_FIXED_BASE_THRESHOLD:
        return ([msm(gens, sh).normalize() for sh in shares],
                [(enc_pk.y * int(r)).normalize() for r in ephs],
                [(enc_g * int(r)).normalize() for r in ephs])
    tables = [table_for(bls.G1, b, device=dev)
              for b in list(gens) + [enc_pk.y, enc_g]]
    tc = tables[0].tc
    comm = None
    for b, table in enumerate(tables[:len(gens)]):
        term = table.mul_many([int(sh[b]) for sh in shares])
        comm = term if comm is None else tc.add(comm, term)
    rs = [int(r) for r in ephs]
    shared = tables[-2].mul_many(rs)
    eph = tables[-1].mul_many(rs)
    pts = tc.unpack_affine(TPoints(*(torch.cat(parts, dim=-1)
                                     for parts in zip(comm, shared, eph))))
    return pts[:n], pts[n:2 * n], pts[2 * n:]


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def _hidden_indices(challenge: bytes, reps: int, n_parties: int) -> list:
    out = []
    stream = hashlib.shake_256(b"tz21-hide" + challenge).digest(4 * reps)
    for r in range(reps):
        out.append(int.from_bytes(stream[4 * r:4 * r + 4], "little") % n_parties)
    return out


def _subset_indices(challenge: bytes, reps: int, subset: int) -> list:
    order = list(range(reps))
    stream = hashlib.shake_256(b"tz21-subset" + challenge).digest(4 * reps)
    order.sort(key=lambda r: stream[4 * r:4 * r + 4])
    return sorted(order[:subset])


@dataclass
class DkgithProof:
    salt: bytes
    challenge: bytes
    deltas: list           # [rep][wit] Fp
    openings: list         # [rep] tree opening
    hidden_cts: list       # [rep] BatchCt
    n_parties: int
    reps: int

    @classmethod
    def new(cls, rng, witnesses, Y: Point, gens, enc_pk: ElgamalPublicKey,
            enc_g: Point, n_parties: int = 8, reps: int = 16,
            device="cuda"):
        """The proof that `enc_pk` encrypts the opening `witnesses` of
        Y = msm(gens, witnesses).  The salt and the root seeds come from
        `rng.randbytes`; the party products run on `device` (see the
        module docstring)."""
        k = len(witnesses)
        salt = rng.randbytes(SALT_SIZE)
        trees, all_deltas, all_shares, all_ephs = [], [], [], []
        for rep in range(reps):
            tree = SeedTree.create(rng.randbytes(SEED_SIZE), salt, rep,
                                   n_parties)
            trees.append(tree)
            shares = [[_share_from_seed(tree.leaf(j), i)
                       for i in range(k)] for j in range(n_parties)]
            deltas = []
            for i in range(k):
                total = F(0)
                for j in range(n_parties):
                    total = total + shares[j][i]
                deltas.append(witnesses[i] - total)
            # effective share of party 0 includes delta
            shares[0] = [shares[0][i] + deltas[i] for i in range(k)]
            all_deltas.append(deltas)
            all_shares.extend(shares)
            all_ephs.extend(_eph_from_seed(tree.leaf(j))
                            for j in range(n_parties))
        comms, shared, ephs = _party_products(gens, all_shares, all_ephs,
                                              enc_pk, enc_g, device)
        flat_cts = [BatchCt.from_products(sh, s, e)
                    for sh, s, e in zip(all_shares, shared, ephs)]
        all_comms = [comms[r * n_parties:(r + 1) * n_parties]
                     for r in range(reps)]
        all_cts = [flat_cts[r * n_parties:(r + 1) * n_parties]
                   for r in range(reps)]

        challenge = cls._transcript_challenge(salt, Y, all_comms, all_cts)
        hidden = _hidden_indices(challenge, reps, n_parties)
        openings = [trees[r].open_all_but(hidden[r]) for r in range(reps)]
        hidden_cts = [all_cts[r][hidden[r]] for r in range(reps)]
        return cls(salt=salt, challenge=challenge, deltas=all_deltas,
                   openings=openings, hidden_cts=hidden_cts,
                   n_parties=n_parties, reps=reps)

    @staticmethod
    def _transcript_challenge(salt, Y, all_comms, all_cts) -> bytes:
        h = hashlib.shake_256()
        h.update(b"tz21-dkgith")
        h.update(salt)
        h.update(serialize_point(Y))
        for comms in all_comms:
            for c in comms:
                h.update(serialize_point(c))
        for cts in all_cts:
            for ct in cts:
                h.update(serialize_point(ct.eph))
                for c in ct.cts:
                    h.update(c.to_bytes_le())
        return h.digest(32)

    def verify(self, Y: Point, gens, enc_pk: ElgamalPublicKey,
               enc_g: Point, device="cuda") -> bool:
        """Whether the proof holds for Y = msm(gens, .) under `enc_pk`, at
        the proof's own `n_parties` and `reps`: a caller that fixes these
        numbers checks them first (`VerifiableEncryptionTZ21`)."""
        k = len(gens)
        hidden = _hidden_indices(self.challenge, self.reps, self.n_parties)
        revealed, shares, ephs = [], [], []
        for rep in range(self.reps):
            leaves = SeedTree.reconstruct_leaves(
                self.openings[rep], hidden[rep], self.salt, rep,
                self.n_parties)
            if len(leaves) != self.n_parties - 1:
                return False
            for j, seed in leaves.items():
                sh = [_share_from_seed(seed, i) for i in range(k)]
                if j == 0:
                    sh = [sh[i] + self.deltas[rep][i] for i in range(k)]
                revealed.append((rep, j))
                shares.append(sh)
                ephs.append(_eph_from_seed(seed))
        comms, shared, eph_pts = _party_products(gens, shares, ephs, enc_pk,
                                                 enc_g, device)
        all_comms = [[None] * self.n_parties for _ in range(self.reps)]
        all_cts = [[None] * self.n_parties for _ in range(self.reps)]
        for (rep, j), c, sh, s, e in zip(revealed, comms, shares, shared,
                                         eph_pts):
            all_comms[rep][j] = c
            all_cts[rep][j] = BatchCt.from_products(sh, s, e)
        for rep in range(self.reps):
            # the hidden party's commitment is implied by Y
            acc = bls.G1.infinity()
            for c in all_comms[rep]:
                if c is not None:
                    acc = acc + c
            all_comms[rep][hidden[rep]] = (Y - acc).normalize()
            all_cts[rep][hidden[rep]] = self.hidden_cts[rep]
        expect = self._transcript_challenge(self.salt, Y, all_comms, all_cts)
        return expect == self.challenge

    def compress(self, subset_size: int = 4) -> "CompressedCiphertext":
        """Homomorphically fold revealed shares into the hidden ciphertexts
        for a challenge-chosen subset of repetitions."""
        k = len(self.deltas[0])
        hidden = _hidden_indices(self.challenge, self.reps, self.n_parties)
        subset = _subset_indices(self.challenge, self.reps, subset_size)
        out = []
        for rep in subset:
            leaves = SeedTree.reconstruct_leaves(
                self.openings[rep], hidden[rep], self.salt, rep,
                self.n_parties)
            sums = [F(0)] * k
            for j, seed in leaves.items():
                for i in range(k):
                    s = _share_from_seed(seed, i)
                    if j == 0:
                        s = s + self.deltas[rep][i]
                    sums[i] = sums[i] + s
            ct = self.hidden_cts[rep]
            out.append(BatchCt(eph=ct.eph,
                               cts=[ct.cts[i] + sums[i] for i in range(k)]))
        return CompressedCiphertext(cts=out, subset=subset)


@dataclass
class CompressedCiphertext:
    cts: list
    subset: list

    def decrypt(self, sk: ElgamalSecretKey, Y: Point, gens) -> list:
        """Decrypt candidates; return the witnesses matching Y."""
        for ct in self.cts:
            cand = ct.decrypt(sk)
            if msm(gens, cand) == Y:
                return cand
        raise ValueError("no repetition decrypted to the committed opening")
