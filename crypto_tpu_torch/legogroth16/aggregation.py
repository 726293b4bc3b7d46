"""SnarkPack proof aggregation for Groth16-shaped and LegoGroth16 proofs
(reference `legogroth16/src/aggregation/`, from eprint 2021/529): the
port's copy of `crypto_tpu/legogroth16/aggregation.py`.

n = 2^k proofs collapse to one O(log n)-sized aggregate:
  - commit to the (A_i) / (B_i) vectors with the structured pair commitment
    T = prod e(A_i, v_a_i) * e(w_a_i, B_i), U = ... (key.rs/commitment.rs)
  - draw r, form z_ab = prod e(A_i, B_i^{r^i}) (the aggregated Groth16
    LHS), z_c = sum r^i C_i, and for Lego proofs z_d = sum r^i D_i
  - GIPA/TIPP-MIPP: log n halving rounds, each committing to the cross
    inner products, folding vectors by the round challenge, and folding
    the commitment keys by its inverse
  - two KZG openings prove the final (folded) v/w commitment keys are
    consistent with the structured SRS (kzg.rs)
  - final: one randomized multi-pairing check ties everything to the
    Groth16 equation  z_ab = e(alpha,beta)^{sum r^i} *
    e(agg_inputs, gamma) * e(z_d, gamma) * e(z_c, delta).

GT elements are multiplicative here (Fq12), so the reference's additive
PairingOutput ops map: add -> mul, mul_bigint -> pow, zero -> one.

On the port the prover's pairing products go through
`curves/tpairing.py` `multi_pairings_routed`, gathered into as few calls
as the transcript allows: the first commitments (com_ab, com_c, com_d:
up to six products) in one call, z_ab in a call of its own (it takes the
challenge r, which the commitments fix), and each GIPA round's products
(tab_l, tab_r, zab_l, zab_r, tuc_*, tud_*: up to 14) in one call before
any of them is appended; the router sends each call to the device or the
host by its pairs and products (`pairing_route`).  The MSMs (z_c,
z_d, the round folds, the KZG openings) take `msm_device_scheduled`
from `utils/msm.py`'s `DEVICE_MSM_THRESHOLD` points on (as
`bbs_plus/batch.py`'s do), the host MSM below it.  The verifier feeds the
port's `RandomizedPairingChecker` (its Miller product on the device from
8 deferred pairs), as the reference's does.  The transcript, the
challenges and every element of the `AggregateProof` are the
reference's.  The prover and the verifiers run on `device`, CUDA unless
the caller names the CPU, and raise without a card; `timings=` (a dict)
collects the prover's pairing and MSM seconds and its pairing calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed, pairing_route
from ..fields.host import Fp
from ..ops.msm_v2 import msm_device_scheduled
from ..transcript.transcript import Transcript
from ..utils.checkers import RandomizedPairingChecker
from ..utils.ff import powers
from ..utils.msm import DEVICE_MSM_THRESHOLD, msm

F = bls.Fr
MAX_SRS_SIZE = (2 << 19) + 1


class AggregationError(Exception):
    pass


def _gt_one():
    return bls.Fq12.one()


class _Work:
    """Where a prover's device work goes: its device, and the seconds of
    its pairing calls and MSMs (`timings`, when the caller passes a
    dict)."""

    def __init__(self, device, timings=None):
        self.device = resolve_device(device)
        self.timings = timings
        if timings is not None:
            timings.setdefault("pairing_s", 0.0)
            timings.setdefault("msm_s", 0.0)
            timings.setdefault("pairing_calls", [])

    def _spent(self, key, t0):
        if self.timings is not None:
            self.timings[key] += time.perf_counter() - t0

    def products(self, groups) -> list:
        """The pairing product of each list of pairs, in one routed call."""
        t0 = time.perf_counter()
        out = multi_pairings_routed(groups, self.device)
        self._spent("pairing_s", t0)
        if self.timings is not None:
            n = sum(map(len, groups))
            self.timings["pairing_calls"].append(
                (len(groups), n, pairing_route(n, len(groups))))
        return out

    def msm(self, points, scalars) -> Point:
        """A normalized MSM: on the device from `DEVICE_MSM_THRESHOLD`
        points on, else on the host."""
        t0 = time.perf_counter()
        if len(points) >= DEVICE_MSM_THRESHOLD:
            out = msm_device_scheduled(
                points[0].curve, [p.normalize() for p in points],
                [int(s) for s in scalars], device=self.device)
        else:
            out = msm(points, scalars)
        self._spent("msm_s", t0)
        return out.normalize()


def _single_groups(vkey, a_vec) -> list:
    """The two products of `PairCommitment.single`."""
    if len(vkey.a) < len(a_vec):
        raise AggregationError("insufficient key length")
    return [list(zip(a_vec, vkey.a)), list(zip(a_vec, vkey.b))]


def _double_groups(vkey, wkey, a, b) -> list:
    """The two products of `PairCommitment.double`."""
    nb = len(b)
    return [list(zip(a, vkey.a)) + list(zip(wkey.a[:nb], b)),
            list(zip(a, vkey.b)) + list(zip(wkey.b[:nb], b))]


# ---------------------------------------------------------------------------
# commitment keys (key.rs) and pair commitments (commitment.rs)
# ---------------------------------------------------------------------------

@dataclass
class Key:
    """(a_vec, b_vec) of group elements; vkey lives in G2, wkey in G1."""
    a: list
    b: list

    def __len__(self):
        return len(self.a)

    def has_correct_len(self, n):
        return len(self.a) == n and len(self.b) == n

    def scale(self, s_vec):
        if len(self.a) != len(s_vec):
            raise AggregationError("invalid key length")
        return Key(a=[(p * int(s)).normalize()
                      for p, s in zip(self.a, s_vec)],
                   b=[(p * int(s)).normalize()
                      for p, s in zip(self.b, s_vec)])

    def split(self, at):
        return (Key(a=self.a[:at], b=self.b[:at]),
                Key(a=self.a[at:], b=self.b[at:]))

    def compress(self, right, scale: Fp):
        s = int(scale)
        return Key(
            a=[(l + r * s).normalize() for l, r in zip(self.a, right.a)],
            b=[(l + r * s).normalize() for l, r in zip(self.b, right.b)])

    def first(self):
        return (self.a[0], self.b[0])


@dataclass
class PairCommitment:
    t: object              # Fq12
    u: object

    @classmethod
    def single(cls, vkey: Key, a_vec, device="cuda"):
        return cls(*multi_pairings_routed(_single_groups(vkey, a_vec),
                                          device))

    @classmethod
    def double(cls, vkey: Key, wkey: Key, a, b, device="cuda"):
        return cls(*multi_pairings_routed(_double_groups(vkey, wkey, a, b),
                                          device))

    def to_bytes_le(self):
        return self.t.to_bytes_le() + self.u.to_bytes_le()

    def __eq__(self, o):
        return self.t == o.t and self.u == o.u


# ---------------------------------------------------------------------------
# SRS (srs.rs)
# ---------------------------------------------------------------------------

@dataclass
class GenericSRS:
    g_alpha_powers: list   # G1, len 2n
    h_alpha_powers: list   # G2
    g_beta_powers: list
    h_beta_powers: list

    @classmethod
    def setup(cls, rng, size: int):
        """Transparent-trapdoor test setup (the reference's `setup_fake_srs`);
        production deployments load a ceremony transcript instead."""
        alpha, beta = F.rand(rng), F.rand(rng)
        g = bls.G1.generator()
        h = bls.G2.generator()
        ap = powers(alpha, 2 * size)
        bp = powers(beta, 2 * size)
        return cls(
            g_alpha_powers=[(g * int(p)).normalize() for p in ap],
            h_alpha_powers=[(h * int(p)).normalize() for p in ap],
            g_beta_powers=[(g * int(p)).normalize() for p in bp],
            h_beta_powers=[(h * int(p)).normalize() for p in bp])

    def specialize(self, num_proofs: int):
        if num_proofs & (num_proofs - 1):
            raise AggregationError("num_proofs must be a power of two")
        n = num_proofs
        tn = 2 * n
        assert len(self.g_alpha_powers) >= tn
        vkey = Key(a=self.h_alpha_powers[:n], b=self.h_beta_powers[:n])
        wkey = Key(a=self.g_alpha_powers[n:tn], b=self.g_beta_powers[n:tn])
        pk = ProverSRS(
            n=n,
            g_alpha_powers_table=self.g_alpha_powers[:tn],
            g_beta_powers_table=self.g_beta_powers[:tn],
            h_alpha_powers_table=self.h_alpha_powers[:n],
            h_beta_powers_table=self.h_beta_powers[:n],
            vkey=vkey, wkey=wkey)
        vk = VerifierSRS(
            n=n, g=self.g_alpha_powers[0], h=self.h_alpha_powers[0],
            g_alpha=self.g_alpha_powers[1], g_beta=self.g_beta_powers[1],
            h_alpha=self.h_alpha_powers[1], h_beta=self.h_beta_powers[1])
        return pk, vk


@dataclass
class ProverSRS:
    n: int
    g_alpha_powers_table: list
    h_alpha_powers_table: list
    g_beta_powers_table: list
    h_beta_powers_table: list
    vkey: Key
    wkey: Key

    def has_correct_len(self, n):
        return self.vkey.has_correct_len(n) and self.wkey.has_correct_len(n)


@dataclass
class VerifierSRS:
    n: int
    g: Point
    h: Point
    g_alpha: Point
    g_beta: Point
    h_alpha: Point
    h_beta: Point


# ---------------------------------------------------------------------------
# KZG openings of the folded commitment keys (kzg.rs)
# ---------------------------------------------------------------------------

@dataclass
class KZGOpening:
    p0: Point
    p1: Point


def polynomial_evaluation_product_form(transcript, z: Fp, r_shift: Fp) -> Fp:
    """prod_i (1 + c_i * (z*r)^{2^i})."""
    power_zr = z * r_shift
    res = F(1) + transcript[0] * power_zr
    for x in transcript[1:]:
        power_zr = power_zr * power_zr
        res = res * (F(1) + x * power_zr)
    return res


def polynomial_coefficients_from_transcript(transcript, r_shift: Fp):
    coefficients = [F(1)]
    power_2_r = r_shift
    for i, x in enumerate(transcript):
        if i > 0:
            power_2_r = power_2_r * power_2_r
        coefficients += [c * (x * power_2_r) for c in list(coefficients)]
    return coefficients


def _poly_divide_by_linear(coeffs, z: Fp):
    """f(X) / (X - z) quotient via synthetic division (low-first coeffs);
    callers pre-subtract f(z) so the remainder vanishes."""
    n = len(coeffs)
    q = [F(0)] * (n - 1)
    q[n - 2] = coeffs[n - 1]
    for i in range(n - 2, 0, -1):
        q[i - 1] = coeffs[i] + z * q[i]
    return q


def _create_kzg_opening(alpha_table, beta_table, poly_coeffs, eval_val: Fp,
                        z: Fp, work: _Work) -> KZGOpening:
    if len(poly_coeffs) != len(alpha_table):
        raise AggregationError("SRS/polynomial length mismatch")
    f = list(poly_coeffs)
    f[0] = f[0] - eval_val
    q = _poly_divide_by_linear(f, z)
    q = q + [F(0)] * (len(alpha_table) - len(q))
    return KZGOpening(p0=work.msm(alpha_table, q[:len(alpha_table)]),
                      p1=work.msm(beta_table, q[:len(beta_table)]))


def prove_commitment_v(h_alpha_table, h_beta_table, challenges_inv, z: Fp,
                       device="cuda", work: _Work = None):
    work = work or _Work(device)
    coeffs = polynomial_coefficients_from_transcript(challenges_inv, F(1))
    ev = polynomial_evaluation_product_form(challenges_inv, z, F(1))
    return _create_kzg_opening(h_alpha_table, h_beta_table, coeffs, ev, z,
                               work)


def prove_commitment_w(g_alpha_table, g_beta_table, challenges, r_shift: Fp,
                       z: Fp, device="cuda", work: _Work = None):
    work = work or _Work(device)
    n = len(g_alpha_table) // 2
    fcoeffs = polynomial_coefficients_from_transcript(challenges, r_shift)
    fw = [F(0)] * len(fcoeffs) + fcoeffs
    ev = polynomial_evaluation_product_form(challenges, z, r_shift)
    fwz = ev * (z ** n)
    return _create_kzg_opening(g_alpha_table, g_beta_table, fw, fwz, z,
                               work)


def verify_kzg_v(v_srs: VerifierSRS, final_vkey, vkey_opening: KZGOpening,
                 challenges, z: Fp, checker: RandomizedPairingChecker):
    y = polynomial_evaluation_product_form(challenges, z, F(1))
    ng = (-v_srs.g).normalize()
    for cf, vk, pi in ((final_vkey[0], v_srs.g_alpha, vkey_opening.p0),
                       (final_vkey[1], v_srs.g_beta, vkey_opening.p1)):
        b = (cf - v_srs.h * int(y)).normalize()
        c = (vk - v_srs.g * int(z)).normalize()
        checker.add_multiple_sources_and_target([ng, c], [b, pi], _gt_one())


def verify_kzg_w(v_srs: VerifierSRS, final_wkey, wkey_opening: KZGOpening,
                 challenges, r_shift: Fp, z: Fp,
                 checker: RandomizedPairingChecker):
    fz = polynomial_evaluation_product_form(challenges, z, r_shift)
    fwz = fz * (z ** v_srs.n)
    nh = (-v_srs.h).normalize()
    for cf, wk, pi in ((final_wkey[0], v_srs.h_alpha, wkey_opening.p0),
                       (final_wkey[1], v_srs.h_beta, wkey_opening.p1)):
        a = (cf - v_srs.g * int(fwz)).normalize()
        d = (wk - v_srs.h * int(z)).normalize()
        checker.add_multiple_sources_and_target([a, pi], [nh, d], _gt_one())


# ---------------------------------------------------------------------------
# proof structures
# ---------------------------------------------------------------------------

@dataclass
class GipaProof:
    nproofs: int
    comms_ab: list         # [(PairCommitment, PairCommitment)]
    comms_c: list
    comms_d: list          # empty for plain Groth16 aggregation
    z_ab: list             # [(Fq12, Fq12)]
    z_c: list              # [(Point, Point)]
    z_d: list
    final_a: Point
    final_b: Point
    final_c: Point
    final_d: Point         # None for plain aggregation
    final_vkey: tuple
    final_wkey: tuple


@dataclass
class AggregateProof:
    com_ab: PairCommitment
    com_c: PairCommitment
    com_d: PairCommitment  # None for plain aggregation
    z_ab: object
    z_c: Point
    z_d: Point
    gipa: GipaProof
    vkey_opening: KZGOpening
    wkey_opening: KZGOpening

    def parsing_check(self):
        n = self.gipa.nproofs
        if n < 2 or n > MAX_SRS_SIZE or n & (n - 1):
            raise AggregationError("bad proof count")
        log_n = n.bit_length() - 1
        ok = (len(self.gipa.comms_ab) == log_n
              and len(self.gipa.comms_c) == log_n
              and len(self.gipa.z_ab) == log_n
              and len(self.gipa.z_c) == log_n)
        if self.com_d is not None:
            ok = ok and len(self.gipa.comms_d) == log_n \
                and len(self.gipa.z_d) == log_n
        if not ok:
            raise AggregationError("proof vectors unequal sizes")


# ---------------------------------------------------------------------------
# prover (groth16/prover.rs + legogroth16/prover.rs, unified via d=None)
# ---------------------------------------------------------------------------

def aggregate_proofs(srs: ProverSRS, transcript: Transcript,
                     proofs: list, device="cuda",
                     timings: dict = None) -> AggregateProof:
    """proofs: list of objects with .a/.b/.c (and .d for LegoGroth16)."""
    work = _Work(device, timings)
    n = len(proofs)
    if n < 2 or n & (n - 1):
        raise AggregationError("need a power-of-two number of proofs >= 2")
    if not srs.has_correct_len(n):
        raise AggregationError("SRS length != number of proofs")
    a = [p.a for p in proofs]
    b = [p.b for p in proofs]
    c = [p.c for p in proofs]
    with_d = hasattr(proofs[0], "d") and proofs[0].d is not None
    d = [p.d for p in proofs] if with_d else None

    groups = _double_groups(srs.vkey, srs.wkey, a, b) \
        + _single_groups(srs.vkey, c)
    if with_d:
        groups += _single_groups(srs.vkey, d)
    gts = work.products(groups)
    com_ab = PairCommitment(*gts[0:2])
    com_c = PairCommitment(*gts[2:4])
    com_d = PairCommitment(*gts[4:6]) if with_d else None
    transcript.append(b"AB-commitment", com_ab)
    transcript.append(b"C-commitment", com_c)
    if with_d:
        transcript.append(b"D-commitment", com_d)
    r = transcript.challenge_scalar(F, b"r-random-fiatshamir")
    r_vec = powers(r, n)
    r_inv = [x.inverse() for x in r_vec]

    b_r = [(bi * int(ri)).normalize() for bi, ri in zip(b, r_vec)]
    z_ab = work.products([list(zip(a, b_r))])[0]
    z_c = work.msm(c, r_vec)
    z_d = work.msm(d, r_vec) if with_d else None
    wkey_r_inv = srs.wkey.scale(r_inv)

    gipa, challenges, challenges_inv = _gipa_tipp_mipp(
        transcript, a, b_r, c, d, srs.vkey, wkey_r_inv, r_vec, z_ab, z_c,
        z_d, work)
    challenges.reverse()
    challenges_inv.reverse()
    r_inverse = r_vec[1].inverse()
    transcript.append(b"kzg-challenge", challenges[0])
    transcript.append(b"vkey0", gipa.final_vkey[0])
    transcript.append(b"vkey1", gipa.final_vkey[1])
    transcript.append(b"wkey0", gipa.final_wkey[0])
    transcript.append(b"wkey1", gipa.final_wkey[1])
    z = transcript.challenge_scalar(F, b"z-challenge")
    vkey_opening = prove_commitment_v(
        srs.h_alpha_powers_table, srs.h_beta_powers_table, challenges_inv, z,
        work=work)
    wkey_opening = prove_commitment_w(
        srs.g_alpha_powers_table, srs.g_beta_powers_table, challenges,
        r_inverse, z, work=work)
    return AggregateProof(com_ab=com_ab, com_c=com_c, com_d=com_d,
                          z_ab=z_ab, z_c=z_c, z_d=z_d, gipa=gipa,
                          vkey_opening=vkey_opening,
                          wkey_opening=wkey_opening)


def _gipa_tipp_mipp(transcript, a, b, c, d, vkey, wkey, r, ip_ab, agg_c,
                    agg_d, work: _Work):
    m_a, m_b, m_c, m_r = list(a), list(b), list(c), list(r)
    m_d = list(d) if d is not None else None
    comms_ab, comms_c, comms_d = [], [], []
    z_ab, z_c, z_d = [], [], []
    challenges, challenges_inv = [], []
    transcript.append(b"inner-product-ab", ip_ab)
    transcript.append(b"comm-c", agg_c)
    if m_d is not None:
        transcript.append(b"comm-d", agg_d)
    c_inv = transcript.challenge_scalar(F, b"first-challenge")
    c_chal = c_inv.inverse()
    i = 0
    while len(m_a) > 1:
        split = len(m_a) // 2
        a_l, a_r = m_a[:split], m_a[split:]
        b_l, b_r = m_b[:split], m_b[split:]
        c_l, c_r = m_c[:split], m_c[split:]
        r_l, r_r = m_r[:split], m_r[split:]
        vk_l, vk_r = vkey.split(split)
        wk_l, wk_r = wkey.split(split)

        # the round's products, in one call: tab_l, tab_r, zab_l, zab_r,
        # tuc_l, tuc_r (and tud_l, tud_r)
        groups = _double_groups(vk_l, wk_r, a_r, b_l) \
            + _double_groups(vk_r, wk_l, a_l, b_r) \
            + [list(zip(a_r, b_l)), list(zip(a_l, b_r))] \
            + _single_groups(vk_l, c_r) + _single_groups(vk_r, c_l)
        if m_d is not None:
            d_l, d_r = m_d[:split], m_d[split:]
            groups += _single_groups(vk_l, d_r) + _single_groups(vk_r, d_l)
        gts = work.products(groups)
        tab_l, tab_r = PairCommitment(*gts[0:2]), PairCommitment(*gts[2:4])
        zab_l, zab_r = gts[4:6]
        tuc_l, tuc_r = PairCommitment(*gts[6:8]), PairCommitment(*gts[8:10])
        zc_l = work.msm(c_r, r_l)
        zc_r = work.msm(c_l, r_r)
        if m_d is not None:
            tud_l = PairCommitment(*gts[10:12])
            tud_r = PairCommitment(*gts[12:14])
            zd_l = work.msm(d_r, r_l)
            zd_r = work.msm(d_l, r_r)

        if i > 0:
            transcript.append(b"c_inv", c_inv)
            transcript.append(b"zab_l", zab_l)
            transcript.append(b"zab_r", zab_r)
            transcript.append(b"zc_l", zc_l)
            transcript.append(b"zc_r", zc_r)
            if m_d is not None:
                transcript.append(b"zd_l", zd_l)
                transcript.append(b"zd_r", zd_r)
            transcript.append(b"tab_l", tab_l)
            transcript.append(b"tab_r", tab_r)
            transcript.append(b"tuc_l", tuc_l)
            transcript.append(b"tuc_r", tuc_r)
            if m_d is not None:
                transcript.append(b"tud_l", tud_l)
                transcript.append(b"tud_r", tud_r)
            c_inv = transcript.challenge_scalar(F, b"challenge_i")
            c_chal = c_inv.inverse()

        m_a = [(l + rr * int(c_chal)).normalize()
               for l, rr in zip(a_l, a_r)]
        m_b = [(l + rr * int(c_inv)).normalize()
               for l, rr in zip(b_l, b_r)]
        m_c = [(l + rr * int(c_chal)).normalize()
               for l, rr in zip(c_l, c_r)]
        m_r = [l + rr * c_inv for l, rr in zip(r_l, r_r)]
        if m_d is not None:
            m_d = [(l + rr * int(c_chal)).normalize()
                   for l, rr in zip(d_l, d_r)]
        vkey = vk_l.compress(vk_r, c_inv)
        wkey = wk_l.compress(wk_r, c_chal)
        comms_ab.append((tab_l, tab_r))
        comms_c.append((tuc_l, tuc_r))
        z_ab.append((zab_l, zab_r))
        z_c.append((zc_l, zc_r))
        if m_d is not None:
            comms_d.append((tud_l, tud_r))
            z_d.append((zd_l, zd_r))
        challenges.append(c_chal)
        challenges_inv.append(c_inv)
        i += 1

    return (GipaProof(
        nproofs=len(a), comms_ab=comms_ab, comms_c=comms_c, comms_d=comms_d,
        z_ab=z_ab, z_c=z_c, z_d=z_d, final_a=m_a[0], final_b=m_b[0],
        final_c=m_c[0], final_d=(m_d[0] if m_d is not None else None),
        final_vkey=vkey.first(), final_wkey=wkey.first()),
        challenges, challenges_inv)


# ---------------------------------------------------------------------------
# verifier (groth16/verifier.rs + legogroth16/verifier.rs)
# ---------------------------------------------------------------------------

def verify_aggregate_proof(v_srs: VerifierSRS, vk, public_inputs: list,
                           proof: AggregateProof, rng,
                           transcript: Transcript,
                           pairing_checker=None,
                           prepared_inputs: list = None,
                           device="cuda") -> bool:
    """vk: legogroth16 VerifyingKey.  public_inputs: per-proof input lists.
    For Lego proofs the committed-witness part is absorbed via z_d.
    `prepared_inputs`: per-proof PREPARED input points (already including
    gamma_abc[0]) instead of scalar inputs — the SAVER aggregation path,
    where the input is derived from the ciphertext
    (`saver_groth16.rs` verify_aggregate_proof)."""
    device = resolve_device(device)
    proof.parsing_check()
    if len(public_inputs) != proof.gipa.nproofs:
        raise AggregationError("public input count != proof count")
    transcript.append(b"AB-commitment", proof.com_ab)
    transcript.append(b"C-commitment", proof.com_c)
    if proof.com_d is not None:
        transcript.append(b"D-commitment", proof.com_d)
    r = transcript.challenge_scalar(F, b"r-random-fiatshamir")
    checker = pairing_checker or RandomizedPairingChecker(
        F.rand(rng), lazy=True, device=device)

    if not _verify_tipp_mipp(v_srs, proof, r, transcript, checker):
        return False

    n = proof.gipa.nproofs
    r_powers = powers(r, n)
    r_sum = F(0)
    for p in r_powers:
        r_sum = r_sum + p

    if prepared_inputs is not None:
        # each prepared_j already includes gamma_abc[0]; folding with the
        # r-powers therefore includes gamma_abc[0]*r_sum automatically
        agg_inputs = msm(prepared_inputs, r_powers).normalize()
    else:
        # aggregate public inputs: gamma_abc[0]*r_sum + sum_j
        # gamma_abc[1+i] * (sum_j r^j * input_j_i)
        num_inputs = len(public_inputs[0])
        summed = [r_sum]
        for i in range(num_inputs):
            acc = public_inputs[0][i]
            for j in range(1, n):
                acc = acc + public_inputs[j][i] * r_powers[j]
            summed.append(acc)
        agg_inputs = msm(vk.gamma_abc_g1[:num_inputs + 1],
                         summed).normalize()

    source1 = [(vk.alpha_g1 * int(r_sum)).normalize(), agg_inputs,
               proof.z_c]
    source2 = [vk.beta_g2, vk.gamma_g2, vk.delta_g2]
    if proof.z_d is not None:
        source1.append(proof.z_d)
        source2.append(vk.gamma_g2)
    checker.add_multiple_sources_and_target(source1, source2, proof.z_ab)
    return checker.verify()


def _verify_tipp_mipp(v_srs, proof, r_shift, transcript, checker) -> bool:
    final_res, final_r, challenges, challenges_inv = _gipa_verify(
        proof, r_shift, transcript)
    transcript.append(b"kzg-challenge", challenges[0])
    transcript.append(b"vkey0", proof.gipa.final_vkey[0])
    transcript.append(b"vkey1", proof.gipa.final_vkey[1])
    transcript.append(b"wkey0", proof.gipa.final_wkey[0])
    transcript.append(b"wkey1", proof.gipa.final_wkey[1])
    z = transcript.challenge_scalar(F, b"z-challenge")
    verify_kzg_v(v_srs, proof.gipa.final_vkey, proof.vkey_opening,
                 challenges_inv, z, checker)
    verify_kzg_w(v_srs, proof.gipa.final_wkey, proof.wkey_opening,
                 challenges, r_shift.inverse(), z, checker)

    g = proof.gipa
    checker.add_multiple_sources_and_target(
        [g.final_a], [g.final_b], final_res["zab"])
    checker.add_multiple_sources_and_target(
        [g.final_a, g.final_wkey[0]], [g.final_vkey[0], g.final_b],
        final_res["tab"])
    checker.add_multiple_sources_and_target(
        [g.final_a, g.final_wkey[1]], [g.final_vkey[1], g.final_b],
        final_res["uab"])
    checker.add_multiple_sources_and_target(
        [g.final_c], [g.final_vkey[0]], final_res["tc"])
    checker.add_multiple_sources_and_target(
        [g.final_c], [g.final_vkey[1]], final_res["uc"])
    if (g.final_c * int(final_r)).normalize() != final_res["zc"].normalize():
        return False
    if g.final_d is not None:
        checker.add_multiple_sources_and_target(
            [g.final_d], [g.final_vkey[0]], final_res["td"])
        checker.add_multiple_sources_and_target(
            [g.final_d], [g.final_vkey[1]], final_res["ud"])
        if (g.final_d * int(final_r)).normalize() != \
                final_res["zd"].normalize():
            return False
    return True


def _pow2(x, e: int, y, f: int):
    """x^e y^f (GT elements) by one shared square-and-multiply chain
    (Shamir's trick): the value of the reference's `x ** e * y ** f` at
    about two thirds of its host products."""
    xy = x * y
    acc = None
    for i in range(max(e.bit_length(), f.bit_length()) - 1, -1, -1):
        if acc is not None:
            acc = acc.square()
        m = (None, x, y, xy)[((e >> i) & 1) | (((f >> i) & 1) << 1)]
        if m is not None:
            acc = m if acc is None else acc * m
    return x.f.one() if acc is None else acc


def _gipa_verify(proof, r_shift, transcript):
    g = proof.gipa
    with_d = proof.com_d is not None
    challenges, challenges_inv = [], []
    transcript.append(b"inner-product-ab", proof.z_ab)
    transcript.append(b"comm-c", proof.z_c)
    if with_d:
        transcript.append(b"comm-d", proof.z_d)
    c_inv = transcript.challenge_scalar(F, b"first-challenge")
    c_chal = c_inv.inverse()
    for i in range(len(g.comms_ab)):
        if i > 0:
            zab_l, zab_r = g.z_ab[i]
            zc_l, zc_r = g.z_c[i]
            tab_l, tab_r = g.comms_ab[i]
            tuc_l, tuc_r = g.comms_c[i]
            transcript.append(b"c_inv", c_inv)
            transcript.append(b"zab_l", zab_l)
            transcript.append(b"zab_r", zab_r)
            transcript.append(b"zc_l", zc_l)
            transcript.append(b"zc_r", zc_r)
            if with_d:
                zd_l, zd_r = g.z_d[i]
                transcript.append(b"zd_l", zd_l)
                transcript.append(b"zd_r", zd_r)
            transcript.append(b"tab_l", tab_l)
            transcript.append(b"tab_r", tab_r)
            transcript.append(b"tuc_l", tuc_l)
            transcript.append(b"tuc_r", tuc_r)
            if with_d:
                tud_l, tud_r = g.comms_d[i]
                transcript.append(b"tud_l", tud_l)
                transcript.append(b"tud_r", tud_r)
            c_inv = transcript.challenge_scalar(F, b"challenge_i")
            c_chal = c_inv.inverse()
        challenges.append(c_chal)
        challenges_inv.append(c_inv)

    res = {
        "tab": proof.com_ab.t, "uab": proof.com_ab.u, "zab": proof.z_ab,
        "tc": proof.com_c.t, "uc": proof.com_c.u,
        "zc": proof.z_c,
    }
    if with_d:
        res["td"] = proof.com_d.t
        res["ud"] = proof.com_d.u
        res["zd"] = proof.z_d

    for i, (ch, ch_inv) in enumerate(zip(challenges, challenges_inv)):
        tab_l, tab_r = g.comms_ab[i]
        zab_l, zab_r = g.z_ab[i]
        tuc_l, tuc_r = g.comms_c[i]
        zc_l, zc_r = g.z_c[i]
        e, e_inv = int(ch), int(ch_inv)
        res["tab"] = res["tab"] * _pow2(tab_l.t, e, tab_r.t, e_inv)
        res["uab"] = res["uab"] * _pow2(tab_l.u, e, tab_r.u, e_inv)
        res["zab"] = res["zab"] * _pow2(zab_l, e, zab_r, e_inv)
        res["tc"] = res["tc"] * _pow2(tuc_l.t, e, tuc_r.t, e_inv)
        res["uc"] = res["uc"] * _pow2(tuc_l.u, e, tuc_r.u, e_inv)
        res["zc"] = (res["zc"] + zc_l * e + zc_r * e_inv).normalize()
        if with_d:
            tud_l, tud_r = g.comms_d[i]
            zd_l, zd_r = g.z_d[i]
            res["td"] = res["td"] * _pow2(tud_l.t, e, tud_r.t, e_inv)
            res["ud"] = res["ud"] * _pow2(tud_l.u, e, tud_r.u, e_inv)
            res["zd"] = (res["zd"] + zd_l * e + zd_r * e_inv).normalize()

    challenges.reverse()
    challenges_inv.reverse()
    final_r = polynomial_evaluation_product_form(challenges_inv, r_shift,
                                                 F(1))
    return res, final_r, challenges, challenges_inv


# ---------------------------------------------------------------------------
# LegoGroth16 aggregation via plain Groth16 TIPP/MIPP
# (reference aggregation/legogroth16/using_groth16.rs:29-128)
# ---------------------------------------------------------------------------

class _ABCProof:
    """Groth16-shaped view of a Lego proof (a, b, c only; d withheld)."""
    __slots__ = ("a", "b", "c")

    def __init__(self, p):
        self.a, self.b, self.c = p.a, p.b, p.c


def aggregate_proofs_using_groth16(srs: ProverSRS, transcript: Transcript,
                                   lego_proofs: list, device="cuda",
                                   timings: dict = None):
    """Aggregate LegoGroth16 proofs with the PLAIN Groth16 TIPP/MIPP
    (`using_groth16.rs:29-45`): since D is needed standalone for Schnorr
    openings, it is NOT folded into an IPA — the (A,B,C) parts aggregate as
    Groth16 proofs and the D vector is returned as-is for the verifier to
    fold with the r-powers."""
    agg = aggregate_proofs(srs, transcript,
                           [_ABCProof(p) for p in lego_proofs], device,
                           timings)
    return agg, [p.d for p in lego_proofs]


def verify_aggregate_proof_using_groth16(v_srs: VerifierSRS, vk,
                                         public_inputs: list,
                                         proof: AggregateProof, d: list,
                                         rng, transcript: Transcript,
                                         pairing_checker=None,
                                         device="cuda") -> bool:
    """`using_groth16.rs:47-128`: standard TIPP/MIPP verification, then the
    aggregate Groth16 equation with the gamma source extended by
    sum_j r^j D_j:  z_ab = e(alpha*r_sum, beta) *
    e(inp + sum r^j D_j, gamma) * e(z_c, delta)."""
    device = resolve_device(device)
    proof.parsing_check()
    if len(public_inputs) != proof.gipa.nproofs:
        raise AggregationError("public input count != proof count")
    if len(d) != proof.gipa.nproofs:
        raise AggregationError("D count != proof count")
    transcript.append(b"AB-commitment", proof.com_ab)
    transcript.append(b"C-commitment", proof.com_c)
    r = transcript.challenge_scalar(F, b"r-random-fiatshamir")
    checker = pairing_checker or RandomizedPairingChecker(
        F.rand(rng), lazy=True, device=device)

    if not _verify_tipp_mipp(v_srs, proof, r, transcript, checker):
        return False

    n = proof.gipa.nproofs
    r_powers = powers(r, n)
    r_sum = F(0)
    for p in r_powers:
        r_sum = r_sum + p

    num_inputs = len(public_inputs[0])
    summed = [r_sum]
    for i in range(num_inputs):
        acc = public_inputs[0][i]
        for j in range(1, n):
            acc = acc + public_inputs[j][i] * r_powers[j]
        summed.append(acc)
    inp = msm(vk.gamma_abc_g1[:num_inputs + 1], summed)
    d_r = msm(d, r_powers)

    source1 = [(vk.alpha_g1 * int(r_sum)).normalize(),
               (d_r + inp).normalize(), proof.z_c]
    source2 = [vk.beta_g2, vk.gamma_g2, vk.delta_g2]
    checker.add_multiple_sources_and_target(source1, source2, proof.z_ab)
    return checker.verify()
