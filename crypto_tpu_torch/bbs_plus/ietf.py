"""IETF BBS signature ciphersuites (draft-irtf-cfrg-bbs-signatures),
BLS12381G1_XMD:SHA-256_SSWU_RO and BLS12381G1_XOF:SHAKE-256_SSWU_RO: the
port's own copy of `crypto_tpu/bbs_plus/ietf.py`.

create_generators, KeyGen, Sign, Verify, ProofGen and ProofVerify with
the draft's octet formats (ZCash point compression, big-endian scalars),
hashing by RFC 9380 (`hashing_rfc9380.py`).  The draft's fixtures (the
SHA-256 secret key and base point P1, the SHAKE-256 secret key and
generators Q_1/H_1) hold it in `tests/test_torch_bbs_ietf.py`.

Host integers throughout, except the two pairing checks: `verify` and
`proof_verify` take `device` and pair through the router of
`curves/tpairing.py` (CUDA unless the caller names the CPU; raises
without a card), which sends a 2-pair product to the host or the card by
its size.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..hashing_rfc9380 import (expand_message_xmd, expand_message_xof,
                               hash_to_curve_g1, P as _P)
from ..utils.msm import msm as _msm

R = bls.R
EXPAND_LEN = 48


def i2osp(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "big")


def os2ip(b: bytes) -> int:
    return int.from_bytes(b, "big")


# ---------------------------------------------------------------------------
# octet formats (ZCash BLS12-381 compression, as required by the draft)
# ---------------------------------------------------------------------------

def point_to_octets_g1(pt: Point) -> bytes:
    pt = pt.normalize()
    if pt.is_infinity():
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x = int(pt.X)
    y = int(pt.Y)
    out = bytearray(i2osp(x, 48))
    out[0] |= 0x80
    if y > (_P - 1) // 2:
        out[0] |= 0x20
    return bytes(out)


def octets_to_point_g1(b: bytes) -> Point:
    if len(b) != 48 or not (b[0] & 0x80):
        raise ValueError("bad G1 octets")
    if b[0] & 0x40:
        if any(b[1:]) or (b[0] & 0x3F):
            raise ValueError("bad G1 infinity octets")
        return bls.G1.infinity()
    sign = bool(b[0] & 0x20)
    x = os2ip(bytes([b[0] & 0x1F]) + b[1:])
    if x >= _P:
        raise ValueError("G1 x out of range")
    xe = bls.Fq(x)
    y = (xe * xe * xe + bls.G1.b).sqrt()
    if y is None:
        raise ValueError("not on curve")
    if (int(y) > (_P - 1) // 2) != sign:
        y = -y
    pt = Point(xe, y, bls.Fq(1), bls.G1)
    if not pt.mul_raw(R).is_infinity():
        raise ValueError("not in subgroup")
    return pt


def point_to_octets_g2(pt: Point) -> bytes:
    pt = pt.normalize()
    if pt.is_infinity():
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    x, y = pt.X, pt.Y
    out = bytearray(i2osp(int(x.c1), 48) + i2osp(int(x.c0), 48))
    out[0] |= 0x80
    if (int(y.c1), int(y.c0)) > (int((-y).c1), int((-y).c0)):
        out[0] |= 0x20
    return bytes(out)


def octets_to_point_g2(b: bytes) -> Point:
    if len(b) != 96 or not (b[0] & 0x80):
        raise ValueError("bad G2 octets")
    if b[0] & 0x40:
        if any(b[1:]) or (b[0] & 0x3F):
            raise ValueError("bad G2 infinity octets")
        return bls.G2.infinity()
    sign = bool(b[0] & 0x20)
    c1 = os2ip(bytes([b[0] & 0x1F]) + b[1:48])
    c0 = os2ip(b[48:])
    if c0 >= _P or c1 >= _P:
        raise ValueError("G2 x out of range")
    xe = bls.Fq2(bls.Fq(c0), bls.Fq(c1))
    rhs = xe * xe * xe + bls.G2.b
    y = rhs.sqrt()
    if y is None:
        raise ValueError("not on curve")
    if ((int(y.c1), int(y.c0)) > (int((-y).c1), int((-y).c0))) != sign:
        y = -y
    pt = Point(xe, y, bls.Fq2(bls.Fq(1)), bls.G2)
    if not pt.mul_raw(R).is_infinity():
        raise ValueError("not in subgroup")
    return pt


# ---------------------------------------------------------------------------
# ciphersuites
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ciphersuite:
    ciphersuite_id: bytes
    expander: object        # expand_message_{xmd,xof}

    @property
    def api_id(self) -> bytes:
        return self.ciphersuite_id + b"H2G_HM2S_"

    # -- hashing ------------------------------------------------------
    def hash_to_scalar(self, msg: bytes, dst: bytes) -> bls.Fr:
        return bls.Fr(os2ip(self.expander(msg, dst, EXPAND_LEN)) % R)

    def hash_to_curve(self, msg: bytes, dst: bytes) -> Point:
        x, y = hash_to_curve_g1(msg, dst, expander=self.expander)
        return Point(bls.Fq(x), bls.Fq(y), bls.Fq(1), bls.G1)

    def messages_to_scalars(self, messages: list) -> list:
        dst = self.api_id + b"MAP_MSG_TO_SCALAR_AS_HASH_"
        return [self.hash_to_scalar(m, dst) for m in messages]

    # -- generators (draft §4.1.1 create_generators) ------------------
    def _generators(self, count: int, seed_suffix: bytes) -> list:
        seed_dst = self.api_id + b"SIG_GENERATOR_SEED_"
        generator_dst = self.api_id + b"SIG_GENERATOR_DST_"
        v = self.expander(self.api_id + seed_suffix, seed_dst, EXPAND_LEN)
        out = []
        for i in range(1, count + 1):
            v = self.expander(v + i2osp(i, 8), seed_dst, EXPAND_LEN)
            out.append(self.hash_to_curve(v, generator_dst))
        return out

    def create_generators(self, count: int) -> list:
        """(Q_1, H_1, ..., H_{count-1})."""
        return self._generators(count, b"MESSAGE_GENERATOR_SEED")

    def p1(self) -> Point:
        """The ciphersuite base point (draft §6.2: the generator derived
        from the BP_MESSAGE_GENERATOR_SEED)."""
        return self._generators(1, b"BP_MESSAGE_GENERATOR_SEED")[0]

    # -- keygen (draft §3.4.1 / §3.5.1) -------------------------------
    def keygen(self, key_material: bytes, key_info: bytes = b"",
               key_dst: bytes | None = None) -> bls.Fr:
        if key_dst is None:
            key_dst = self.api_id + b"KEYGEN_DST_"
        if len(key_material) < 32 or len(key_info) > 65535:
            raise ValueError("bad key material/info")
        derive_input = key_material + i2osp(len(key_info), 2) + key_info
        sk = self.hash_to_scalar(derive_input, key_dst)
        if int(sk) == 0:
            raise ValueError("invalid key material (SK = 0)")
        return sk

    def sk_to_pk(self, sk: bls.Fr) -> bytes:
        return point_to_octets_g2(bls.G2.generator() * int(sk))

    # -- domain / signing (draft §3.6.1, §3.7.1) ----------------------
    def _calculate_domain(self, pk_octets: bytes, q1: Point, h_points: list,
                          header: bytes) -> bls.Fr:
        if len(header) > 65535:
            raise ValueError("header too long")
        dom_octs = i2osp(len(h_points), 8) + point_to_octets_g1(q1)
        for h in h_points:
            dom_octs += point_to_octets_g1(h)
        dom_octs += self.api_id
        dom_input = pk_octets + dom_octs + i2osp(len(header), 8) + header
        return self.hash_to_scalar(dom_input, self.api_id + b"H2S_")

    def sign(self, sk: bls.Fr, pk_octets: bytes, header: bytes,
             messages: list) -> bytes:
        """CoreSign (draft §3.6.1); messages are octet strings.  Returns
        the 80-byte signature octets (A, e)."""
        msg_scalars = self.messages_to_scalars(messages)
        L = len(msg_scalars)
        gens = self.create_generators(L + 1)
        q1, h_points = gens[0], gens[1:]
        domain = self._calculate_domain(pk_octets, q1, h_points, header)
        ser = i2osp(int(sk), 32) + i2osp(int(domain), 32)
        for m in msg_scalars:
            ser += i2osp(int(m), 32)
        e = self.hash_to_scalar(ser, self.api_id + b"H2S_")
        b_pt = self.p1() + q1 * int(domain)
        if h_points:
            b_pt = b_pt + _msm(h_points, msg_scalars)
        a_pt = b_pt * int((sk + e).inverse())
        return point_to_octets_g1(a_pt) + i2osp(int(e), 32)

    def verify(self, pk_octets: bytes, signature: bytes, header: bytes,
               messages: list, device="cuda") -> bool:
        """CoreVerify (draft §3.6.2): e(A, W + e*BP2) == e(B, BP2), the
        product routed on `device`."""
        a_pt, e = self._parse_signature(signature)
        w = octets_to_point_g2(pk_octets)
        msg_scalars = self.messages_to_scalars(messages)
        L = len(msg_scalars)
        gens = self.create_generators(L + 1)
        q1, h_points = gens[0], gens[1:]
        domain = self._calculate_domain(pk_octets, q1, h_points, header)
        b_pt = self.p1() + q1 * int(domain)
        if h_points:
            b_pt = b_pt + _msm(h_points, msg_scalars)
        bp2 = bls.G2.generator()
        return multi_pairings_routed([[
            (a_pt.normalize(), (w + bp2 * int(e)).normalize()),
            ((-b_pt).normalize(), bp2)]], device)[0].is_one()

    def _parse_signature(self, signature: bytes):
        if len(signature) != 80:
            raise ValueError("bad signature length")
        a_pt = octets_to_point_g1(signature[:48])
        if a_pt.is_infinity():
            raise ValueError("signature A is identity")
        e = os2ip(signature[48:])
        if e == 0 or e >= R:
            raise ValueError("signature e out of range")
        return a_pt, bls.Fr(e)

    # -- proofs (draft §3.6.3 / §3.6.4, "split" form) -----------------
    def _challenge(self, abar, bbar, d, t1, t2, disclosed: dict,
                   domain, ph: bytes) -> bls.Fr:
        if len(ph) > 65535:
            raise ValueError("presentation header too long")
        idxs = sorted(disclosed)
        c_octs = i2osp(len(idxs), 8)
        for i in idxs:
            c_octs += i2osp(i, 8)
        for pt in (abar, bbar, d, t1, t2):
            c_octs += point_to_octets_g1(pt)
        for i in idxs:
            c_octs += i2osp(int(disclosed[i]), 32)
        c_octs += i2osp(int(domain), 32)
        c_octs += i2osp(len(ph), 8) + ph
        return self.hash_to_scalar(c_octs, self.api_id + b"H2S_")

    def proof_gen(self, pk_octets: bytes, signature: bytes, header: bytes,
                  ph: bytes, messages: list, disclosed_indexes: list,
                  rng) -> bytes:
        """CoreProofGen: selective-disclosure PoK of the signature."""
        a_pt, e = self._parse_signature(signature)
        msg_scalars = self.messages_to_scalars(messages)
        L = len(msg_scalars)
        gens = self.create_generators(L + 1)
        q1, h_points = gens[0], gens[1:]
        domain = self._calculate_domain(pk_octets, q1, h_points, header)
        disclosed = sorted(set(disclosed_indexes))
        if any(i < 0 or i >= L for i in disclosed):
            raise ValueError("bad disclosed index")
        undisclosed = [i for i in range(L) if i not in disclosed]

        b_pt = self.p1() + q1 * int(domain)
        if h_points:
            b_pt = b_pt + _msm(h_points, msg_scalars)

        r1 = bls.Fr.rand_nonzero(rng)
        r2 = bls.Fr.rand_nonzero(rng)
        et = bls.Fr.rand(rng)
        r1t = bls.Fr.rand(rng)
        r3t = bls.Fr.rand(rng)
        mt = {j: bls.Fr.rand(rng) for j in undisclosed}

        d_pt = b_pt * int(r2)
        abar = a_pt * int(r1 * r2)
        bbar = (d_pt * int(r1) - abar * int(e)).normalize()
        t1 = (abar * int(et) + d_pt * int(r1t)).normalize()
        t2 = d_pt * int(r3t)
        if undisclosed:
            t2 = t2 + _msm([h_points[j] for j in undisclosed],
                           [mt[j] for j in undisclosed])
        t2 = t2.normalize()
        abar = abar.normalize()
        d_pt = d_pt.normalize()

        c = self._challenge(abar, bbar, d_pt, t1, t2,
                            {i: msg_scalars[i] for i in disclosed},
                            domain, ph)
        r3 = r2.inverse()
        e_h = et + c * e
        r1_h = r1t - c * r1
        r3_h = r3t - c * r3
        out = (point_to_octets_g1(abar) + point_to_octets_g1(bbar)
               + point_to_octets_g1(d_pt)
               + i2osp(int(e_h), 32) + i2osp(int(r1_h), 32)
               + i2osp(int(r3_h), 32))
        for j in undisclosed:
            out += i2osp(int(mt[j] + c * msg_scalars[j]), 32)
        out += i2osp(int(c), 32)
        return out

    def proof_verify(self, pk_octets: bytes, proof: bytes, header: bytes,
                     ph: bytes, disclosed_messages: dict, L: int,
                     device="cuda") -> bool:
        """CoreProofVerify; disclosed_messages: index -> octets.  The
        pairing product is routed on `device`."""
        base = 3 * 48 + 3 * 32
        if len(proof) < base + 32 or (len(proof) - base - 32) % 32:
            raise ValueError("bad proof length")
        u = (len(proof) - base - 32) // 32
        disclosed_idx = sorted(disclosed_messages)
        if u + len(disclosed_idx) != L:
            raise ValueError("message count mismatch")
        abar = octets_to_point_g1(proof[0:48])
        bbar = octets_to_point_g1(proof[48:96])
        d_pt = octets_to_point_g1(proof[96:144])
        off = 144
        sc = []
        for _ in range(3 + u + 1):
            v = os2ip(proof[off:off + 32])
            if v >= R:
                raise ValueError("proof scalar out of range")
            sc.append(bls.Fr(v))
            off += 32
        e_h, r1_h, r3_h = sc[0], sc[1], sc[2]
        m_h = sc[3:3 + u]
        c = sc[3 + u]

        gens = self.create_generators(L + 1)
        q1, h_points = gens[0], gens[1:]
        domain = self._calculate_domain(pk_octets, q1, h_points, header)
        disclosed_scalars = {
            i: self.messages_to_scalars([disclosed_messages[i]])[0]
            for i in disclosed_idx}
        undisclosed = [i for i in range(L) if i not in disclosed_messages]

        t1 = (bbar * int(c) + abar * int(e_h)
              + d_pt * int(r1_h)).normalize()
        bv = self.p1() + q1 * int(domain)
        if disclosed_idx:
            bv = bv + _msm([h_points[i] for i in disclosed_idx],
                           [disclosed_scalars[i] for i in disclosed_idx])
        t2 = bv * int(c) + d_pt * int(r3_h)
        if undisclosed:
            t2 = t2 + _msm([h_points[j] for j in undisclosed], m_h)
        t2 = t2.normalize()
        cv = self._challenge(abar, bbar, d_pt, t1, t2, disclosed_scalars,
                             domain, ph)
        if int(cv) != int(c):
            return False
        w = octets_to_point_g2(pk_octets)
        bp2 = bls.G2.generator()
        return multi_pairings_routed([[
            (abar.normalize(), w), ((-bbar).normalize(), bp2)]],
            device)[0].is_one()


BLS12381_SHA256 = Ciphersuite(
    ciphersuite_id=b"BBS_BLS12381G1_XMD:SHA-256_SSWU_RO_",
    expander=expand_message_xmd)

BLS12381_SHAKE256 = Ciphersuite(
    ciphersuite_id=b"BBS_BLS12381G1_XOF:SHAKE-256_SSWU_RO_",
    expander=expand_message_xof)
