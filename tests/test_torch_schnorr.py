"""The port's Schnorr protocols, serialization and hashing against the
reference's.

* BASELINE config 1: the parity fixture's `schnorr` entries
  (`tests/fixtures/parity_vectors.json`) reproduced byte for byte by the
  port's `schnorr/discrete_log.py`, `serialize.py` and `hashing.py` from
  the same `random.Random(101)` sequence as `tests/test_parity_vectors.py`.
* The Pedersen and generalized Schnorr protocols (`PokPedersenCommitment`,
  `SchnorrCommitment`, partial responses) on seeded inputs: every byte of
  the port's commitments, contributions, challenges and responses equal to
  the reference's, verified in both, spoiled responses rejected, and the
  port's randomized-mult-checker legs accepting and rejecting likewise.
* `serialize.py`: G1 and G2 points (compressed and uncompressed, infinity)
  to the reference's bytes and back; a point off the prime-order subgroup,
  a truncated encoding and an infinity flag with a payload rejected by
  both; `ByteWriter`, `serialize_vec` and `save_points`/`load_points`.
* `hashing.py`: `sha256`, `shake256`, `n_group_elements` and
  `hash_to_field_many` against the reference's.
"""

import json
import os
import random

import pytest

from crypto_tpu import hashing as jh
from crypto_tpu import serialize as js
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.schnorr import discrete_log as jdl
from crypto_tpu.schnorr import generalized as jgen
from crypto_tpu_torch import hashing as th
from crypto_tpu_torch import serialize as ts
from crypto_tpu_torch.convert import carry_point, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.schnorr import discrete_log as tdl
from crypto_tpu_torch.schnorr import generalized as tgen
from crypto_tpu_torch.utils.checkers import RandomizedMultChecker
from crypto_tpu_torch.testing import cap_threads

cap_threads()

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "parity_vectors.json")


def test_parity_fixture_schnorr():
    """BASELINE config 1: a Schnorr PoK of a discrete log on G1."""
    F = tb.Fr
    rng = random.Random(101)
    base = tb.G1.rand(rng).normalize()
    wit = F.rand(rng)
    y = (base * int(wit)).normalize()
    proto = tdl.PokDiscreteLogProtocol.init(wit, F.rand(rng), base)
    w = ts.ByteWriter()
    proto.challenge_contribution(base, y, w)
    ch = th.compute_random_oracle_challenge(F, w.bytes())
    proof = proto.gen_proof(ch)
    assert proof.verify(y, base, ch)
    assert not proof.verify(y, base, ch + F(1))
    got = {
        "base": ts.serialize_point(base).hex(),
        "y": ts.serialize_point(y).hex(),
        "contribution": w.bytes().hex(),
        "challenge": ch.to_bytes_le().hex(),
        "t": ts.serialize_point(proof.t).hex(),
        "response": proof.response.to_bytes_le().hex(),
    }
    with open(FIXTURE) as f:
        assert got == json.load(f)["schnorr"]
    # the proof's own contribution equals the protocol's
    w2 = ts.ByteWriter()
    proof.challenge_contribution(base, y, w2)
    assert w2.bytes() == w.bytes()


def _seeded(pkg_b, seed: int, nbases: int):
    """Bases and scalars of one package from one `random` seed."""
    rng = random.Random(seed)
    bases = [pkg_b.G1.rand(rng).normalize() for _ in range(nbases)]
    return rng, bases


def _pedersen(pkg_b, dl, ser, hsh):
    """A PokPedersenCommitment made by one package; returns its bytes
    (contribution, challenge, t, responses), the proof and its statement."""
    F = pkg_b.Fr
    rng, (g1, g2) = _seeded(pkg_b, 7, 2)
    x1, x2 = F.rand(rng), F.rand(rng)
    y = (g1 * int(x1) + g2 * int(x2)).normalize()
    proto = dl.PokPedersenCommitmentProtocol.init(x1, F.rand(rng), g1, x2,
                                                  F.rand(rng), g2)
    w = ser.ByteWriter()
    proto.challenge_contribution(g1, g2, y, w)
    ch = hsh.compute_random_oracle_challenge(F, w.bytes())
    proof = proto.gen_proof(ch)
    out = (w.bytes(), ch.to_bytes_le(), ser.serialize_point(proof.t),
           proof.response1.to_bytes_le(), proof.response2.to_bytes_le())
    return out, proof, (y, g1, g2, ch), proto


def test_pedersen_vs_reference():
    ref, jproof, (jy, jg1, jg2, jch), jproto = _pedersen(jb, jdl, js, jh)
    port, proof, (y, g1, g2, ch), proto = _pedersen(tb, tdl, ts, th)
    assert port == ref
    assert proof.verify(y, g1, g2, ch) and jproof.verify(jy, jg1, jg2, jch)
    # the reference's proof carried across verifies in the port
    assert protocol_to_port(jproof).verify(y, g1, g2, ch)
    bad = tdl.PokPedersenCommitment(proof.t, proof.response1 + tb.Fr(1),
                                    proof.response2)
    jbad = jdl.PokPedersenCommitment(jproof.t, jproof.response1 + jb.Fr(1),
                                     jproof.response2)
    assert not bad.verify(y, g1, g2, ch)
    assert not jbad.verify(jy, jg1, jg2, jch)
    # the partial form with the responses supplied
    part = proto.gen_partial_proof()
    assert part.verify(y, g1, g2, ch, proof.response1, proof.response2)
    assert not part.verify(y, g1, g2, ch, bad.response1, proof.response2)
    for verdict, pr in ((True, proof), (False, bad)):
        rmc = RandomizedMultChecker(tb.Fr(3))
        pr.verify_with_randomized_mult_checker(y, g1, g2, ch, rmc)
        assert rmc.verify() is verdict


def test_discrete_log_partial_and_checker():
    F = tb.Fr
    rng, (g,) = _seeded(tb, 9, 1)
    x = F.rand(rng)
    y = (g * int(x)).normalize()
    proto = tdl.PokDiscreteLogProtocol.init(x, F.rand(rng), g)
    ch = F.rand(rng)
    proof = proto.gen_proof(ch)
    part = proto.gen_partial_proof()
    assert part.verify(y, g, ch, proof.response)
    assert not part.verify(y, g, ch, proof.response + F(1))
    for verdict, resp in ((True, proof.response),
                          (False, proof.response + F(1))):
        rmc = RandomizedMultChecker(F(5))
        tdl.PokDiscreteLog(proof.t, resp).verify_with_randomized_mult_checker(
            y, g, ch, rmc)
        assert rmc.verify() is verdict


def _generalized(pkg_b, gen, ser):
    F = pkg_b.Fr
    rng, bases = _seeded(pkg_b, 11, 6)
    wits = [F.rand(rng) for _ in bases]
    y = pkg_b.G1.infinity()
    for b, x in zip(bases, wits):
        y = y + b * int(x)
    y = y.normalize()
    comm = gen.SchnorrCommitment.new(bases, [F.rand(rng) for _ in bases])
    w = ser.ByteWriter()
    comm.challenge_contribution(w)
    ch = F.rand(rng)
    resp = comm.response(wits, ch)
    part = gen.partial_response(comm, wits, ch, {1, 3})
    out = (w.bytes(), [r.to_bytes_le() for r in resp.responses],
           {i: r.to_bytes_le() for i, r in part.responses.items()})
    return out, (bases, y, comm, ch, resp, part)


def test_generalized_vs_reference():
    ref, (jbases, jy, jcomm, jch, jresp, jpart) = _generalized(jb, jgen, js)
    port, (bases, y, comm, ch, resp, part) = _generalized(tb, tgen, ts)
    assert port == ref
    assert resp.is_valid(bases, y, comm.t, ch)
    assert jresp.is_valid(jbases, jy, jcomm.t, jch)
    assert protocol_to_port(jresp).is_valid(bases, y, comm.t, ch)
    bad = tgen.SchnorrResponse(list(resp.responses))
    bad.responses[2] = bad.responses[2] + tb.Fr(1)
    assert not bad.is_valid(bases, y, comm.t, ch)
    missing = {i: resp.get_response(i) for i in (1, 3)}
    assert part.is_valid(bases, y, comm.t, ch, missing)
    assert not part.is_valid(bases, y, comm.t, ch, {1: missing[1]})
    assert not part.is_valid(bases, y, comm.t, ch,
                             {1: missing[1], 3: missing[1]})
    with pytest.raises(KeyError):
        part.get_response(3)
    with pytest.raises(ValueError):
        comm.response(resp.responses[:-1], ch)


def _off_subgroup(curve):
    """A point on `curve` outside its prime-order subgroup (no cofactor
    cleared), from the smallest x that lies on the curve."""
    K = curve.K
    for v in range(1, 200):
        x = K(v) if hasattr(K, "nbytes") else K(K.base(v), K.base(1))
        ys = curve.y_from_x(x)
        if ys is not None:
            p = curve.point_from_affine(x, ys[0])
            if not p.mul_raw(curve.scalar_field.p).is_infinity():
                return p
    raise AssertionError("no point off the subgroup found")


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_serialize_points_vs_reference(group):
    jc, tc = getattr(jb, group), getattr(tb, group)
    rng = random.Random(13)
    jpts = [jc.rand(rng), jc.rand(rng).normalize(), jc.infinity(),
            -jc.generator()]
    for jp in jpts:
        tp = carry_point(jp, tc)
        for comp in (True, False):
            data = ts.serialize_point(tp, comp)
            assert data == js.serialize_point(jp, comp)
            assert len(data) == ts.point_nbytes(tc, comp) \
                == js.point_nbytes(jc, comp)
            back = ts.deserialize_point(tc, data, comp)
            assert back == tp
            assert carry_point(back, jc) == js.deserialize_point(jc, data,
                                                                 comp)
    bad_inputs = []
    off = carry_point(_off_subgroup(tc), jc)
    for comp in (True, False):
        bad_inputs.append((js.serialize_point(off, comp), comp))
        good = js.serialize_point(jpts[0], comp)
        bad_inputs.append((good[:-1], comp))
        inf = bytearray(js.serialize_point(jc.infinity(), comp))
        inf[0] = 1
        bad_inputs.append((bytes(inf), comp))
    for data, comp in bad_inputs:
        with pytest.raises(ValueError):
            js.deserialize_point(jc, data, comp)
        with pytest.raises(ValueError):
            ts.deserialize_point(tc, data, comp)
    # off the subgroup but accepted when the check is off, in both
    data = js.serialize_point(off)
    assert carry_point(ts.deserialize_point(tc, data, check_subgroup=False),
                       jc) == js.deserialize_point(jc, data,
                                                   check_subgroup=False)


def test_fields_writer_vec_and_files(tmp_path):
    rng = random.Random(17)
    jq2 = jb.Fq2.rand(rng)
    tq2 = tb.Fq2(int(jq2.c0), int(jq2.c1))
    assert tq2.to_bytes_le() == jq2.to_bytes_le()
    assert ts.deserialize_fp2(tb.Fq2, tq2.to_bytes_le()) == tq2
    assert tb.Fq2.from_bytes_le(tq2.to_bytes_le()) == tq2
    with pytest.raises(ValueError):
        tb.Fq2.from_bytes_le(tq2.to_bytes_le()[:-1])
    x = jb.Fr.rand(rng)
    assert ts.serialize_field(tb.Fr(int(x))) == js.serialize_field(x)
    assert ts.deserialize_field(tb.Fr, x.to_bytes_le()) == tb.Fr(int(x))
    with pytest.raises(ValueError):
        ts.deserialize_field(tb.Fr, x.to_bytes_le()[:-1])
    jpts = [jb.G1.rand(rng).normalize() for _ in range(3)]
    tpts = [carry_point(p, tb.G1) for p in jpts]
    jw, tw = js.ByteWriter(), ts.ByteWriter()
    for w, pts, f in ((jw, jpts, x), (tw, tpts, tb.Fr(int(x)))):
        w.raw_vec_points(pts)
        w.fields([f, f])
        w.write(b"label")
    assert tw.bytes() == jw.bytes()
    assert ts.serialize_vec([b"ab", b"c"]) == js.serialize_vec([b"ab", b"c"])
    assert ts.serialize_usize(7) == js.serialize_usize(7)
    path = str(tmp_path / "pts.npz")
    g2 = tb.G2.generator()
    ts.save_points(path, h=tpts, w=g2)
    got = ts.load_points(path, {"h": tb.G1, "w": tb.G2})
    assert got == {"h": tpts, "w": [g2]}


def test_hashing_vs_reference():
    data = b"crypto-tpu hashing"
    assert th.sha256(data) == jh.sha256(data)
    assert th.shake256(data, 77) == jh.shake256(data, 77)
    for name in ("G1", "G2"):
        jp = jh.n_group_elements(getattr(jb, name), 2, 4, b"label : h_")
        tp = th.n_group_elements(getattr(tb, name), 2, 4, b"label : h_")
        assert [ts.serialize_point(p) for p in tp] \
            == [js.serialize_point(p) for p in jp]
    jf = jh.hash_to_field_many(jb.Fr, b"dst", b"seed", 5)
    tf = th.hash_to_field_many(tb.Fr, b"dst", b"seed", 5)
    assert [int(v) for v in tf] == [int(v) for v in jf]
    assert int(th.compute_random_oracle_challenge(tb.Fr, data, th.sha256)) \
        == int(jh.compute_random_oracle_challenge(jb.Fr, data, jh.sha256))
