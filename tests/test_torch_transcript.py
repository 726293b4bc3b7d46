"""The port's Merlin transcript against the reference's.

`crypto_tpu_torch/transcript/` (Keccak-f[1600], STROBE-128, Merlin and the
application transcript) fed the same appends as `crypto_tpu/transcript/`:
G1 and G2 points (and infinity), a GT element, lists of points, ints,
scalars, raw bytes and a SnarkPack `PairCommitment`; every challenge
(bytes, one scalar, several scalars, a G1 and a G2 element) equal to the
reference's, byte for byte and value for value.  The port's pure-Python
permutation against the reference's (its native one where that library
loads), and the transcript RNG and clone semantics.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.transcript import keccak as jkeccak
from crypto_tpu.transcript.merlin import MerlinTranscript as JMerlin
from crypto_tpu.transcript.transcript import Transcript as JTranscript
from crypto_tpu_torch.convert import canonical, carry_fp12, carry_point
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16.aggregation import PairCommitment
from crypto_tpu_torch.testing import cap_threads
from crypto_tpu_torch.transcript import keccak as tkeccak
from crypto_tpu_torch.transcript.merlin import MerlinTranscript as TMerlin
from crypto_tpu_torch.transcript.transcript import Transcript as TTranscript

cap_threads()


@pytest.fixture(scope="module")
def elements():
    """The same elements in both packages: (port, reference) pairs."""
    rng = random.Random(1501)
    g1 = [tb.G1.rand(rng).normalize() for _ in range(3)]
    g2 = tb.G2.rand(rng).normalize()
    gt = tb.pairing(g1[0], g2)
    port = {"p1": g1[0], "p2": g2, "inf": tb.G1.infinity(), "gt": gt,
            "pts": g1[1:], "int": 7, "fr": tb.Fr(rng.randrange(tb.R)),
            "raw": bytes(range(40)), "empty": []}
    ref = {"p1": carry_point(g1[0], jb.G1), "p2": carry_point(g2, jb.G2),
           "inf": jb.G1.infinity(), "gt": carry_fp12(gt, jb.Fq12),
           "pts": [carry_point(p, jb.G1) for p in g1[1:]], "int": 7,
           "fr": jb.Fr(int(port["fr"])), "raw": port["raw"], "empty": []}
    return port, ref


def _fed(T, items):
    t = T(b"test-transcript")
    for label, x in items.items():
        t.append(label.encode(), x)
    return t


def test_appends_and_challenges(elements):
    port, ref = elements
    tp, tr = _fed(TTranscript, port), _fed(JTranscript, ref)
    assert tp.challenge_bytes(b"bytes", 75) == tr.challenge_bytes(b"bytes",
                                                                   75)
    assert int(tp.challenge_scalar(tb.Fr, b"c")) == \
        int(tr.challenge_scalar(jb.Fr, b"c"))
    assert [int(c) for c in tp.challenge_scalars(tb.Fr, b"cs", 4)] == \
        [int(c) for c in tr.challenge_scalars(jb.Fr, b"cs", 4)]
    for cp, cr in ((tb.G1, jb.G1), (tb.G2, jb.G2)):
        gp = tp.challenge_group_elem(cp, b"g")
        gr = tr.challenge_group_elem(cr, b"g")
        assert canonical(gp) == canonical(gr)
        assert not gp.is_infinity()
    # after the challenges the two states still agree
    assert tp.challenge_bytes(b"end", 32) == tr.challenge_bytes(b"end", 32)


def test_gt_and_pair_commitment_bytes(elements):
    """A GT element's transcript bytes (the six Fq2 coefficients) and a
    `PairCommitment`'s (t then u), as the reference takes them."""
    port, ref = elements
    gt_p, gt_r = port["gt"], ref["gt"]
    assert gt_p.to_bytes_le() == gt_r.to_bytes_le()
    assert len(gt_p.to_bytes_le()) == 12 * 48
    from crypto_tpu.legogroth16.aggregation import PairCommitment as JPC
    pc = PairCommitment(t=gt_p, u=gt_p * gt_p)
    jpc = JPC(t=gt_r, u=gt_r * gt_r)
    tp, tr = TTranscript(b"pc"), JTranscript(b"pc")
    tp.append(b"com", pc)
    tr.append(b"com", jpc)
    assert tp.challenge_bytes(b"x", 64) == tr.challenge_bytes(b"x", 64)


def test_order_and_labels_matter(elements):
    port, _ = elements
    a = _fed(TTranscript, port).challenge_bytes(b"c", 32)
    swapped = dict(reversed(list(port.items())))
    assert _fed(TTranscript, swapped).challenge_bytes(b"c", 32) != a
    t = TTranscript(b"other-label")
    for label, x in port.items():
        t.append(label.encode(), x)
    assert t.challenge_bytes(b"c", 32) != a


def test_clone_replace_and_rng(elements):
    port, ref = elements
    tp = _fed(TTranscript, port)
    c = tp.clone()
    c.append(b"extra", b"1")
    assert c.challenge_bytes(b"c", 16) != tp.clone().challenge_bytes(b"c", 16)
    tp.replace_with(c)
    assert tp.merlin is c.merlin
    mp, mr = TMerlin(b"rng"), JMerlin(b"rng")
    for m in (mp, mr):
        m.append_message(b"m", b"payload")
        m.append_u64(b"n", 2 ** 40 + 3)
    rp = mp.build_rng().rekey_with_witness_bytes(b"w", b"secret") \
        .finalize(bytes(32))
    rr = mr.build_rng().rekey_with_witness_bytes(b"w", b"secret") \
        .finalize(bytes(32))
    assert rp.random_bytes(50) == rr.random_bytes(50)
    assert rp.randrange(tb.R) == rr.randrange(jb.R)
    assert mp.challenge_bytes(b"c", 33) == mr.challenge_bytes(b"c", 33)


def test_keccak_permutation():
    rng = random.Random(1502)
    for state in (bytearray(200), bytearray(rng.randbytes(200))):
        a, b, c = bytearray(state), bytearray(state), bytearray(state)
        tkeccak.keccak_f1600(a)
        jkeccak._keccak_f1600_py(b)
        jkeccak.keccak_f1600(c)
        assert a == b == c
        assert a != state
