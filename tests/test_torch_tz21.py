"""The port's TZ21 verifiable encryption (`crypto_tpu_torch/
verifiable_encryption/{tz21,rdkgith}.py`) against the reference's, on the
shapes of the reference's `tests/test_tz21.py`.

DKGitH at N = 4 parties and tau = 8 repetitions over 3 witnesses: the
reference draws its salt and root seeds from `os.urandom` (patched here
to a seeded stream), the port from its `rng` (the same stream), and the
two proofs are equal byte for byte; each package accepts
the other's proof, and a spoiled delta, opening, hidden ciphertext or
commitment is refused by both; compress and decrypt give the witnesses
and equal ciphertexts.  The batched device route (`_party_products`, the
threshold lowered to 1 so the CPU runs it on the plain kernels) gives the
host route's proof and verdicts.  RDkgith at 8 parties, 5 revealed, from
one `random.Random` seed: the same proof, compressed ciphertexts and
decryption, and the same refusals.
"""

import importlib
import os
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads
from test_torch_commitment_inequality import to_ref

cap_threads()

K = 3


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("tz", "verifiable_encryption.tz21"),
        ("rd", "verifiable_encryption.rdkgith"),
        ("eg", "utils.elgamal"), ("msm", "utils.msm"),
        ("hashing", "hashing"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def byte_stream(seed):
    """A callable n -> the next n bytes of a seeded stream."""
    return random.Random(seed).randbytes


def world(P, k=K, seed=909):
    rng = random.Random(seed)
    F = P.b.Fr
    gens = [P.b.G1.rand(rng).normalize() for _ in range(k)]
    wits = [F.rand(rng) for _ in range(k)]
    enc_g = P.b.G1.generator()
    sk, pk = P.eg.keygen(rng, enc_g)
    Y = P.msm.msm(gens, wits).normalize()
    return SimpleNamespace(P=P, gens=gens, wits=wits, enc_g=enc_g, sk=sk,
                           pk=pk, Y=Y)


def ref_dkgith(w, seed, monkeypatch, n_parties=4, reps=8):
    monkeypatch.setattr(os, "urandom", byte_stream(seed))
    proof = REF.tz.DkgithProof.new(random.Random(0), w.wits, w.Y, w.gens,
                                   w.pk, w.enc_g, n_parties=n_parties,
                                   reps=reps)
    monkeypatch.undo()
    return proof


def port_dkgith(w, seed, n_parties=4, reps=8):
    return PORT.tz.DkgithProof.new(random.Random(seed), w.wits, w.Y, w.gens,
                                   w.pk, w.enc_g, n_parties=n_parties,
                                   reps=reps, device="cpu")


@pytest.fixture(scope="module")
def worlds():
    """The two worlds and one DKGitH proof of each from the same bytes."""
    r, t = world(REF), world(PORT)
    mp = pytest.MonkeyPatch()
    r.proof = ref_dkgith(r, 41, mp)
    t.proof = port_dkgith(t, 41)
    return r, t


def spoiled(P, proof, what):
    """The proof with one part changed: a delta, a tree opening, a hidden
    ciphertext's value or its ephemeral key."""
    d = dict(salt=proof.salt, challenge=proof.challenge, deltas=proof.deltas,
             openings=proof.openings, hidden_cts=proof.hidden_cts,
             n_parties=proof.n_parties, reps=proof.reps)
    F = P.b.Fr
    if what == "delta":
        d["deltas"] = [[x + F(1) for x in row] for row in proof.deltas]
    elif what == "opening":
        first = proof.openings[0]
        d["openings"] = [[bytes(16)] + first[1:]] + proof.openings[1:]
    elif what == "hidden_ct":
        ct = proof.hidden_cts[0]
        d["hidden_cts"] = [P.tz.BatchCt(eph=ct.eph,
                                        cts=[ct.cts[0] + F(1)] + ct.cts[1:])
                           ] + proof.hidden_cts[1:]
    elif what == "hidden_eph":
        ct = proof.hidden_cts[0]
        d["hidden_cts"] = [P.tz.BatchCt(
            eph=(ct.eph + P.b.G1.generator()).normalize(), cts=ct.cts)
        ] + proof.hidden_cts[1:]
    return P.tz.DkgithProof(**d)


def test_seed_tree_parity():
    salt, root = bytes(range(32)), bytes(range(16, 32))
    r = REF.tz.SeedTree.create(root, salt, 3, 8)
    t = PORT.tz.SeedTree.create(root, salt, 3, 8)
    assert t.nodes == r.nodes
    for hidden in (0, 3, 7):
        opening = t.open_all_but(hidden)
        assert opening == r.open_all_but(hidden) and len(opening) == 3
        leaves = PORT.tz.SeedTree.reconstruct_leaves(opening, hidden, salt,
                                                     3, 8)
        assert leaves == REF.tz.SeedTree.reconstruct_leaves(
            opening, hidden, salt, 3, 8)
        assert set(leaves) == set(range(8)) - {hidden}


def test_dkgith_parity_and_cross_verify(worlds):
    r, t = worlds
    assert canonical(protocol_to_port(r.pk)) == canonical(t.pk)
    pr, pt = r.proof, t.proof
    assert pt.salt == pr.salt and pt.challenge == pr.challenge
    assert canonical(pt) == canonical(pr)
    assert canonical(protocol_to_port(pr)) == canonical(pt)
    assert pt.verify(t.Y, t.gens, t.pk, t.enc_g, device="cpu")
    assert PORT.tz.DkgithProof(**vars(protocol_to_port(pr))).verify(
        t.Y, t.gens, t.pk, t.enc_g, device="cpu")
    assert to_ref(pt).verify(r.Y, r.gens, r.pk, r.enc_g)
    # another seed stream gives another proof
    assert port_dkgith(t, 42).challenge != pt.challenge


@pytest.mark.parametrize("what", ["delta", "opening", "hidden_ct",
                                  "hidden_eph", "statement"])
def test_dkgith_spoiled_refused(worlds, what):
    r, t = worlds
    pt, pr = t.proof, r.proof
    if what == "statement":
        for P, w, proof, kw in ((PORT, t, pt, {"device": "cpu"}),
                                (REF, r, pr, {})):
            Y2 = P.msm.msm(w.gens, [x + P.b.Fr(1) for x in w.wits])
            assert not proof.verify(Y2.normalize(), w.gens, w.pk, w.enc_g,
                                    **kw)
        return
    assert not spoiled(PORT, pt, what).verify(t.Y, t.gens, t.pk, t.enc_g,
                                              device="cpu")
    assert not spoiled(REF, pr, what).verify(r.Y, r.gens, r.pk, r.enc_g)


def test_dkgith_compress_decrypt(worlds):
    r, t = worlds
    pr, pt = r.proof, t.proof
    cr, ct = pr.compress(subset_size=3), pt.compress(subset_size=3)
    assert canonical(ct) == canonical(cr) and len(ct.cts) == 3
    assert ct.decrypt(t.sk, t.Y, t.gens) == t.wits
    assert [int(x) for x in cr.decrypt(r.sk, r.Y, r.gens)] == \
        [int(x) for x in t.wits]
    # the default subset
    assert pt.compress().decrypt(t.sk, t.Y, t.gens) == t.wits
    other, _ = PORT.eg.keygen(random.Random(5), t.enc_g)
    with pytest.raises(ValueError):
        ct.decrypt(other, t.Y, t.gens)


@pytest.fixture(scope="module")
def device_world():
    """Two witnesses whose second base is the encryption key, so the route
    builds two CPU tables (gens[0] = enc_g and pk.y; ~3 s each)."""
    rng = random.Random(77)
    F = tb.Fr
    enc_g = tb.G1.rand(rng).normalize()
    sk, pk = PORT.eg.keygen(rng, enc_g)
    gens = [enc_g, pk.y]
    wits = [F.rand(rng), F.rand(rng)]
    Y = PORT.msm.msm(gens, wits).normalize()
    return SimpleNamespace(gens=gens, wits=wits, enc_g=enc_g, sk=sk, pk=pk,
                           Y=Y)


def test_device_route_equals_host_route(device_world, monkeypatch):
    """N = 4, tau = 2: 8 party instances of 4 products on the batched
    route (tables, `mul_many`, `TCurve.add`, one `to_affine`) against the
    host route: the prover's proof equals the host route's, and the
    verifier's batch (6 instances) accepts it."""
    w = device_world

    def new():
        return PORT.tz.DkgithProof.new(
            random.Random(45), w.wits, w.Y, w.gens, w.pk, w.enc_g,
            n_parties=4, reps=2, device="cpu")

    host = new()
    calls = []
    real = PORT.tz.table_for

    def counted(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)

    monkeypatch.setattr(PORT.tz, "table_for", counted)
    monkeypatch.setattr(PORT.tz, "DEVICE_FIXED_BASE_THRESHOLD", 1)
    dev = new()
    assert len(calls) == 4
    assert canonical(dev) == canonical(host)
    assert dev.verify(w.Y, w.gens, w.pk, w.enc_g, device="cpu")
    assert len(calls) == 8
    monkeypatch.undo()
    assert dev.compress(subset_size=1).decrypt(w.sk, w.Y, w.gens) == w.wits


def rdkgith_world(P):
    rng = random.Random(606)
    gens = [p.normalize() for p in
            P.hashing.n_group_elements(P.b.G1, 0, K, b"rdk-ck")]
    enc_g = P.b.G1.generator()
    sk, pk = P.eg.keygen(rng, enc_g)
    wits = [P.b.Fr.rand(rng) for _ in range(K)]
    comm = P.msm.msm(gens, wits).normalize()
    proof = P.rd.RdkgithProof.new(rng, wits, gens, pk, enc_g,
                                  num_parties=8, threshold=5)
    return SimpleNamespace(gens=gens, enc_g=enc_g, sk=sk, pk=pk, wits=wits,
                           comm=comm, proof=proof)


def test_rdkgith_parity():
    r, t = rdkgith_world(REF), rdkgith_world(PORT)
    assert canonical(t.proof) == canonical(r.proof)
    assert canonical(protocol_to_port(r.proof)) == canonical(t.proof)
    assert t.proof.verify(t.comm, t.gens, t.pk, t.enc_g)
    assert to_ref(t.proof).verify(r.comm, r.gens, r.pk, r.enc_g)
    cr, ct = r.proof.compress(subset_size=2), t.proof.compress(subset_size=2)
    assert canonical(ct) == canonical(cr)
    assert ct.decrypt(t.sk, t.comm, t.gens) == t.wits
    F = tb.Fr
    bad = PORT.msm.msm(t.gens, [t.wits[0] + F(1)] + t.wits[1:]).normalize()
    assert not t.proof.verify(bad, t.gens, t.pk, t.enc_g)
    d = dict(vars(t.proof))
    i, s, rr = d["shares_and_enc_rands"][0]
    d["shares_and_enc_rands"] = [(i, [s[0] + F(1)] + s[1:], rr)] + \
        d["shares_and_enc_rands"][1:]
    assert not PORT.rd.RdkgithProof(**d).verify(t.comm, t.gens, t.pk,
                                                t.enc_g)
    with pytest.raises(PORT.rd.VerEncError):
        t.proof.compress(subset_size=4)
