"""The port's OT stack (`crypto_tpu_torch/ot/`) against the reference's
(`crypto_tpu/ot/`) under the same seeds, at the sizes of the reference's
`tests/test_threshold_bbs.py`: the configs and PRG helpers, 16 base OTs,
one base-OT phase of 128 OTs for an extension pair, the ALSZ extension
at 64 OTs, Gilboa at 2 products, KOS at 16 OTs with a spoiled RLC, DKLS18
and DKLS19 (2 products) at kappa = 256, coin tossing and zero sharing
over 3 parties, Naor-Pinkas 1-of-4 and Endemic OT.

Every random draw comes from the caller's `rng`, so the same seed gives
the same keys, pads and shares.  The extension layers run on seeds from
a seeded stream (both packages the same), not on a base-OT phase: the
base OTs cost ~512 host scalar multiplications a phase and are held on
their own.  The one deviation: the reference's cointoss draws its salts
from `os.urandom`, here patched to the same `rng`, which the port draws
from after the shares.
"""

import os
import random

import numpy as np
import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.ot import base_ot as r_bo
from crypto_tpu.ot import base_ot_more as r_bm
from crypto_tpu.ot import cointoss as r_ct
from crypto_tpu.ot import configs as r_cfg
from crypto_tpu.ot import dkls as r_dk
from crypto_tpu.ot import gilboa as r_gil
from crypto_tpu.ot import kos_ote as r_kos
from crypto_tpu.ot import ot_extension as r_ote
from crypto_tpu.ot import prg as r_prg
from crypto_tpu.ot import zero_sharing as r_zs
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.ot import base_ot as p_bo
from crypto_tpu_torch.ot import base_ot_more as p_bm
from crypto_tpu_torch.ot import cointoss as p_ct
from crypto_tpu_torch.ot import configs as p_cfg
from crypto_tpu_torch.ot import dkls as p_dk
from crypto_tpu_torch.ot import gilboa as p_gil
from crypto_tpu_torch.ot import kos_ote as p_kos
from crypto_tpu_torch.ot import ot_extension as p_ote
from crypto_tpu_torch.ot import prg as p_prg
from crypto_tpu_torch.ot import zero_sharing as p_zs
from crypto_tpu_torch.testing import cap_threads

cap_threads()

F = tb.Fr
REF_G, PORT_G = jb.G1.generator(), tb.G1.generator()


def ints(xs) -> list:
    return [int(x) for x in xs]


def pairs_of_ints(xs) -> list:
    return [(int(a), int(b)) for a, b in xs]


def extension_pairs(kappa: int, seed: int):
    """(reference (sender, receiver), port (sender, receiver)) over the
    same kappa seed pairs and base choices from a seeded stream."""
    g = random.Random(seed)
    s_bits = [g.randrange(2) for _ in range(kappa)]
    pairs = [(g.randbytes(16), g.randbytes(16)) for _ in range(kappa)]
    chosen = [p[s] for p, s in zip(pairs, s_bits)]
    return ((r_ote.OTESender.from_base(s_bits, chosen),
             r_ote.OTEReceiver(pairs)),
            (p_ote.OTESender.from_base(s_bits, chosen),
             p_ote.OTEReceiver(pairs)))


def values(n: int, seed: int) -> list:
    g = random.Random(seed)
    return [F.rand(g) for _ in range(n)]


@pytest.mark.parametrize("num_ot,num_messages", [(1, 2), (128, 2), (4, 7),
                                                 (0, 2), (3, 1)])
def test_configs(num_ot, num_messages):
    def make(mod):
        try:
            cfg = mod.OTConfig(num_ot, num_messages)
        except mod.OTConfigError as e:
            return str(e)
        out = [cfg.num_ot, cfg.num_messages]
        for choices in ([0] * num_ot, [num_messages - 1] * num_ot,
                        [num_messages] * num_ot, [0] * (num_ot + 1)):
            try:
                cfg.verify_receiver_choices(choices)
                out.append("ok")
            except mod.OTConfigError as e:
                out.append(str(e))
        return out

    assert make(p_cfg) == make(r_cfg)
    assert p_cfg.OTConfig.new_for_alsz_ote(128) == \
        p_cfg.OTConfig.new_2_message(128)


def test_prg_helpers():
    g = random.Random(3)
    seed, key = g.randbytes(16), g.randbytes(32)
    for n in (0, 1, 17, 4096):
        assert p_prg.aes_ctr_prg(seed, n) == r_prg.aes_ctr_prg(seed, n)
    for n in (1, 7, 8, 1000):
        assert np.array_equal(p_prg.prg_bits(seed, n),
                              r_prg.prg_bits(seed, n))
    for tag in (b"", b"rho"):
        assert p_prg.hash_key(key, 9, tag) == r_prg.hash_key(key, 9, tag)
        assert int(p_prg.key_to_field(key, tag)) == \
            int(r_prg.key_to_field(key, tag))
    bits = np.array([g.randrange(2) for _ in range(77)], dtype=np.uint8)
    assert p_prg.bits_to_bytes(bits) == r_prg.bits_to_bytes(bits)
    with pytest.raises(ValueError):
        p_prg.aes_ctr_prg(seed[:8], 16)


def test_transpose_bits():
    m = np.random.default_rng(4).integers(0, 2, (128, 72), dtype=np.uint8)
    got = p_ote._transpose_bits(m)
    assert np.array_equal(got, r_ote._transpose_bits(m))
    assert got.flags.c_contiguous


def test_base_ot_keys():
    """16 base OTs: the same sender pairs and chosen keys from the same
    seed, each chosen key the pair's choice."""
    choices = [random.Random(5).randrange(2) for _ in range(16)]
    r_pairs, r_chosen = r_bo.do_base_ots(random.Random(6), REF_G, choices)
    p_pairs, p_chosen = p_bo.do_base_ots(random.Random(6), PORT_G, choices)
    assert (p_pairs, p_chosen) == (r_pairs, r_chosen)
    for (k0, k1), c, kc in zip(p_pairs, choices, p_chosen):
        assert kc == (k1 if c else k0) and k0 != k1


def test_base_ot_refuses_a_spoiled_pok():
    rng = random.Random(7)
    sender = p_bo.BaseOTSenderSetup.new(rng, PORT_G)
    A, pok = sender.message()
    bad = type(pok)(pok.t, pok.response + F(1))
    with pytest.raises(ValueError, match="PoK"):
        p_bo.BaseOTReceiver.new(rng, PORT_G, (A, bad), [0, 1])


def test_setup_ote_pair():
    """One base-OT phase of 128 OTs (the extension's kappa): the same base
    choices, seeds and seed pairs as the reference."""
    rs, rr = r_ote.setup_ote_pair(random.Random(8), REF_G)
    ps, pr = p_ote.setup_ote_pair(random.Random(8), PORT_G)
    assert ps.kappa == pr.kappa == 128
    assert np.array_equal(ps.s_bits, rs.s_bits)
    assert ps.seeds == rs.seeds and pr.seed_pairs == rr.seed_pairs


def test_ot_extension():
    """ALSZ at 64 OTs: the same U and keys; each chosen key the pair's."""
    (rs, rr), (ps, pr) = extension_pairs(128, 9)
    choices = np.array([random.Random(10).randrange(2) for _ in range(64)],
                       dtype=np.uint8)
    rU, rkeys = rr.process(choices)
    pU, pkeys = pr.process(choices)
    assert np.array_equal(pU, rU) and pkeys == rkeys
    skeys = ps.process(64, pU)
    assert skeys == rs.process(64, rU)
    for j, (k0, k1) in enumerate(skeys):
        assert pkeys[j] == (k1 if choices[j] else k0) and k0 != k1


def test_gilboa_batch_mul():
    (rs, rr), (ps, pr) = extension_pairs(128, 11)
    a, b = values(2, 12), values(2, 13)
    rU, rkeys, rch = r_gil.batch_mul_party2_round1(rr, b)
    rmsgs, r1 = r_gil.batch_mul_party1(rs, a, rU)
    r2 = r_gil.batch_mul_party2_round2(rkeys, rch, rmsgs, 2)
    pU, pkeys, pch = p_gil.batch_mul_party2_round1(pr, b)
    pmsgs, s1 = p_gil.batch_mul_party1(ps, a, pU)
    s2 = p_gil.batch_mul_party2_round2(pkeys, pch, pmsgs, 2)
    assert np.array_equal(pU, rU) and np.array_equal(pch, rch)
    assert [pairs_of_ints(m) for m in (pmsgs,)] == \
        [pairs_of_ints(m) for m in (rmsgs,)]
    assert (ints(s1), ints(s2)) == (ints(r1), ints(r2))
    for t in range(2):
        assert s1[t] + s2[t] == a[t] * b[t]


def test_kos_consistency_and_correlation():
    """KOS at 16 OTs: the same U, RLC, t_A, tau and t_B; t_A + t_B =
    choice * alpha; a spoiled RLC refused by both."""
    (rs, rr), (ps, pr) = extension_pairs(128, 14)
    choices = [random.Random(15).randrange(2) for _ in range(16)]
    r_setup, rU, rrlc = r_kos.KOSReceiverSetup.new(random.Random(16), rr,
                                                   choices)
    p_setup, pU, prlc = p_kos.KOSReceiverSetup.new(random.Random(16), pr,
                                                   choices)
    assert np.array_equal(pU, rU) and (prlc.x, prlc.t) == (rrlc.x, rrlc.t)
    assert np.array_equal(p_setup.T_rows, r_setup.T_rows)
    alpha = list(zip(values(16, 17), values(16, 18)))
    rt_A, rtau = r_kos.KOSSenderSetup.new(rs, 16, rU, rrlc).transfer(alpha)
    send = p_kos.KOSSenderSetup.new(ps, 16, pU, prlc)
    t_A, tau = send.transfer(alpha)
    assert pairs_of_ints(t_A) == pairs_of_ints(rt_A)
    assert pairs_of_ints(tau) == pairs_of_ints(rtau)
    t_B = p_setup.receive(tau)
    assert pairs_of_ints(t_B) == pairs_of_ints(r_setup.receive(rtau))
    for i in range(16):
        for k in (0, 1):
            assert t_A[i][k] + t_B[i][k] == alpha[i][k] * F(choices[i])
    for mod, s, U, rlc in ((p_kos, ps, pU, prlc), (r_kos, rs, rU, rrlc)):
        bad = type(rlc)(x=rlc.x, t=bytes([rlc.t[0] ^ 1]) + rlc.t[1:])
        with pytest.raises(mod.OTError, match="consistency"):
            mod.KOSSenderSetup.new(s, 16, U, bad)


def test_kos_refuses_bad_shapes():
    (_, _), (ps, pr) = extension_pairs(128, 19)
    _, U, rlc = p_kos.KOSReceiverSetup.new(random.Random(1), pr, [1, 0])
    with pytest.raises(p_kos.OTError, match="shape"):
        p_kos.KOSSenderSetup.new(ps, 3, U, rlc)
    with pytest.raises(p_kos.OTError, match="multiple of 8"):
        p_kos.KOSReceiverSetup.new(random.Random(1), pr, [1], 60)


def test_dkls18_two_party_multiplication():
    """DKLS18 at kappa = 256, ssp = 80: the same shares; a spoiled RLC
    refused by Party2 in both packages."""
    (rs, rr), (ps, pr) = extension_pairs(256, 20)
    alpha, beta = values(2, 21)
    out = {}
    for name, mod, s, r in (("ref", r_dk, rs, rr), ("port", p_dk, ps, pr)):
        rng = random.Random(22)
        params = mod.MultiplicationOTEParams(kappa=256, ssp=80)
        gadget = mod.GadgetVector.new(params, b"dkls-test")
        p1 = mod.Party1.new(rng, alpha, s, params)
        p2, U, kos_rlc = mod.Party2.new(rng, beta, r, gadget, params)
        share1, tau, rlc = p1.receive(U, kos_rlc, gadget)
        share2 = p2.receive(tau, rlc, gadget)
        bad = mod.DklsRLC(r=rlc.r, u=rlc.u + F(1))
        with pytest.raises(mod.OTError, match="consistency"):
            p2.receive(tau, bad, gadget)
        out[name] = (int(share1), int(share2), ints(gadget.g),
                     pairs_of_ints(tau), ints(rlc.r), int(rlc.u))
    assert out["port"] == out["ref"]
    assert (out["port"][0] + out["port"][1]) % F.p == int(alpha * beta)


def test_dkls19_batch_multiplication():
    (rs, rr), (ps, pr) = extension_pairs(256, 23)
    alpha, *betas = values(3, 24)
    out = {}
    for name, mod, s, r in (("ref", r_dk, rs, rr), ("port", p_dk, ps, pr)):
        rng = random.Random(25)
        params = mod.MultiplicationOTEParams(kappa=256, ssp=80)
        gadget = mod.GadgetVector.new(params, b"dkls19-test")
        state, U, kos_rlc = mod.batch_mul_party2_round1(rng, betas, r,
                                                        gadget, params)
        shares1, tau, rlc = mod.batch_mul_party1(rng, alpha, len(betas), U,
                                                 kos_rlc, s, gadget, params)
        shares2 = mod.batch_mul_party2_round2(state, tau, rlc, gadget,
                                              params)
        out[name] = (ints(shares1), ints(shares2), state[0])
    assert out["port"] == out["ref"]
    for s1, s2, beta in zip(*out["port"][:2], betas):
        assert (s1 + s2) % F.p == int(alpha * beta)


def test_dkls_checks_the_base_ot_count():
    (_, _), (ps, _) = extension_pairs(128, 26)
    with pytest.raises(p_dk.OTError, match="kappa"):
        p_dk.Party1.new(random.Random(1), F(3), ps)


def _cointoss_world(mod, rng):
    ids = [1, 2, 3]
    parties, comms = {}, {}
    for i in ids:
        parties[i], comms[i] = mod.CointossParty.commit(rng, i, 2,
                                                        b"ct-test")
    for i in ids:
        for j in ids:
            if i != j:
                parties[i].receive_commitments(j, comms[j])
    reveals = {i: parties[i].reveal() for i in ids}
    for i in ids:
        for j in ids:
            if i != j:
                parties[i].receive_reveals(j, reveals[j])
    return parties, comms


def _zero_world(mod, rng):
    ids = [1, 2, 3]
    zs, zcomms = {}, {}
    for i in ids:
        zs[i], zcomms[i] = mod.ZeroSharingParty.init(
            rng, i, 2, [j for j in ids if j != i], b"zs-test")
    for i in ids:
        for j in ids:
            if i != j:
                zs[i].receive_commitments(j, zcomms[j][i])
    zreveals = {i: zs[i].reveals() for i in ids}
    for i in ids:
        for j in ids:
            if i != j:
                zs[i].receive_reveals(j, zreveals[j][i])
    return {i: zs[i].compute_zero_shares() for i in ids}


def test_cointoss_and_zero_sharing(monkeypatch):
    """Three parties: the same commitments, joint values and zero shares
    as the reference with its salts drawn from the same rng; the joint
    values agree and every batch item's zero shares sum to zero."""
    out = {}
    for name, ct, zs in (("ref", r_ct, r_zs), ("port", p_ct, p_zs)):
        rng = random.Random(27)
        if name == "ref":
            monkeypatch.setattr(os, "urandom", rng.randbytes)
        parties, comms = _cointoss_world(ct, rng)
        joints = [ints(parties[i].compute_joint()) for i in (1, 2, 3)]
        shares = _zero_world(zs, rng)
        monkeypatch.undo()
        out[name] = (comms, joints, {i: ints(v) for i, v in shares.items()})
    assert out["port"] == out["ref"]
    comms, joints, shares = out["port"]
    assert joints[0] == joints[1] == joints[2]
    for t in range(2):
        assert sum(shares[i][t] for i in (1, 2, 3)) % F.p == 0


def test_cointoss_refusals():
    rng = random.Random(28)
    a, ca = p_ct.CointossParty.commit(rng, 1, 2, b"x")
    b, cb = p_ct.CointossParty.commit(rng, 2, 2, b"x")
    with pytest.raises(ValueError, match="before commitment"):
        a.receive_reveals(2, b.reveal())
    a.receive_commitments(2, cb)
    with pytest.raises(ValueError, match="duplicate"):
        a.receive_commitments(2, cb)
    with pytest.raises(ValueError, match="length"):
        a.receive_reveals(2, b.reveal()[:1])
    spoiled = [(b.own()[0] + F(1), b.own_salts[0])] + b.reveal()[1:]
    with pytest.raises(ValueError, match="mismatch"):
        a.receive_reveals(2, spoiled)


def test_naor_pinkas_and_endemic_ot():
    """Naor-Pinkas 1-of-4 (every choice) and Endemic OT (both choices):
    the same keys as the reference from the same seed; the receiver's key
    is the chosen one and only that one."""
    out = {}
    for name, mod, g in (("ref", r_bm, REF_G), ("port", p_bm, PORT_G)):
        rng = random.Random(29)
        sender = mod.NPSender.setup(rng, g, 4)
        keys = []
        for choice in range(4):
            recv = mod.NPReceiver.new(rng, g, sender.C, choice)
            ks = sender.keys_for(recv.pk_0, 4)
            k = recv.key(sender.g_r)
            assert k == ks[choice] and ks.count(k) == 1
            keys.append((ks, k))
        for choice in (0, 1):
            er = mod.EndemicReceiver.new(rng, g, choice)
            es = mod.EndemicSender.new(rng, g)
            ks = es.keys(er.B)
            assert er.key(es.A) == ks[choice] and ks[0] != ks[1]
            keys.append((ks, er.key(es.A)))
        out[name] = keys
    assert out["port"] == out["ref"]
