"""The port's SAVER with LegoGroth16 (`crypto_tpu_torch/saver/lego.py`)
against the reference's (`crypto_tpu/saver/lego.py`), at 16-bit chunks.

The reference's CRS over the SAVER generators (the chunks as committed
witnesses) carried across; from the same `random` seeds: the keys bound
to it, the ciphertexts (`encrypt`, `encrypt_alt`) and both protocols'
proofs equal to the reference's; both packages' verifiers accept them and
the port's rejects a changed chunk (protocol 1) and a changed
`X_r_sum` (protocol 2).  In the default lane the reference's
`create_proof` is a stand-in returning the port's proof, carried across,
as in `test_torch_saver_proof.py`; the slow lane runs both protocols with
the reference's own prover.
"""

import dataclasses
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.legogroth16 import snark as jsnark
from crypto_tpu.saver import core as jcore
from crypto_tpu.saver import lego as jl
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.saver import core as tcore
from crypto_tpu_torch.saver import lego as tl
from crypto_tpu_torch.testing import cap_threads
from test_torch_saver import CB, stand_in_prover

cap_threads()


@pytest.fixture(scope="module")
def lego():
    gens_r = jcore.EncryptionGens.new(b"saver-lego-port")
    srs_r = jl.generate_srs(CB, gens_r, random.Random(1571))
    gens_p, srs_p = protocol_to_port(gens_r), protocol_to_port(srs_r)
    keys_r = jl.keygen(random.Random(1572), CB, gens_r, srs_r)
    keys_p = tl.keygen(random.Random(1572), CB, gens_p, srs_p)
    return gens_p, srs_p, keys_p, gens_r, srs_r, keys_r


def _prove(monkeypatch, port_fn, ref_fn, args_p, args_r, seed,
           real_prover):
    """The port's proof, then the reference's (without `real_prover`, with
    its prover a stand-in returning the port's snark proof)."""
    if not real_prover:
        stand_in_prover(monkeypatch)
    got = port_fn(*args_p, random.Random(seed), device="cpu")
    want = ref_fn(*args_r, random.Random(seed))
    assert canonical(got) == canonical(want)
    return got, want


def test_keys(lego):
    _, srs_p, keys_p, _, srs_r, keys_r = lego
    assert canonical(keys_p) == canonical(keys_r)
    assert canonical(tl.get_gs_for_encryption(srs_p.pk.vk)) == \
        canonical(jl.get_gs_for_encryption(srs_r.pk.vk))


def _protocol_1(lego, monkeypatch, real_prover):
    _, srs_p, (_, ek_p, _), _, srs_r, (_, ek_r, _) = lego
    m = random.Random(1573).randrange(tb.R)
    g_p = tl.get_gs_for_encryption(srs_p.pk.vk)
    g_r = jl.get_gs_for_encryption(srs_r.pk.vk)
    ct, r = tcore.encrypt(random.Random(1574), tb.Fr(m), ek_p, g_p, CB)
    ct_r, r_r = jcore.encrypt(random.Random(1574), jb.Fr(m), ek_r, g_r, CB)
    assert canonical((ct, r)) == canonical((ct_r, r_r))
    v = tb.Fr(1575)
    got, want = _prove(
        monkeypatch, tl.protocol1_create_proof, jl.protocol1_create_proof,
        (tb.Fr(m), v, r, srs_p, ek_p, CB), (jb.Fr(m), jb.Fr(1575), r_r,
                                            srs_r, ek_r, CB), 1576,
        real_prover)
    pvk = tsnark.PreparedVerifyingKey.from_vk(srs_p.pk.vk)
    assert tl.protocol1_verify_proof(pvk, got, ct)
    assert jl.protocol1_verify_proof(
        jsnark.PreparedVerifyingKey.from_vk(srs_r.pk.vk), want, ct_r)
    bad = dataclasses.replace(ct, enc_chunks=[
        (ct.enc_chunks[0] + g_p[0]).normalize()] + ct.enc_chunks[1:])
    assert not tl.protocol1_verify_proof(pvk, got, bad)


def _protocol_2(lego, monkeypatch, real_prover):
    _, srs_p, (_, ek_p, _), _, srs_r, (_, ek_r, _) = lego
    m = random.Random(1577).randrange(tb.R)
    g_p = tl.get_gs_for_encryption(srs_p.pk.vk)
    g_r = jl.get_gs_for_encryption(srs_r.pk.vk)
    ct, r = tl.encrypt_alt(random.Random(1578), tb.Fr(m), ek_p, g_p, CB)
    ct_r, r_r = jl.encrypt_alt(random.Random(1578), jb.Fr(m), ek_r, g_r, CB)
    assert canonical((ct, r)) == canonical((ct_r, r_r))
    got, want = _prove(
        monkeypatch, tl.protocol2_create_proof, jl.protocol2_create_proof,
        (tb.Fr(m), tb.Fr(1579), r, srs_p, ek_p, CB),
        (jb.Fr(m), jb.Fr(1579), r_r, srs_r, ek_r, CB), 1580, real_prover)
    pvk = tsnark.PreparedVerifyingKey.from_vk(srs_p.pk.vk)
    assert tl.protocol2_verify_proof(pvk, got, ct)
    assert jl.protocol2_verify_proof(
        jsnark.PreparedVerifyingKey.from_vk(srs_r.pk.vk), want, ct_r)
    bad = dataclasses.replace(ct, X_r_sum=(ct.X_r_sum + g_p[0]).normalize())
    assert not tl.protocol2_verify_proof(pvk, got, bad)


def test_protocol_1(lego, monkeypatch):
    _protocol_1(lego, monkeypatch, False)


def test_protocol_2(lego, monkeypatch):
    _protocol_2(lego, monkeypatch, False)


@pytest.mark.slow
def test_protocol_1_real_reference_prover(lego, monkeypatch):
    _protocol_1(lego, monkeypatch, True)


@pytest.mark.slow
def test_protocol_2_real_reference_prover(lego, monkeypatch):
    _protocol_2(lego, monkeypatch, True)
