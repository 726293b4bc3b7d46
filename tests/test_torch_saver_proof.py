"""The port's SAVER CRS and proof of encryption against the reference's
(`crypto_tpu_torch/saver/core.py`, `crypto_tpu/saver/core.py`), at 16-bit
chunks: `generate_srs` from the same rng equal to the reference's CRS;
`encrypt_with_proof` (the port's LegoGroth16 prover on the CPU) on the
reference's keys carried across equal to the reference's ciphertext,
randomness and proof; both packages' `verify_ciphertext_proof` accept
it and reject a changed chunk.  In the default lane the reference's
`create_proof` is a stand-in that returns the port's proof, carried
across (the two provers' equality is `test_torch_legogroth16_prove.py`'s;
the reference's compiles its JAX NTTs on first use); the slow lane runs
the reference's own prover.  `rerandomize_ciphertext_and_proof` from the
same rng equals the reference's and passes both checks.
"""

import dataclasses
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.legogroth16 import snark as jsnark
from crypto_tpu.saver import core as js
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.saver import core as ts
from crypto_tpu_torch.testing import cap_threads
from test_torch_saver import CB, ENV, stand_in_prover, to_ref

cap_threads()


def _srs_and_proof(monkeypatch, real_prover: bool):
    """The CRS from the same rng in both packages, keys from the
    reference's CRS, then `encrypt_with_proof` in both from the same rng
    (without `real_prover`, the reference's through the stand-in)."""
    monkeypatch.setenv(ENV, "host")
    gens_r = js.EncryptionGens.new(b"saver-port-srs")
    spk_r = js.generate_srs(CB, gens_r, random.Random(1539))
    gens_p = protocol_to_port(gens_r)
    spk_p = ts.generate_srs(CB, gens_p, random.Random(1539), device="cpu")
    assert canonical(spk_p) == canonical(spk_r)
    g_r = js.get_gs_for_encryption(spk_r.pk.vk)
    sk_r, ek_r, dk_r = js.keygen(random.Random(1540), CB, gens_r, g_r,
                                 spk_r.pk.delta_g1, spk_r.gamma_g1)
    ek_p = protocol_to_port(ek_r)
    m = random.Random(1541).randrange(tb.R)
    if not real_prover:
        stand_in_prover(monkeypatch)
    got = ts.encrypt_with_proof(random.Random(1542), tb.Fr(m), ek_p, spk_p,
                                CB, device="cpu")
    want = js.encrypt_with_proof(random.Random(1542), jb.Fr(m), ek_r, spk_r,
                                 CB)
    assert canonical(got) == canonical(want)
    return gens_p, spk_p, spk_r, ek_p, got, want


def test_srs_encrypt_with_proof(monkeypatch):
    """Both checks accept the port's ciphertext and proof; a changed chunk
    fails the proof in both packages; the rerandomised ciphertext and
    proof equal the reference's and pass both checks."""
    gens_p, spk_p, spk_r, ek_p, got, want = _srs_and_proof(monkeypatch,
                                                           False)
    ct, _, proof = got
    pvk = tsnark.PreparedVerifyingKey.from_vk(spk_p.pk.vk)
    assert ts.verify_ciphertext_proof(ct, proof, pvk, device="cpu")
    assert ts.verify_ciphertext_commitment(ct, ek_p, gens_p, device="cpu")
    bad = dataclasses.replace(ct, enc_chunks=[
        (ct.enc_chunks[0] + spk_p.pk.vk.gamma_abc_g1[1]).normalize()]
        + ct.enc_chunks[1:])
    assert not ts.verify_ciphertext_proof(bad, proof, pvk, device="cpu")
    jpvk = jsnark.PreparedVerifyingKey.from_vk(spk_r.pk.vk)
    assert js.verify_ciphertext_proof(want[0], want[2], jpvk)
    assert not js.verify_ciphertext_proof(to_ref(bad), want[2], jpvk)
    # a fresh-looking ciphertext and proof from the same rng in both
    ek_r = to_ref(ek_p)
    re_p = ts.rerandomize_ciphertext_and_proof(ct, proof, spk_p.pk.vk, ek_p,
                                               random.Random(1543))
    re_r = js.rerandomize_ciphertext_and_proof(
        want[0], want[2], spk_r.pk.vk, ek_r, random.Random(1543))
    assert canonical(re_p) == canonical(re_r)
    assert ts.verify_ciphertext_proof(re_p[0], re_p[2], pvk, device="cpu")
    assert ts.verify_ciphertext_commitment(re_p[0], ek_p, gens_p,
                                           device="cpu")


@pytest.mark.slow
def test_encrypt_with_proof_real_reference_prover(monkeypatch):
    _srs_and_proof(monkeypatch, True)
