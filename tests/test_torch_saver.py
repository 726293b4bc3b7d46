"""The port's SAVER verifiable encryption, Groth16 form, against the
reference's (`crypto_tpu_torch/saver/core.py`, `crypto_tpu/saver/core.py`).

At 16-bit chunks (16 chunks; BASELINE config 4's 8-bit chunks run on the
card in `chip_smoke.py`), from the same `random` seeds:

* chunk decomposition and the bitsize circuit's constraint rows;
* keys over random bases (keygen takes any g_i, delta_g and gamma_g),
  ciphertexts and the ciphertext commitment check (accepting, and
  rejecting a spoiled psi) equal to the reference's;
* decryption on the device route of `multi_pairings_routed` (the
  variable unset): its 16 products and 16 bases reach
  `TPairing.multi_pairings` as one batch (a host stand-in in the default
  lane; the plain kernels, 48 lanes, in the slow lane), equal to the
  reference's decryption; its verification on the host route
  (`CRYPTO_TPU_PAIRING_BACKEND=host`), a wrong message rejected by both;
The CRS and `encrypt_with_proof` are `test_torch_saver_proof.py`'s.
`to_ref` carries the port's objects to the reference's classes of the
same names (the other tests of this slice import it).
"""

import dataclasses
import importlib
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.r1cs import cs as jcs
from crypto_tpu.saver import core as js
from crypto_tpu_torch.convert import canonical, carry_fp12, carry_point
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.curves import tpairing
from crypto_tpu_torch.r1cs import cs as tcs
from crypto_tpu_torch.saver import core as ts
from crypto_tpu_torch.testing import cap_threads

cap_threads()

ENV = "CRYPTO_TPU_PAIRING_BACKEND"
CB = 16
N = ts.chunks_count(CB)


def to_ref(obj):
    """A port object as the reference's: dataclasses by the class of the
    same name in the reference's module of the same name, points, GT and
    field elements by value, containers item by item."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = importlib.import_module(
            "crypto_tpu." + type(obj).__module__[len("crypto_tpu_torch."):])
        return getattr(mod, type(obj).__name__)(**{
            f.name: to_ref(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if hasattr(obj, "curve") and hasattr(obj, "Z"):
        return carry_point(obj, jb.G2 if hasattr(obj.X, "c0") else jb.G1)
    if hasattr(obj, "c1") and hasattr(getattr(obj, "c0", None), "c2"):
        return carry_fp12(obj, jb.Fq12)
    if hasattr(obj, "f") and hasattr(obj, "v"):
        return (jb.Fr if obj.f.p == jb.R else jb.Fq)(int(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_ref(x) for x in obj)
    return obj


def stand_in_prover(monkeypatch):
    """Record the port's `create_proof` outputs and make the reference's
    `create_proof` a stand-in that takes the same draws of its rng (r, s,
    and v when none is given) and returns the port's next proof, carried
    across: the two provers' equality is `test_torch_legogroth16_prove.py`'s,
    and the reference's compiles its JAX NTTs on first use (~10 s)."""
    from crypto_tpu.legogroth16 import snark as jsnark
    from crypto_tpu_torch.legogroth16 import snark as tsnark
    made = []
    prove = tsnark.create_proof

    def port(*a, **k):
        made.append(prove(*a, **k))
        return made[-1]

    def ref(circuit, pk, rng, v=None, ctx=None):
        for _ in range(2 if v is not None else 3):
            jb.Fr.rand(rng)
        return to_ref(made.pop(0))

    monkeypatch.setattr(tsnark, "create_proof", port)
    monkeypatch.setattr(jsnark, "create_proof", ref)


@pytest.fixture
def host_pairing(monkeypatch):
    monkeypatch.setenv(ENV, "host")


def _keyed(pkg, curves, seed):
    """Generators, random bases and SAVER keys over them: keygen takes any
    g_i, delta_g and gamma_g, so no CRS is needed to decrypt."""
    rng = random.Random(seed)
    gens = pkg.EncryptionGens.new(b"saver-port-test")
    g_i = [curves.G1.rand(rng).normalize() for _ in range(N)]
    delta_g, gamma_g = (curves.G1.rand(rng).normalize() for _ in range(2))
    sk, ek, dk = pkg.keygen(rng, CB, gens, g_i, delta_g, gamma_g)
    return SimpleNamespace(gens=gens, g_i=g_i, sk=sk, ek=ek, dk=dk)


@pytest.fixture(scope="module")
def keyed():
    return _keyed(ts, tb, 1531), _keyed(js, jb, 1531)


def test_chunks_and_circuit():
    rng = random.Random(1532)
    for cb in (4, 8, 16):
        m = rng.randrange(tb.R)
        chunks = ts.decompose(tb.Fr(m), cb)
        assert chunks == js.decompose(jb.Fr(m), cb)
        assert len(chunks) == ts.chunks_count(cb) == js.chunks_count(cb)
        assert int(ts.compose(chunks, cb)) == m
    vals = [rng.randrange(1 << 8) for _ in range(ts.chunks_count(8))]
    for values in (None, vals):
        mode = "setup" if values is None else "prove"
        got = tcs.ConstraintSystem(tb.Fr, mode=mode)
        want = jcs.ConstraintSystem(jb.Fr, mode=mode)
        ts.bitsize_check_circuit(8, len(vals), values)(got)
        js.bitsize_check_circuit(8, len(vals), values)(want)
        assert (got.a_rows, got.b_rows, got.c_rows) == \
            (want.a_rows, want.b_rows, want.c_rows)
        assert (got.num_instance, got.num_witness) == \
            (want.num_instance, want.num_witness)
        if values is not None:
            assert got.is_satisfied() and [int(v) for v in
                                            got.full_assignment()] == \
                [int(v) for v in want.full_assignment()]


def test_keys_ciphertext_and_commitment(keyed, host_pairing):
    port, ref = keyed
    assert canonical(port.gens) == canonical(ref.gens)
    assert canonical((port.sk, port.ek, port.dk)) == \
        canonical((ref.sk, ref.ek, ref.dk))
    m = random.Random(1533).randrange(tb.R)
    ctp, rp = ts.encrypt(random.Random(1534), tb.Fr(m), port.ek, port.g_i, CB)
    ctr, rr = js.encrypt(random.Random(1534), jb.Fr(m), ref.ek, ref.g_i, CB)
    assert canonical((ctp, rp)) == canonical((ctr, rr))
    assert ts.verify_ciphertext_commitment(ctp, port.ek, port.gens,
                                           device="cpu")
    bad = dataclasses.replace(ctp, commitment=(ctp.commitment
                                               + port.g_i[0]).normalize())
    assert not ts.verify_ciphertext_commitment(bad, port.ek, port.gens,
                                               device="cpu")
    assert not js.verify_ciphertext_commitment(to_ref(bad), ref.ek, ref.gens)


def _decrypt(keyed, monkeypatch, m: int, stand_in: bool):
    """Decrypt m with the variable unset and `PAIRING_BATCH_THRESHOLD` at
    the call's weight (48 pairs in 32 products; the shipped threshold is
    set for 8-bit chunks' 96 in 64), so every chunk's product and base go
    to `TPairing.multi_pairings` as one batch (or, with `stand_in`, to a
    stand-in that records the batch and pairs on the host)."""
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(tpairing, "PAIRING_BATCH_THRESHOLD",
                        3 * N + 2 * N * tpairing.HOST_GROUP_PAIRS)
    port, _ = keyed
    calls = []
    real = tpairing.TPairing.multi_pairings

    def spy(self, groups):
        calls.append([len(g) for g in groups])
        if stand_in:
            return [tb.multi_pairing(g) for g in groups]
        return real(self, groups)

    monkeypatch.setattr(tpairing.TPairing, "multi_pairings", spy)
    ct, _ = ts.encrypt(random.Random(1536), tb.Fr(m), port.ek, port.g_i, CB)
    assert tpairing.pairing_route(3 * N, 2 * N) == "device"
    got, nu = ts.decrypt(ct, port.sk, port.dk, port.g_i, CB, device="cpu")
    assert calls == [[2] * N + [1] * N]
    assert int(got) == m
    return ct, got, nu


def test_decrypt_and_verify(keyed, monkeypatch):
    """A 64-bit attribute (12 zero chunks, whose bases the reference does
    not compute) decrypted on the device route, equal to the reference's
    decryption; its verification on the host route, a wrong message
    rejected by both."""
    port, ref = keyed
    m = random.Random(1535).randrange(1 << 64)
    ct, got, nu = _decrypt(keyed, monkeypatch, m, stand_in=True)
    want = js.decrypt(to_ref(ct), ref.sk, ref.dk, ref.g_i, CB)
    assert canonical((got, nu)) == canonical(want)
    monkeypatch.setenv(ENV, "host")
    assert ts.verify_decryption(ct, got, nu, port.dk, port.g_i, port.gens,
                                CB, device="cpu")
    wrong = got + tb.Fr(1 << 200)                  # chunk 3 changes
    assert not ts.verify_decryption(ct, wrong, nu, port.dk, port.g_i,
                                    port.gens, CB, device="cpu")
    assert not js.verify_decryption(to_ref(ct), jb.Fr(int(wrong)),
                                    to_ref(nu), ref.dk, ref.g_i, ref.gens, CB)


@pytest.mark.slow
def test_decrypt_device_route_plain_kernels(keyed, monkeypatch):
    """The batch itself through the plain kernels: a full-range message,
    48 lanes, 32 final exponentiations (about half a minute)."""
    ct, got, nu = _decrypt(keyed, monkeypatch,
                           random.Random(1537).randrange(tb.R),
                           stand_in=False)
    assert nu == (ct.X_r * int(keyed[0].sk.rho)).normalize()
