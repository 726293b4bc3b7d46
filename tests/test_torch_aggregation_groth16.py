"""The port's SnarkPack aggregation without D against the reference's:
`aggregate_proofs_using_groth16` (D withheld from the IPA and returned
beside the aggregate) on two proofs made as `test_torch_aggregation.py`
makes them, equal to the reference's element for element, as is
`aggregate_proofs` of the proofs with d = None (the proof system's form
without D); both
verifiers (`verify_aggregate_proof_using_groth16`) accept it, and the
port's rejects a spoiled D and a wrong transcript label; the same
aggregate through `verify_aggregate_proof` with `prepared_inputs`
(SAVER's path: each proof's gamma_abc[0] + x gamma_abc[1] + D, folded by
the verifier with the r-powers) accepted by both, a spoiled prepared
input rejected by the port's.  The pairings run on the host
(`CRYPTO_TPU_PAIRING_BACKEND=host`).
"""

import random

import pytest

from crypto_tpu.legogroth16 import aggregation as jagg
from crypto_tpu.transcript.transcript import Transcript as JTranscript
from crypto_tpu_torch.convert import canonical
from crypto_tpu_torch.legogroth16 import aggregation as tagg
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.testing import cap_threads
from crypto_tpu_torch.transcript.transcript import Transcript as TTranscript
from test_torch_aggregation import ENV, _state, _verify
from test_torch_saver import to_ref

cap_threads()


@pytest.fixture(scope="module")
def two():
    return _state(2, 1561)


def _g16(pkg, T, st, agg, d, label=b"agg"):
    port = pkg is tagg
    extra = {"device": "cpu"} if port else {}
    return pkg.verify_aggregate_proof_using_groth16(
        (st["spec_p"] if port else st["spec_r"])[1],
        st["pk"].vk if port else st["vk_r"],
        st["publics"] if port else st["publics_r"], agg, d,
        random.Random(1562), T(label), **extra)


def test_using_groth16_and_prepared_inputs(two, monkeypatch):
    monkeypatch.setenv(ENV, "host")
    agg, d = tagg.aggregate_proofs_using_groth16(
        two["spec_p"][0], TTranscript(b"agg"), two["proofs"], device="cpu")
    want, d_r = jagg.aggregate_proofs_using_groth16(
        two["spec_r"][0], JTranscript(b"agg"), two["proofs_r"])
    assert canonical((agg, d)) == canonical((want, d_r))
    assert agg.com_d is None and agg.z_d is None
    # the proof system's form without D: the proofs with d = None
    bare = [tsnark.Proof(p.a, p.b, p.c, None) for p in two["proofs"]]
    assert canonical(tagg.aggregate_proofs(
        two["spec_p"][0], TTranscript(b"agg"), bare, device="cpu")) == \
        canonical(want)
    assert _g16(tagg, TTranscript, two, agg, d)
    assert _g16(jagg, JTranscript, two, want, d_r)
    assert not _g16(tagg, TTranscript, two, agg, [d[1], d[0]])
    assert not _g16(tagg, TTranscript, two, agg, d, label=b"other")

    vk = two["pk"].vk
    prep = [(tsnark.prepare_inputs(vk, pub) + p.d).normalize()
            for pub, p in zip(two["publics"], two["proofs"])]
    assert _verify(tagg, TTranscript, two, agg, prepared_inputs=prep)
    assert _verify(jagg, JTranscript, two, want,
                   prepared_inputs=to_ref(prep))
    prep_bad = [prep[0], (prep[1] + vk.gamma_abc_g1[1]).normalize()]
    assert not _verify(tagg, TTranscript, two, agg,
                       prepared_inputs=prep_bad)
