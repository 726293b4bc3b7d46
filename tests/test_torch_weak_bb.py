"""The port's weak Boneh-Boyen signatures, their CDH and keyed PoKs
(`crypto_tpu_torch/short_group_sig/weak_bb.py`) and the CDH accumulator
proofs (`crypto_tpu_torch/accumulator/proofs_cdh.py`) against the
reference's (`crypto_tpu/short_group_sig/weak_bb.py`,
`crypto_tpu/accumulator/proofs_cdh.py`).

Each world is built in both packages from the same `random.Random`
seed: keys, signatures, protocols, the challenge contributions byte for
byte, the challenges and the proofs as canonical integers.  Each
package's verifier accepts the other's proof (carried across with
`convert.protocol_to_port` and `to_ref`), on the host and through a
`RandomizedPairingChecker` (the port's on the CPU); spoiled responses
are rejected by both.
"""

import copy
import random
from types import SimpleNamespace

import pytest

from crypto_tpu.accumulator import core as jcore
from crypto_tpu.accumulator import persistence as jpers
from crypto_tpu.accumulator import proofs_cdh as jcdh
from crypto_tpu.accumulator import setup as jsetup
from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu import hashing as jhash
from crypto_tpu import serialize as jser
from crypto_tpu.short_group_sig import weak_bb as jwbb
from crypto_tpu.utils import checkers as jchk
from crypto_tpu_torch.accumulator import core as tcore
from crypto_tpu_torch.accumulator import persistence as tpers
from crypto_tpu_torch.accumulator import proofs_cdh as tcdh
from crypto_tpu_torch.accumulator import setup as tsetup
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch import hashing as thash
from crypto_tpu_torch import serialize as tser
from crypto_tpu_torch.short_group_sig import weak_bb as twbb
from crypto_tpu_torch.testing import cap_threads
from crypto_tpu_torch.utils import checkers as tchk

from test_torch_saver import to_ref

cap_threads()

REF = SimpleNamespace(name="reference", b=jb, wbb=jwbb, cdh=jcdh,
                      setup=jsetup, core=jcore, pers=jpers, hashing=jhash,
                      ser=jser, chk=jchk)
PORT = SimpleNamespace(name="port", b=tb, wbb=twbb, cdh=tcdh, setup=tsetup,
                       core=tcore, pers=tpers, hashing=thash, ser=tser,
                       chk=tchk)


@pytest.fixture(autouse=True)
def host_pairing(monkeypatch):
    """Both checkers pair on the host: the reference's device branch is
    the JAX pairing, and these checkers hold fewer pairs than the port's
    `DEVICE_THRESHOLD`."""
    monkeypatch.setenv("CRYPTO_TPU_PAIRING_BACKEND", "host")


def _challenge(pkg, write):
    w = pkg.ser.ByteWriter()
    write(w)
    return w.bytes(), pkg.hashing.compute_random_oracle_challenge(
        pkg.b.Fr, w.bytes())


def _checker(pkg, rng):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg.chk.RandomizedPairingChecker(pkg.b.Fr.rand(rng), lazy=True,
                                            **kw)


# ---------------------------------------------------------------------------
# weak-BB signature and its PoKs
# ---------------------------------------------------------------------------

def _weak_bb_world(pkg, seed):
    rng = random.Random(seed)
    F = pkg.b.Fr
    g1, g2 = pkg.b.G1.generator(), pkg.b.G2.generator()
    sk = pkg.wbb.WeakBBSecretKey.generate(rng)
    pk = pkg.wbb.WeakBBPublicKeyG2.generate(sk, g2)
    m = F.rand(rng)
    sig = pkg.wbb.WeakBBSig.new(m, sk, g1)
    prot = pkg.wbb.PoKWeakBBSigProtocol.init(rng, sig, m, g1)
    wbytes, c = _challenge(pkg, lambda w: prot.challenge_contribution(g1, w))
    proof = prot.gen_proof(c)
    kv = pkg.wbb.PoKWeakBBSigKVProtocol.init(rng, sig, m, g1)
    kbytes, kc = _challenge(pkg, lambda w: kv.challenge_contribution(g1, w))
    return SimpleNamespace(rng=rng, g1=g1, g2=g2, sk=sk, pk=pk, m=m, sig=sig,
                           prot=prot, wbytes=wbytes, c=c, proof=proof,
                           kbytes=kbytes, kc=kc, kv=kv.gen_proof(kc))


@pytest.fixture(scope="module")
def weak_bb():
    return _weak_bb_world(REF, 4401), _weak_bb_world(PORT, 4401)


def test_weak_bb_signature_and_pok_match(weak_bb):
    r, t = weak_bb
    for name in ("sk", "pk", "m", "sig", "prot", "c", "proof", "kc", "kv"):
        assert canonical(getattr(r, name)) == canonical(getattr(t, name)), \
            name
    assert r.wbytes == t.wbytes and r.kbytes == t.kbytes
    assert t.sig.verify(t.m, t.pk, t.g1, t.g2)
    assert not t.sig.verify(t.m + tb.Fr(1), t.pk, t.g1, t.g2)


def test_weak_bb_pok_cross_verify(weak_bb):
    r, t = weak_bb
    mine = protocol_to_port(r.proof)
    assert canonical(mine) == canonical(t.proof)
    for proof in (t.proof, mine):
        assert proof.verify(t.c, t.pk, t.g1, t.g2)
        chk = _checker(PORT, t.rng)
        assert proof.verify_with_pairing_checker(t.c, t.pk, t.g1, t.g2, chk)
        assert chk.verify()
        assert proof.get_resp_for_message() == proof.sc.response2
    theirs = to_ref(t.proof)
    assert theirs.verify(r.c, r.pk, r.g1, r.g2)
    chk = _checker(REF, r.rng)
    assert theirs.verify_with_pairing_checker(r.c, r.pk, r.g1, r.g2, chk)
    assert chk.verify()


@pytest.mark.parametrize("spoil", ["response1", "response2", "A_bar"])
def test_weak_bb_pok_spoiled_rejected(weak_bb, spoil):
    r, t = weak_bb
    for pkg, w in ((PORT, t), (REF, r)):
        bad = copy.deepcopy(w.proof)
        if spoil == "A_bar":
            bad.A_bar = (bad.A_bar + w.g1).normalize()
        else:
            setattr(bad.sc, spoil, getattr(bad.sc, spoil) + pkg.b.Fr(1))
        assert not bad.verify(w.c, w.pk, w.g1, w.g2), pkg.name
        chk = _checker(pkg, w.rng)
        ok = bad.verify_with_pairing_checker(w.c, w.pk, w.g1, w.g2, chk)
        assert not (ok and chk.verify()), pkg.name


def test_weak_bb_kv_pok(weak_bb):
    r, t = weak_bb
    assert t.kv.verify(t.kc, t.sk, t.g1)
    assert to_ref(t.kv).verify(r.kc, r.sk, r.g1)
    assert protocol_to_port(r.kv).verify(t.kc, t.sk, t.g1)
    assert t.kv.response_for_message() == t.kv.sc.response2
    other = twbb.WeakBBSecretKey(t.sk.x + tb.Fr(1))
    assert not t.kv.verify(t.kc, other, t.g1)
    bad = copy.deepcopy(t.kv)
    bad.sc.response1 = bad.sc.response1 + tb.Fr(1)
    assert not bad.verify(t.kc, t.sk, t.g1)


# ---------------------------------------------------------------------------
# CDH accumulator proofs
# ---------------------------------------------------------------------------

def _accum_world(pkg, seed):
    rng = random.Random(seed)
    F = pkg.b.Fr
    params = pkg.setup.AccumSetupParams.new(b"cdh-accum")
    kp = pkg.setup.AccumKeypair.generate(rng, params)
    members = [F.rand(rng) for _ in range(3)]
    st = pkg.pers.InMemoryState()
    acc = pkg.core.PositiveAccumulator.initialize(params)
    acc = acc.add_batch(members, kp.secret_key, st)
    y = members[1]
    wit = acc.get_membership_witness(y, kp.secret_key, st)
    V = acc.value()
    prot = pkg.cdh.MembershipProofProtocol.init(rng, y, None, wit, V)
    mbytes, mc = _challenge(pkg, lambda w: prot.challenge_contribution(V, w))
    mem = prot.gen_proof(mc)

    ust = pkg.pers.InMemoryState()
    uacc = pkg.core.UniversalAccumulator.initialize(
        rng, params, 8, kp.secret_key, pkg.pers.InMemoryInitialElements())
    uacc = uacc.add_batch(members, kp.secret_key, ust)
    z = F.rand(rng)
    nwit = uacc.get_non_membership_witness(z, kp.secret_key, ust, params)
    Q = pkg.b.G1.rand(rng).normalize()
    U = uacc.value()
    nprot = pkg.cdh.NonMembershipProofProtocol.init(rng, z, None, nwit, U,
                                                    params, Q)
    nbytes, nc = _challenge(
        pkg, lambda w: nprot.challenge_contribution(U, params, Q, w))
    non = nprot.gen_proof(nc)
    return SimpleNamespace(rng=rng, params=params, kp=kp, V=V, y=y, wit=wit,
                           mbytes=mbytes, mc=mc, mem=mem, U=U, z=z, nwit=nwit,
                           Q=Q, nbytes=nbytes, nc=nc, non=non)


@pytest.fixture(scope="module")
def accum():
    return _accum_world(REF, 4402), _accum_world(PORT, 4402)


def test_cdh_proofs_match(accum):
    r, t = accum
    for name in ("kp", "V", "y", "wit", "mc", "mem", "U", "z", "nwit", "Q",
                 "nc", "non"):
        assert canonical(getattr(r, name)) == canonical(getattr(t, name)), \
            name
    assert r.mbytes == t.mbytes and r.nbytes == t.nbytes
    w = tser.ByteWriter()
    t.mem.challenge_contribution(t.V, w)
    assert w.bytes() == t.mbytes


def _verify_mem(pkg, w, proof, checker=None):
    pk = w.kp.public_key
    if checker is None:
        return proof.verify(w.V, w.mc, pk, w.params)
    return proof.verify_with_pairing_checker(w.V, w.mc, pk, w.params,
                                             checker) and checker.verify()


def _verify_non(pkg, w, proof, checker=None):
    pk = w.kp.public_key
    if checker is None:
        return proof.verify(w.U, w.nc, pk, w.params, w.Q)
    return proof.verify_with_pairing_checker(w.U, w.nc, pk, w.params, w.Q,
                                             checker) and checker.verify()


@pytest.mark.parametrize("kind", ["membership", "non_membership"])
def test_cdh_proofs_cross_verify(accum, kind):
    r, t = accum
    verify = _verify_mem if kind == "membership" else _verify_non
    name = "mem" if kind == "membership" else "non"
    for proof in (getattr(t, name), protocol_to_port(getattr(r, name))):
        assert verify(PORT, t, proof)
        assert verify(PORT, t, proof, _checker(PORT, t.rng))
    theirs = to_ref(getattr(t, name))
    assert verify(REF, r, theirs)
    assert verify(REF, r, theirs, _checker(REF, r.rng))
    resp = getattr(t, name).get_schnorr_response_for_element()
    assert int(resp) == int(getattr(r, name).get_schnorr_response_for_element())


@pytest.mark.parametrize("spoil", ["mem_response", "mem_value",
                                   "non_response", "non_J", "non_shared_d"])
def test_cdh_proofs_spoiled_rejected(accum, spoil):
    r, t = accum
    for pkg, w in ((PORT, t), (REF, r)):
        one = pkg.b.Fr(1)
        if spoil.startswith("mem"):
            bad = copy.deepcopy(w.mem)
            if spoil == "mem_response":
                bad.inner.sc.response2 = bad.inner.sc.response2 + one
                ww = w
            else:
                ww = SimpleNamespace(**vars(w))
                ww.V = (w.V * 3).normalize()
            verify = _verify_mem
        else:
            bad = copy.deepcopy(w.non)
            ww = w
            if spoil == "non_response":
                bad.sc_resp.responses[1] = bad.sc_resp.responses[1] + one
            elif spoil == "non_J":
                bad.J = (bad.J + w.Q).normalize()
            else:
                bad.sc_J.response = bad.sc_J.response + one
            verify = _verify_non
        assert not verify(pkg, ww, bad), (pkg.name, spoil)
        assert not verify(pkg, ww, bad, _checker(pkg, w.rng)), \
            (pkg.name, spoil)
