"""The port's BBS# (`crypto_tpu_torch/kvac/bbs_sharp/`) and its secp256r1
(`curves/extra_curves.py`) against the reference's, on the flows of the
reference's `tests/test_bbs_sharp.py`: MAC issuance and its proof of
validity (plain and designated-verifier), PoKs of the MAC with a Schnorr
or an ECDSA hardware signature and with a designated verifier, and HOL
tokens.  Each flow runs in both packages from the same `random.Random`
seed; every object (params, keys, MACs, proofs, tokens, the hardware
signatures) is equal as canonical integers, the reference's objects
carried across (`convert.protocol_to_port`, points onto the port's
secp256r1) are accepted by the port, and wrong messages, keys and
revealed values are refused by both.
"""

import importlib
import random
from types import SimpleNamespace

import pytest

from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import extra_curves as port_curves
from crypto_tpu_torch.testing import cap_threads

cap_threads()

N_MSGS = 5


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("bs", "kvac.bbs_sharp"), ("ec", "curves.extra_curves"),
        ("hashing", "hashing"), ("ser", "serialize"),
        ("mob", "bbs_plus.proof"), ("ss", "utils.schnorr_signature"))}
    return SimpleNamespace(**mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


def setup(P, rng, ecdsa_hw=False):
    F = P.ec.secp256r1.scalar_field
    params = P.bs.MACParams.new(b"bbs-sharp-test", N_MSGS)
    if ecdsa_hw:
        params.g = P.ec.secp256r1.generator().normalize()
    ssk = P.bs.SecretKey.new(rng, F)
    spk = P.bs.SignerPublicKey.new_from_params(ssk, params)
    usk = P.bs.SecretKey.new(rng, F)
    upk = P.bs.UserPublicKey.new_from_params(usk, params)
    messages = [F.rand(rng) for _ in range(N_MSGS)]
    mac = P.bs.MAC.new(rng, messages, upk, ssk, params)
    return SimpleNamespace(F=F, params=params, ssk=ssk, spk=spk, usk=usk,
                           upk=upk, messages=messages, mac=mac)


def both(fn, seed):
    """fn(P, rng) in each package from one seed, a dict of results; their
    canonical forms (but the world "w") asserted equal; (reference's,
    port's)."""
    r = fn(REF, random.Random(seed))
    t = fn(PORT, random.Random(seed))

    def kept(d):
        return {k: v for k, v in d.items() if k != "w"}

    assert canonical(kept(t)) == canonical(kept(r))
    return r, t


def test_curves_and_ecdsa_parity():
    def run(P, rng):
        sk, pk = P.ec.ecdsa_keygen(rng)
        h = bytes(range(32))
        sig = P.ec.ecdsa_sign(rng, h, sk)
        assert P.ec.ecdsa_verify(h, sig, pk)
        assert not P.ec.ecdsa_verify(bytes(32), sig, pk)
        tom = P.ec.tom256.generator().mul_raw(12345)
        return dict(sk=sk, pk=pk, sig=sig, tom=tom)

    r, t = both(run, 256)
    assert canonical(protocol_to_port(r["pk"])) == canonical(t["pk"])
    assert protocol_to_port(r["pk"]).curve is port_curves.secp256r1
    assert port_curves.TOM_N == port_curves.P256_P
    assert t["tom"].is_on_curve()


def test_mac_and_validity_proof():
    def run(P, rng):
        w = setup(P, rng)
        assert w.mac.verify(w.messages, w.upk, w.ssk, w.params)
        bad = [w.messages[0] + w.F(1)] + w.messages[1:]
        assert not w.mac.verify(bad, w.upk, w.ssk, w.params)
        pv = P.bs.ProofOfValidityOfMAC.new(rng, w.mac, w.ssk, w.spk,
                                           w.params)
        assert pv.verify(w.mac, w.messages, w.upk, w.spk, w.params)
        assert not pv.verify(w.mac, bad, w.upk, w.spk, w.params)
        dv = P.bs.ProofOfValidityOfMAC.new(rng, w.mac, w.ssk, w.spk,
                                           w.params, user_public_key=w.upk)
        assert dv.designated_verifier_pk_proof is not None
        assert dv.verify(w.mac, w.messages, w.upk, w.spk, w.params)
        return dict(params=w.params, keys=(w.ssk, w.spk, w.usk, w.upk),
                    mac=w.mac, pv=pv, dv=dv, w=w)

    r, t = both(run, 71)
    carried = protocol_to_port(
        {k: r[k] for k in ("params", "keys", "mac", "pv", "dv")})
    assert canonical(carried) == canonical(
        {k: t[k] for k in ("params", "keys", "mac", "pv", "dv")})
    w = t["w"]
    assert carried["mac"].verify(w.messages, w.upk, w.ssk, w.params)
    assert carried["dv"].verify(carried["mac"], w.messages, w.upk, w.spk,
                                w.params)


def pok_flow(P, rng, hw, verifier=False):
    w = setup(P, rng, ecdsa_hw=(hw == "ecdsa"))
    vpk = None
    if verifier:
        vsk = P.bs.SecretKey.new(rng, w.F)
        vpk = (w.params.g_tilde * int(vsk.x)).normalize()
    revealed = {0: w.messages[0], 2: w.messages[2]}
    MoB = P.mob.MessageOrBlinding
    mbs = [MoB.reveal_message(m) if i in revealed else MoB.blind_randomly(m)
           for i, m in enumerate(w.messages)]
    pok = P.bs.PoKOfMACProtocol.init(rng, w.mac, w.params, mbs, w.upk,
                                     hw_sig_type=hw, verifier_pub_key=vpk)
    wr = P.ser.ByteWriter()
    pok.challenge_contribution(revealed, w.params, wr)
    chal = P.hashing.compute_random_oracle_challenge(w.F, bytes(wr.buf))
    auth = b"session-binding-12345"
    if hw == "schnorr":
        hw_sig = P.ss.SchnorrSignature.new(rng, auth, w.usk.x, w.params.g)
        tsig = pok.transform_schnorr_sig(hw_sig)
    else:
        m = w.F(int.from_bytes(auth, "big"))
        m_t = pok.transform_message_for_ecdsa_sig(m)
        hw_sig = P.ec.ecdsa_sign(rng, int(m_t).to_bytes(32, "big"),
                                 int(w.usk.x))
        tsig = pok.transform_ecdsa_sig(hw_sig)
    proof = pok.gen_proof(chal)
    if hw == "schnorr":
        assert tsig.verify(auth, proof.blinded_pk, w.params.g)
    else:
        assert P.ec.ecdsa_verify(int(m).to_bytes(32, "big"), tsig,
                                 proof.blinded_pk)
    assert proof.verify(revealed, chal, w.ssk, w.params,
                        verifier_pub_key=vpk)
    assert proof.to_keyed_proof().verify(w.ssk)
    bad = dict(revealed)
    bad[0] = revealed[0] + w.F(1)
    assert not proof.verify(bad, chal, w.ssk, w.params, verifier_pub_key=vpk)
    other = P.bs.SecretKey.new(rng, w.F)
    assert not proof.verify(revealed, chal, other, w.params,
                            verifier_pub_key=vpk)
    return dict(proof=proof, hw_sig=hw_sig, tsig=tsig, chal=chal,
                revealed=revealed, w=w, vpk=vpk)


@pytest.mark.parametrize("hw, verifier", [("schnorr", False),
                                          ("ecdsa", False),
                                          ("schnorr", True)],
                         ids=["schnorr", "ecdsa", "designated_verifier"])
def test_pok_of_mac(hw, verifier):
    r, t = both(lambda P, rng: pok_flow(P, rng, hw, verifier), 72)
    assert (t["proof"].designated_verifier_pk_proof is not None) == verifier
    w = t["w"]
    carried = protocol_to_port(r["proof"])
    assert carried.hw_sig_type == hw
    assert carried.verify(t["revealed"], t["chal"], w.ssk, w.params,
                          verifier_pub_key=t["vpk"])
    rev_ids = set(t["revealed"])
    assert t["proof"].get_resp_for_message(3, rev_ids) == \
        carried.get_resp_for_message(3, rev_ids)


def test_hol_tokens():
    def run(P, rng):
        w = setup(P, rng)
        user = P.bs.HOLUserProtocol.init(rng, 3, w.mac, w.messages, w.upk,
                                         w.params)
        signer, pre = P.bs.HOLSignerProtocol.init(rng, 3, w.mac.A, w.params)
        blinded = user.compute_challenge(pre, w.params,
                                         nonces=[b"n0", b"n1", b"n2"])
        tokens, pvs = user.process_response(
            signer.compute_response(blinded, w.ssk))
        assert all(pv.verify(w.spk, w.params, nonce=n)
                   for pv, n in zip(pvs, [b"n0", b"n1", b"n2"]))
        assert not pvs[0].verify(w.spk, w.params, nonce=b"n1")
        revealed = {1: w.messages[1]}
        MoB = P.mob.MessageOrBlinding
        mbs = [MoB.reveal_message(m) if i in revealed
               else MoB.blind_randomly(m) for i, m in enumerate(w.messages)]
        pok = P.bs.PoKOfMACProtocol.init_using_token(
            rng, tokens[0], pvs[0], w.params, mbs, w.upk)
        wr = P.ser.ByteWriter()
        pok.challenge_contribution(revealed, w.params, wr)
        chal = P.hashing.compute_random_oracle_challenge(w.F, bytes(wr.buf))
        proof = pok.gen_proof(chal)
        assert proof.verify_given_proof_of_validity(revealed, chal, w.spk,
                                                    w.params, nonce=b"n0")
        assert proof.verify(revealed, chal, w.ssk, w.params)
        wrong = P.bs.SignerPublicKey.new_from_params(
            P.bs.SecretKey.new(rng, w.F), w.params)
        assert not proof.verify_given_proof_of_validity(
            revealed, chal, wrong, w.params, nonce=b"n0")
        return dict(pre=pre, blinded=blinded, tokens=tokens, pvs=pvs,
                    proof=proof)

    r, t = both(run, 73)
    carried = protocol_to_port(r["pvs"])
    assert canonical(carried) == canonical(t["pvs"])
