"""The port's KB universal accumulator and keyed-verification accumulator
proofs (`crypto_tpu_torch/accumulator/{kb_universal,kb_universal_witness,
keyed}.py`) against the reference's, on the shapes of the reference's
`tests/test_kb_universal_witness.py` and `tests/test_accum_extra.py`
(domains of 6-16 elements).

Both packages run from the same `random.Random` seed: the two halves'
values, their states, every (non)membership witness (single, batch,
after single updates, after a batch update with the secret key, after
public `Omega` updates, after domain extensions) and the keyed proofs
are equal as canonical integers, and carry across by
`convert.protocol_to_port`.  The port's batch witness methods (the
half's device fixed-base path, on the CPU here) give the reference's
single host witnesses.  One batch update of a half runs the device
update's plain versions under CRYPTO_TPU_FORCE_DEVICE_ACCUM (2 members,
~25 s), with the roles of additions and removals swapped on the
non-member half, and equals the reference's host path.
"""

import importlib
import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu_torch.convert import canonical, protocol_to_port
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.testing import cap_threads

cap_threads()

FORCE, NO = "CRYPTO_TPU_FORCE_DEVICE_ACCUM", "CRYPTO_TPU_NO_DEVICE_ACCUM"


def pkg(root):
    mods = {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("setup", "accumulator.setup"), ("kb", "accumulator.kb_universal"),
        ("kbw", "accumulator.kb_universal_witness"),
        ("pers", "accumulator.persistence"), ("core", "accumulator.core"),
        ("keyed", "accumulator.keyed"), ("serialize", "serialize"),
        ("hashing", "hashing"))}
    mods["b"] = jb if root == "crypto_tpu" else tb
    mods["kw"] = {} if root == "crypto_tpu" else {"device": "cpu"}
    return type("Pkg", (), mods)


REF, PORT = pkg("crypto_tpu"), pkg("crypto_tpu_torch")


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    monkeypatch.delenv(FORCE, raising=False)
    monkeypatch.delenv(NO, raising=False)


def setup(P, rng, domain_size, label=b"kbu-wit"):
    params = P.setup.AccumSetupParams.new(label)
    kp = P.setup.AccumKeypair.generate(rng, params)
    domain = [P.b.Fr.rand(rng) for _ in range(domain_size)]
    ms, ns = P.pers.InMemoryState(), P.pers.InMemoryState()
    acc = P.kb.KBUniversalAccumulator.initialize(params, kp.secret_key,
                                                 domain, ms, ns)
    return params, kp, domain, ms, ns, acc


def run_both(fn, seed):
    out_r = fn(REF, random.Random(seed))
    out_t = fn(PORT, random.Random(seed))
    assert canonical(out_t) == canonical(out_r)
    return out_r, out_t


def test_single_update_laws_parity():
    def laws(P, rng):
        params, kp, domain, ms, ns, acc = setup(P, rng, 12)
        sk, pk, kbw = kp.secret_key, kp.public_key, P.kbw
        acc1 = acc.add(domain[0], sk, ms, ns)
        mw = acc1.get_membership_witness(domain[0], sk, ms)
        nw = acc1.get_non_membership_witness(domain[1], sk, ns)
        old_mem = acc1.mem_value()
        acc2 = acc1.add(domain[2], sk, ms, ns)
        mw2 = kbw.update_mem_wit_on_addition(mw, domain[0], domain[2],
                                             old_mem)
        nw2 = kbw.update_non_mem_wit_on_addition(nw, domain[1], domain[2],
                                                 acc2.non_mem_value())
        old_nm2 = acc2.non_mem_value()
        acc3 = acc2.remove(domain[2], sk, ms, ns)
        mw3 = kbw.update_mem_wit_on_removal(mw2, domain[0], domain[2],
                                            acc3.mem_value())
        nw3 = kbw.update_non_mem_wit_on_removal(nw2, domain[1], domain[2],
                                                old_nm2)
        new = P.b.Fr.rand(rng)
        acc4 = acc3.extend_domain([new], sk, ns)
        nw4 = kbw.update_non_mem_wit_on_domain_extension(
            nw3, domain[1], new, acc3.non_mem_value())
        checks = [acc1.verify_membership(domain[0], mw, pk, params),
                  acc1.verify_non_membership(domain[1], nw, pk, params),
                  acc2.verify_membership(domain[0], mw2, pk, params),
                  acc2.verify_non_membership(domain[1], nw2, pk, params),
                  acc3.verify_membership(domain[0], mw3, pk, params),
                  acc3.verify_non_membership(domain[1], nw3, pk, params),
                  acc4.verify_non_membership(domain[1], nw4, pk, params)]
        return dict(accs=[acc1, acc2, acc3, acc4], wits=[mw, nw, mw2, nw2,
                                                         mw3, nw3, nw4],
                    states=[ms, ns], checks=checks)

    out_r, out_t = run_both(laws, 555)
    assert out_t["checks"] == [True] * 7
    assert canonical(protocol_to_port(out_r)) == canonical(out_t)


def test_batch_updates_parity():
    """Batch witnesses, one batch update with the secret key, the public
    `Omega` updates, two batches in sequence and a domain extension."""
    def batches(P, rng):
        params, kp, domain, ms, ns, acc = setup(P, rng, 16)
        sk, pk, kbw, kw = kp.secret_key, kp.public_key, P.kbw, P.kw
        acc1 = acc.add_batch(domain[:4], sk, ms, ns)
        members, non_members = domain[:2], domain[8:10]
        mws = acc1.get_membership_witnesses_for_batch(members, sk, ms, **kw)
        nws = acc1.get_non_membership_witnesses_for_batch(non_members, sk,
                                                          ns, **kw)
        adds, rems = domain[4:6], [domain[2]]
        old_mem, old_nm = acc1.mem_value(), acc1.non_mem_value()
        omega = kbw.KBUniversalOmega.new(adds, rems, old_mem, old_nm, sk,
                                         **kw)
        acc2 = acc1.batch_updates(adds, rems, sk, ms, ns)
        new_mws = kbw.update_mem_wits_on_batch_updates(
            adds, rems, members, mws, old_mem, sk, **kw)
        new_nws = kbw.update_non_mem_wits_on_batch_updates(
            adds, rems, non_members, nws, old_nm, sk, **kw)
        pub_mws = [kbw.update_mem_wit_using_public_info(
            w, m, adds, rems, omega.mem) for m, w in zip(members, mws)]
        pub_nws = [kbw.update_non_mem_wit_using_public_info(
            w, m, adds, rems, omega.non_mem)
            for m, w in zip(non_members, nws)]
        adds2 = domain[6:8]
        omega2 = kbw.KBUniversalOmega.new(adds2, [], acc2.mem_value(),
                                          acc2.non_mem_value(), sk, **kw)
        acc3 = acc2.add_batch(adds2, sk, ms, ns)
        w_seq = kbw.update_mem_wit_after_multiple_batches(
            mws[0], members[0],
            [(adds, rems, omega.mem), (adds2, [], omega2.mem)])
        wn_seq = kbw.update_non_mem_wit_after_multiple_batches(
            nws[0], non_members[0],
            [(adds, rems, omega.non_mem), (adds2, [], omega2.non_mem)])
        new_elems = [P.b.Fr.rand(rng) for _ in range(2)]
        omega_ext = kbw.generate_omega_for_domain_extension(
            new_elems, acc3.non_mem_value(), sk, **kw)
        ext_sk = kbw.update_non_mem_wits_on_domain_extension(
            new_elems, non_members, [wn_seq, wn_seq], acc3.non_mem_value(),
            sk, **kw)
        acc4 = acc3.extend_domain(new_elems, sk, ns)
        w_ext = kbw.update_non_mem_wit_on_domain_extension_public(
            wn_seq, non_members[0], new_elems, omega_ext)
        w_ext_many = kbw.update_non_mem_wit_after_multiple_domain_extensions(
            wn_seq, non_members[0], [(new_elems, omega_ext)])
        checks = (
            [acc2.verify_membership(m, w, pk, params)
             for ws in (new_mws, pub_mws) for m, w in zip(members, ws)]
            + [acc2.verify_non_membership(m, w, pk, params)
               for ws in (new_nws, pub_nws)
               for m, w in zip(non_members, ws)]
            + [acc3.verify_membership(members[0], w_seq, pk, params),
               acc3.verify_non_membership(non_members[0], wn_seq, pk,
                                          params),
               acc4.verify_non_membership(non_members[0], w_ext, pk, params),
               acc4.verify_non_membership(non_members[0], ext_sk[0], pk,
                                          params)])
        return dict(accs=[acc1, acc2, acc3, acc4], states=[ms, ns],
                    omegas=[omega, omega2, omega_ext],
                    wits=[mws, nws, new_mws, new_nws, pub_mws, pub_nws,
                          w_seq, wn_seq, ext_sk, w_ext, w_ext_many],
                    checks=checks)

    out_r, out_t = run_both(batches, 556)
    assert out_t["checks"] == [True] * 12
    assert canonical(protocol_to_port(out_r)) == canonical(out_t)
    assert type(protocol_to_port(out_r["omegas"][0])) is \
        PORT.kbw.KBUniversalOmega


def test_batch_witnesses_equal_single_witnesses():
    """The port's batch methods (one batch inverse, the half's fixed-base
    path) give the reference's loop of single witnesses, and the port's
    own single witnesses."""
    def wits(P, rng):
        _, kp, domain, ms, ns, acc = setup(P, rng, 12, b"kbu-batch")
        sk = kp.secret_key
        acc = acc.add_batch(domain[:6], sk, ms, ns)
        return (acc.get_membership_witnesses_for_batch(domain[:6], sk, ms,
                                                       **P.kw),
                acc.get_non_membership_witnesses_for_batch(domain[6:], sk,
                                                           ns, **P.kw),
                [acc.get_membership_witness(e, sk, ms) for e in domain[:6]],
                [acc.get_non_membership_witness(e, sk, ns)
                 for e in domain[6:]])

    _, (bm, bn, sm, sn) = run_both(wits, 557)
    assert canonical(bm) == canonical(sm) and canonical(bn) == canonical(sn)
    for P in (REF, PORT):
        _, kp, domain, ms, ns, acc = setup(P, random.Random(1), 4)
        with pytest.raises(P.core.AccumulatorError):
            acc.get_membership_witnesses_for_batch(domain[:1],
                                                   kp.secret_key, ms,
                                                   **P.kw)


def test_forced_device_update_on_non_member_half(monkeypatch):
    """One KB batch update of the non-member half on the device update's
    plain versions (2 members, 1 addition and 1 removal): the device
    function gets the removals as additions and the additions as
    removals, and its witnesses equal the reference's host path."""
    def world(P):
        rng = random.Random(558)
        params, kp, domain, ms, ns, acc = setup(P, rng, 8, b"kbu-dev")
        sk = kp.secret_key
        acc = acc.add_batch(domain[:3], sk, ms, ns)
        tracked = domain[5:7]
        nws = [acc.get_non_membership_witness(e, sk, ns) for e in tracked]
        adds, rems = [domain[3]], [domain[0]]
        new_acc = acc.batch_updates(adds, rems, sk, ms, ns)
        return params, kp, tracked, nws, adds, rems, acc, new_acc

    params, kp, tracked, nws, adds, rems, acc, new_acc = world(REF)
    want = REF.kbw.update_non_mem_wits_on_batch_updates(
        adds, rems, tracked, nws, acc.non_mem_value(), kp.secret_key)
    from crypto_tpu_torch.accumulator import device_update
    calls = []
    real = device_update.batch_update_with_sk_device

    def spy(additions, removals, *a, **kw):
        calls.append((canonical(additions), canonical(removals)))
        return real(additions, removals, *a, **kw)

    monkeypatch.setattr(device_update, "batch_update_with_sk_device", spy)
    monkeypatch.setenv(FORCE, "1")
    params_t, kp_t, tracked_t, nws_t, adds_t, rems_t, acc_t, new_t = \
        world(PORT)
    got = PORT.kbw.update_non_mem_wits_on_batch_updates(
        adds_t, rems_t, tracked_t, nws_t, acc_t.non_mem_value(),
        kp_t.secret_key, device="cpu")
    assert calls == [(canonical(rems_t), canonical(adds_t))]
    assert canonical(got) == canonical(want)
    assert all(new_t.verify_non_membership(e, w, kp_t.public_key, params_t)
               for e, w in zip(tracked_t, got))


def test_kb_universal_membership_flow_parity():
    """`tests/test_accum_extra.py`'s KB flow: every domain element a
    non-member, add, remove, and the refusals."""
    def flow(P, rng):
        params, kp, domain, ms, nms, acc = setup(P, rng, 6, b"kb-accum")
        sk, pk = kp.secret_key, kp.public_key
        nm = [acc.get_non_membership_witness(d, sk, nms) for d in domain]
        checks = [acc.verify_non_membership(d, w, pk, params)
                  for d, w in zip(domain, nm)]
        acc2 = acc.add(domain[0], sk, ms, nms)
        mw = acc2.get_membership_witness(domain[0], sk, ms)
        with pytest.raises(P.core.AccumulatorError):
            acc2.get_non_membership_witness(domain[0], sk, nms)
        acc3 = acc2.remove(domain[0], sk, ms, nms)
        w0 = acc3.get_non_membership_witness(domain[0], sk, nms)
        with pytest.raises(P.core.AccumulatorError):
            acc3.add(P.b.Fr.rand(rng), sk, ms, nms)
        acc4 = acc3.add_batch(domain[1:3], sk, ms, nms).remove_batch(
            domain[1:2], sk, ms, nms)
        checks += [acc2.verify_membership(domain[0], mw, pk, params),
                   acc3.verify_non_membership(domain[0], w0, pk, params),
                   not acc3.verify_membership(domain[0], mw, pk, params)]
        return dict(nm=nm, mw=mw, w0=w0, accs=[acc2, acc3, acc4],
                    values=[acc4.value(), acc4.mem_value(),
                            acc4.non_mem_value()],
                    states=[ms, nms], checks=checks)

    _, out_t = run_both(flow, 1010)
    assert out_t["checks"] == [True] * 9


def test_keyed_membership_proof_parity():
    def keyed(P, rng):
        params = P.setup.AccumSetupParams.new(b"kv-accum")
        kp = P.setup.AccumKeypair.generate(rng, params)
        sk, pk = kp.secret_key, kp.public_key
        state = P.pers.InMemoryState()
        y = P.b.Fr.rand(rng)
        acc = P.core.PositiveAccumulator.initialize(params).add(y, sk, state)
        wit = acc.get_membership_witness(y, sk, state)
        prot = P.keyed.KeyedMembershipProofProtocol.init(rng, y, None, wit,
                                                         acc.value())
        wr = P.serialize.ByteWriter()
        prot.challenge_contribution(acc.value(), wr)
        c = P.hashing.compute_random_oracle_challenge(P.b.Fr, wr.bytes())
        proof = prot.gen_proof(c)
        wr2 = P.serialize.ByteWriter()
        proof.challenge_contribution(acc.value(), wr2)
        keyed = proof.keyed_part()
        pov = keyed.create_proof_of_validity(rng, sk, params.P_tilde,
                                             pk.Q_tilde)
        other = P.setup.AccumSecretKey.generate(rng)
        return dict(
            proof=proof, pov=pov, resp=proof.response_for_element(),
            checks=[wr2.bytes() == wr.bytes(),
                    proof.verify(acc.value(), c, sk),
                    proof.verify(acc.value(), c, other),
                    keyed.verify(sk), keyed.verify(other),
                    pov.verify(keyed, params.P_tilde, pk.Q_tilde),
                    pov.verify(keyed, params.P_tilde,
                               (params.P_tilde * 3).normalize())])

    out_r, out_t = run_both(keyed, 1011)
    assert out_t["checks"] == [True, True, False, True, False, True, False]
    assert canonical(protocol_to_port(out_r["proof"])) == \
        canonical(out_t["proof"])
