"""The port's randomized checkers against the reference's.

`RandomizedMultChecker` and `RandomizedPairingChecker`
(`crypto_tpu_torch/utils/checkers.py`) against
`crypto_tpu/utils/checkers.py` on the same random weight and the same
inputs carried across by `convert`, on valid and spoiled checks: the same
verdicts and the same accumulated values.  The lazy pairing checker holds
nine deferred pairs, so the port's `_miller` runs `TPairing` on the CPU
(the reference's runs its host Miller loop, `CRYPTO_TPU_PAIRING_BACKEND`
set per test); the backend switch itself is checked against stand-ins.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as jb
from crypto_tpu.utils import checkers as jc
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.utils import checkers as tc
from crypto_tpu_torch.testing import cap_threads

cap_threads()

R = tb.R
ENV = "CRYPTO_TPU_PAIRING_BACKEND"


def _g1(mod, k):
    return mod.G1.generator().mul_raw(k % R)


def _g2(mod, k):
    return mod.G2.generator().mul_raw(k % R)


def _mult_inputs(mod, spoil: bool):
    """Three checks sum_i P_i s_i = T (one of each arity, a repeated
    point among them), from known logs; the last target off by G if
    `spoil`."""
    rng = random.Random(31)
    logs = [rng.randrange(1, R) for _ in range(4)]
    s = [rng.randrange(R) for _ in range(6)]
    P = [_g1(mod, x) for x in logs]
    t1 = _g1(mod, logs[0] * s[0])
    t2 = _g1(mod, logs[1] * s[1] + logs[2] * s[2])
    t3 = _g1(mod, logs[0] * s[3] + logs[3] * s[4] + logs[2] * s[5]
             + (1 if spoil else 0))
    F = mod.Fr
    return ((P[0], F(s[0]), t1), (P[1], F(s[1]), P[2], F(s[2]), t2),
            (P[0], F(s[3]), P[3], F(s[4]), P[2], F(s[5]), t3))


@pytest.mark.parametrize("spoil", [False, True], ids=["accept", "reject"])
def test_mult_checker_vs_reference(spoil):
    r = random.Random(32).randrange(1, R)
    out = []
    for mod, checkers in ((jb, jc), (tb, tc)):
        c = checkers.RandomizedMultChecker(mod.Fr(r))
        a1, a2, a3 = _mult_inputs(mod, spoil)
        c.add_1(*a1)
        c.add_2(*a2)
        c.add_3(*a3)
        c.add_many([a1[0]], [a1[1]], a1[2])
        out.append((c.verify(), [int(s) for s in c.scalars],
                    [convert.point_ints(p) for p in c.points]))
    assert out[0] == out[1]
    assert out[1][0] is (not spoil)
    assert tc.RandomizedMultChecker(tb.Fr(r)).verify()


def _pairing_checks(mod, spoil: bool, multi: int = 3):
    """Checks from known logs: add_sources (e(xG1, yG2) == e(xy/z G1,
    zG2)), add_multiple_sources over `multi` such pairs, and
    add_sources_and_target against a host target; one d off by a factor
    if `spoil`.  Returns the list of (method, args)."""
    rng = random.Random(33)
    rows = []
    for i in range(1 + multi):
        x, y, z = (rng.randrange(1, R) for _ in range(3))
        w = x * y * pow(z, -1, R) % R
        if spoil and i == multi:
            w = w * 2 % R
        rows.append((_g1(mod, x), _g2(mod, y), _g1(mod, w), _g2(mod, z)))
    a, b = _g1(mod, rng.randrange(1, R)), _g2(mod, rng.randrange(1, R))
    target = jb.pairing(*convert.carry_pairs([(a, b)], jb.G1, jb.G2)[0])
    return [("add_sources", rows[0]),
            ("add_multiple_sources", tuple(zip(*rows[1:]))),
            ("add_sources_and_target", (a, b, convert.carry_fp12(
                target, mod.Fq12)))]


def _run(checker, checks):
    for name, args in checks:
        getattr(checker, name)(*args)
    return checker


@pytest.mark.parametrize("spoil", [False, True], ids=["accept", "reject"])
def test_pairing_checker_eager_vs_reference(spoil, monkeypatch):
    """Not lazy: every check's Miller loop on the host as it is added; the
    accumulated left and right sides equal the reference's."""
    monkeypatch.delenv(ENV, raising=False)
    r = random.Random(34).randrange(1, R)
    ref = _run(jc.RandomizedPairingChecker(jb.Fr(r)),
               _pairing_checks(jb, spoil, multi=1))
    port = _run(tc.RandomizedPairingChecker(tb.Fr(r), device="cpu"),
                _pairing_checks(tb, spoil, multi=1))
    for side in ("left", "right"):
        assert convert.fp12_ints(getattr(port, side)) \
            == convert.fp12_ints(getattr(ref, side))
    assert port.verify() is ref.verify() is (not spoil)


@pytest.mark.parametrize("spoil", [False, True], ids=["accept", "reject"])
def test_pairing_checker_lazy_on_the_device_path(spoil, monkeypatch):
    """Lazy, nine deferred pairs: the port's verify runs `TPairing` on the
    CPU (no backend set), the reference's its host Miller loop."""
    r = random.Random(35).randrange(1, R)
    monkeypatch.setenv(ENV, "host")
    ref = _run(jc.RandomizedPairingChecker(jb.Fr(r), lazy=True),
               _pairing_checks(jb, spoil))
    want = ref.verify()
    monkeypatch.delenv(ENV)
    port = _run(tc.RandomizedPairingChecker(tb.Fr(r), lazy=True,
                                            device="cpu"),
                _pairing_checks(tb, spoil))
    assert len(port.pending) == 9 >= port.DEVICE_THRESHOLD
    assert [tuple(convert.point_ints(p.normalize()) for p in pq)
            for pq in port.pending] \
        == [tuple(convert.point_ints(p.normalize()) for p in pq)
            for pq in ref.pending]
    assert port.verify() is want is (not spoil)


def test_lazy_miller_product_equals_host(monkeypatch):
    """The device Miller product of the deferred pairs equals the host
    Miller loop of the reference on the same pairs."""
    monkeypatch.delenv(ENV, raising=False)
    port = _run(tc.RandomizedPairingChecker(tb.Fr(7), lazy=True,
                                            device="cpu"),
                _pairing_checks(tb, False))
    ref_pairs = [convert.carry_pairs([pq], jb.G1, jb.G2)[0]
                 for pq in port.pending]
    assert convert.fp12_ints(port._miller(port.pending)) \
        == convert.fp12_ints(jb.miller_loop(ref_pairs))


@pytest.mark.parametrize("env, n, device", [
    (None, 7, False), (None, 8, True), ("host", 8, False),
    ("device", 2, True)])
def test_pairing_backend_choice(env, n, device, monkeypatch):
    """`_miller` takes the device from DEVICE_THRESHOLD pairs on, the host
    below it or under CRYPTO_TPU_PAIRING_BACKEND=host, the device under
    `device` (stand-ins record which ran)."""
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    ran = []

    class Stub:
        def miller_product(self, pairs):
            ran.append("device")
            return tb.Fq12.one()

    monkeypatch.setattr(tc, "tpairing_for", lambda name, dev: Stub())
    monkeypatch.setattr(tc.bl, "miller_loop",
                        lambda pairs: ran.append("host") or tb.Fq12.one())
    c = tc.RandomizedPairingChecker(tb.Fr(3), lazy=True, device="cpu")
    pairs = [(tb.G1.generator(), tb.G2.generator())] * n
    c._miller(pairs)
    assert ran == ["device" if device else "host"]
