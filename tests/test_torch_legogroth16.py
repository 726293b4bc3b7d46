"""The port's LegoGroth16 generator and witness map
(`crypto_tpu_torch/legogroth16/snark.py`) against the reference's, on the
CPU.  The setup runs with the port's fixed-base threshold lowered to 1,
so every fixed-base product goes through the device tables on the plain
versions.  The prover's side is `test_torch_legogroth16_prove.py` (two
files, so the two halves' CPU work runs on two test workers).

A chain circuit of 12 constraints (x_{i+1} = x_i^2 + x_i + i, one public
input, the first witness committed; domain 16), the same trapdoors and
the same rng draws on both sides: the witness map and the proving key,
point by point, must equal the reference's.
"""

import random

import pytest

from crypto_tpu.curves import bls12_381 as rb
from crypto_tpu.legogroth16 import snark as rsnark
from crypto_tpu.r1cs import cs as rcs
from crypto_tpu_torch import convert
from crypto_tpu_torch.curves import bls12_381 as tb
from crypto_tpu_torch.legogroth16 import snark as tsnark
from crypto_tpu_torch.ops.ntt import domain_for
from crypto_tpu_torch.r1cs import cs as tcs
from crypto_tpu_torch.testing import cap_threads

cap_threads()

NC = 12
R = tb.R
TRAPDOORS = [random.Random(41).randrange(1, R) for _ in range(5)]
X0 = random.Random(42).randrange(R)
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def chain_circuit(cs_mod, F, n: int, x_val=None):
    """x_{i+1} = x_i^2 + x_i + i over n constraints; the last value is the
    public input (`benches/bench_northstar.py` `chain_circuit`), written
    against either package's `r1cs.cs`."""
    LC = cs_mod.LinearCombination

    def circuit(cs):
        vals = None
        if x_val is not None:
            vals = [F(x_val)]
            for i in range(n):
                v = vals[-1]
                vals.append(v * v + v + F(i))
        out = cs.new_input(None if vals is None else vals[-1])
        cur = cs.new_witness(None if vals is None else vals[0])
        for i in range(n):
            if i == n - 1:
                nxt, nxt_lc = None, out.lc()
            else:
                nxt = cs.new_witness(None if vals is None else vals[i + 1])
                nxt_lc = nxt.lc()
            cs.enforce(cur.lc(), cur.lc() + LC.constant(F, 1),
                       nxt_lc + LC.constant(F, -i % F.p))
            if nxt is not None:
                cur = nxt
    return circuit


@pytest.fixture(scope="module")
def run():
    ref_pk = rsnark.generate_parameters_with_trapdoors(
        chain_circuit(rcs, rb.Fr, NC), 1, random.Random(6),
        *(rb.Fr(t) for t in TRAPDOORS))
    tables = []
    real_table = tsnark.table_for

    def table(curve, base, **kw):
        tables.append((curve.name, kw["device"]))
        return real_table(curve, base, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsnark, "DEVICE_FIXED_BASE_THRESHOLD", 1)
        mp.setattr(tsnark, "table_for", table)
        pk = tsnark.generate_parameters_with_trapdoors(
            chain_circuit(tcs, tb.Fr, NC), 1, random.Random(6),
            *(tb.Fr(t) for t in TRAPDOORS), device="cpu")
    return dict(ref_pk=ref_pk, pk=pk, tables=tables)


def test_witness_map_equals_reference():
    ref_cs = rcs.ConstraintSystem(rb.Fr, mode="prove")
    chain_circuit(rcs, rb.Fr, NC, X0)(ref_cs)
    cs = tcs.ConstraintSystem(tb.Fr, mode="prove")
    chain_circuit(tcs, tb.Fr, NC, X0)(cs)
    assert cs.is_satisfied() and cs.num_constraints == NC
    assert (cs.a_rows, cs.b_rows, cs.c_rows) == \
        (ref_cs.a_rows, ref_cs.b_rows, ref_cs.c_rows)
    h = tsnark.witness_map(cs, device="cpu")
    assert len(h) == 16
    assert h == rsnark.witness_map(ref_cs)


def test_lagrange_coeffs_equal_reference():
    t = random.Random(3).randrange(R)
    dom = domain_for(tb.Fr, 16, "cpu")
    got = tsnark._lagrange_coeffs_at(dom, t)
    assert got == rsnark._lagrange_coeffs_at(
        rsnark.domain_for(rb.Fr, 16), t)
    # the l_i interpolate: sum_i l_i(t) w^(ij) = t^j
    for j in (0, 1, 5):
        assert sum(c * pow(dom.w, i * j, R) for i, c in enumerate(got)) \
            % R == pow(t, j, R)


def test_proving_key_equals_reference(run):
    pk, ref = run["pk"], convert.proving_key_to_port(run["ref_pk"])
    for name in ("beta_g1", "delta_g1", "eta_delta_inv_g1") + QUERIES:
        assert getattr(pk, name) == getattr(ref, name), name
    assert pk.vk == ref.vk
    assert len(pk.h_query) == 15 and len(pk.a_query) == NC + 2
    assert all(q.Z == q.curve.K.one() or q.is_infinity()
               for name in QUERIES for q in getattr(pk, name))


def test_fixed_base_products_ran_on_the_device_tables(run):
    """Every fixed-base product of the setup went through a device table
    (on the CPU): five G1 queries and gamma_abc, and the G2 query."""
    assert all(str(d) == "cpu" for _, d in run["tables"])
    assert sorted(c for c, _ in run["tables"]) == \
        ["bls12_381.G1"] * 5 + ["bls12_381.G2"]


def test_only_the_ports_bls12_381_is_accepted(run):
    with pytest.raises(tsnark.LegoGroth16Error):
        tsnark.create_proof(chain_circuit(tcs, tb.Fr, NC, X0), run["pk"],
                            random.Random(7), ctx=rb, device="cpu")
    with pytest.raises(tsnark.LegoGroth16Error):
        tsnark.generate_random_parameters(chain_circuit(tcs, tb.Fr, NC), 1,
                                          random.Random(6), ctx=rb,
                                          device="cpu")
