"""Whole updates of the port's device twin against the reference's host
path: additions only and removals only, 2 members each, on the CPU.

`batch_update_with_sk_device` of `crypto_tpu_torch/accumulator/
device_update.py` (the port's twin of the reference's device function,
run here on the plain versions) against
`crypto_tpu/accumulator/witness.py` `_batch_update_with_sk` (the
reference's host polynomials and scalar multiplications), exact: the d
factors and the new witnesses, which also pass the membership check
against the updated accumulator value.  The mixed case is in
`test_torch_accumulator_device.py`; each case is 255 double-and-add steps
over 4 lanes (~25 s here).
"""

import pytest

from crypto_tpu.accumulator import witness as jwit
from crypto_tpu.accumulator.setup import AccumSecretKey as JSecretKey
from crypto_tpu_torch.accumulator import device_update as tdu
from crypto_tpu_torch.convert import point_ints
from crypto_tpu_torch.curves import bls12_381 as tb
from test_torch_accumulator_device import port_args, update_inputs
from crypto_tpu_torch.testing import cap_threads

cap_threads()


@pytest.mark.parametrize("n_add,n_rem", [(4, 0), (0, 3)],
                         ids=["additions", "removals"])
def test_device_twin_vs_reference_host(n_add, n_rem):
    alpha, adds, rems, members, Cs, V = update_inputs(25 + n_rem, n_add,
                                                      n_rem)
    host = jwit._batch_update_with_sk(adds, rems, members, Cs, V,
                                      JSecretKey(alpha))
    args = port_args(alpha, adds, rems, members, Cs, V)
    d, pts = tdu.batch_update_with_sk_device(*args, device="cpu")
    assert [int(x) for x in d] == [int(x) for x in host[0]]
    assert [point_ints(p.normalize()) for p in pts] == \
        [point_ints(p.normalize()) for p in host[1]]
    # C' = V' / (y + alpha), V' the accumulator after the batch
    a = int(alpha)
    scale = 1
    for y in adds:
        scale = scale * (int(y) + a) % tb.R
    for y in rems:
        scale = scale * pow(int(y) + a, -1, tb.R) % tb.R
    V2 = args[4].mul_raw(scale)
    for m, p in zip(members, pts):
        assert p == V2.mul_raw(pow(int(m) + a, -1, tb.R))
