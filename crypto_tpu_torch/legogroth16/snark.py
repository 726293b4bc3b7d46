"""LegoGroth16 cc-SNARK: the generator and the prover on the device, the
verifier and proof rerandomisation on the host.

The port's counterpart of `crypto_tpu/legogroth16/snark.py` (reference
`legogroth16/src/{generator,prover,verifier}.rs`, `data_structures.rs`):
Groth16 with a Pedersen commitment to a prefix of the witnesses, over
BLS12-381 by default or BN254 (Circom's bn128): every entry point takes
`ctx`, the port's `curves.bls12_381` or `curves.bn254`.

CRS (trapdoors alpha, beta, gamma, delta, eta and tau):
  vk:  alpha*G1, beta*G2, gamma*G2, delta*G2,
       gamma_abc[i] = (beta*a_i + alpha*b_i + c_i)/gamma for the publics
       and the `commit_witness_count` committed witnesses, eta/gamma * G1
  pk:  beta*G1, delta*G1, eta/delta * G1, the per-variable a/b queries,
       h_query[i] = (Z(tau)/delta) tau^i * G1, l_query = the remaining
       witnesses' (beta*a + alpha*b + c)/delta * G1

Prove (r, s, v random; v is the commitment's randomness):
  h = the QAP witness map (`witness_map`: the rows on the host, then
      `qap_h` on the device: 3 iNTTs, 3 coset NTTs, pointwise work and a
      coset iNTT, `r1cs_to_qap.rs:150-209`)
  A = alpha + delta*r + sum a_i z_i
  B = beta + delta*s + sum b_i z_i           (G2; a G1 copy for C)
  C = A*s + B1*r - rs*delta + <l_query, uncommitted> + <h_query, h>
      - v * eta/delta
  D = <gamma_abc[committed slots], committed wits> + v * eta/gamma

Verify: e(A, B) == e(alpha, beta) e(inputs + D, gamma) e(C, delta), as
one host multi-pairing of `ctx` (`ctx.multi_pairing`) against a prepared
e(alpha, beta), as the reference's verifier does; `verify_commitment`
opens D with v.

The device work: the NTTs (`ops/ntt.py`), the query MSMs from
`DEVICE_MSM_THRESHOLD` points on (`ops/msm_v2.py`, each query packed once
and kept on the device in `ProvingKey.device_cache`) and the CRS's
fixed-base products from `DEVICE_FIXED_BASE_THRESHOLD` scalars on
(`ops/fixed_base.py`), normalised there by one batched inversion a query
before they come to the host.  Below the thresholds the host does the work.
Every entry point of the generator and the prover runs on `device`,
CUDA unless the caller names the CPU, and raises without a card; the
verifier and the rerandomisations are host code, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves import bn254
from ..curves.sw import Point
from ..curves.tcurve import TPoints, tcurve_for
from ..fields.host import Field, Fp
from ..ops.fixed_base import table_for
from ..ops.msm_v2 import msm_device_scheduled
from ..ops.ntt import NTTDomain, domain_for
from ..r1cs.cs import ConstraintSystem, evaluate_row
from ..utils.msm import msm as msm_host
from ..utils.msm import multiply_field_elems_with_same_group_elem

F = bls.Fr
DEVICE_MSM_THRESHOLD = 2048
DEVICE_FIXED_BASE_THRESHOLD = 512


class LegoGroth16Error(Exception):
    pass


def _check_ctx(ctx) -> None:
    """The port runs LegoGroth16 over its own curve modules only."""
    if ctx is not bls and ctx is not bn254:
        raise LegoGroth16Error(
            "ctx must be crypto_tpu_torch.curves.bls12_381 or "
            "crypto_tpu_torch.curves.bn254")


def _msm(points, scalars, device="cuda") -> Point:
    dev = resolve_device(device)
    if len(points) >= DEVICE_MSM_THRESHOLD:
        return msm_device_scheduled(points[0].curve,
                                    [p.normalize() for p in points],
                                    [int(s) for s in scalars], device=dev)
    return msm_host(points, scalars)


def _msm_query(pk: "ProvingKey", name: str, scalars, offset: int = 0,
               device="cuda") -> Point:
    """MSM over (a slice of) a CRS query vector.  From
    `DEVICE_MSM_THRESHOLD` points on it runs on the device, over the
    query packed once into `pk.device_cache` and kept there across
    proofs."""
    dev = resolve_device(device)
    full = getattr(pk, name)
    k = len(scalars)
    points = full[offset:offset + k]
    if not points:
        return (full[0] if full else pk.vk.alpha_g1).curve.infinity()
    if k < DEVICE_MSM_THRESHOLD:
        return msm_host(points, scalars)
    curve = full[0].curve
    key = (name, str(dev))
    packed = pk.device_cache.get(key)
    if packed is None:
        packed = tcurve_for(curve, dev).pack_points(
            [p.normalize() for p in full])
        pk.device_cache[key] = packed
    if offset or k != len(full):
        packed = TPoints(*(t[:, offset:offset + k] for t in packed))
    return msm_device_scheduled(curve, packed, [int(s) for s in scalars],
                                device=dev)


def _fixed_base_many(base: Point, scalars, device="cuda") -> list:
    """[base * s for s in scalars]: from `DEVICE_FIXED_BASE_THRESHOLD`
    scalars on through the base's device window table, normalised there
    (`_affine_host`)."""
    dev = resolve_device(device)
    if len(scalars) >= DEVICE_FIXED_BASE_THRESHOLD:
        table = table_for(base.curve, base, device=dev)
        return _affine_host(table.tc, table.mul_many([int(s)
                                                      for s in scalars]))
    return multiply_field_elems_with_same_group_elem(base, scalars, dev)


def _affine_host(tc, pts: TPoints) -> list:
    """Device points as host points with Z = 1 (infinity as infinity): the
    normalisation on the device (`TCurve.to_affine`, one batched Fermat
    inversion), then one unpack of x and y.  The same points as the host
    `normalize` of each."""
    a = tc.to_affine(pts)
    xs, ys = (np.atleast_1d(tc.F.unpack_host(t)).reshape(-1)
              for t in (a.X, a.Y))
    inf = a.inf.reshape(-1).tolist()
    curve = tc.curve
    one = curve.K.one()
    return [curve.infinity() if i else Point(x, y, one, curve)
            for x, y, i in zip(xs, ys, inf)]


def _normalized(points) -> list:
    """The points with Z = 1 (or infinity), on the host; points that
    already have Z = 1 (`_affine_host`'s) are taken as they are."""
    return [q if q.Z.is_one() else q.normalize() for q in points]


@dataclass
class VerifyingKey:
    alpha_g1: Point
    beta_g2: Point
    gamma_g2: Point
    delta_g2: Point
    gamma_abc_g1: list
    eta_gamma_inv_g1: Point
    commit_witness_count: int

    @property
    def num_public_inputs(self) -> int:
        return len(self.gamma_abc_g1) - self.commit_witness_count

    def get_commitment_key_for_witnesses(self) -> list:
        start = self.num_public_inputs
        return self.gamma_abc_g1[start:start + self.commit_witness_count] + \
            [self.eta_gamma_inv_g1]


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: Point
    delta_g1: Point
    eta_delta_inv_g1: Point
    a_query: list
    b_g1_query: list
    b_g2_query: list
    h_query: list
    l_query: list

    @property
    def device_cache(self) -> dict:
        """The query vectors packed on a device, by (query, device);
        created on first use and not part of equality."""
        c = getattr(self, "_device_cache", None)
        if c is None:
            c = {}
            object.__setattr__(self, "_device_cache", c)
        return c


@dataclass
class Proof:
    a: Point
    b: Point
    c: Point
    d: Point


@dataclass
class PreparedVerifyingKey:
    vk: VerifyingKey
    alpha_beta: object  # e(alpha, beta), an element of ctx's Fq12

    @classmethod
    def from_vk(cls, vk: VerifyingKey, ctx=bls) -> "PreparedVerifyingKey":
        _check_ctx(ctx)
        return cls(vk=vk, alpha_beta=ctx.pairing(vk.alpha_g1, vk.beta_g2))


def _lagrange_coeffs_at(domain: NTTDomain, t: int, F: Field = F) -> list:
    """l_i(t) for a radix-2 domain: Z(t)/N * w^i / (t - w^i)."""
    p = F.p
    N = domain.n
    zt = (pow(t, N, p) - 1) % p
    if zt == 0:
        raise LegoGroth16Error("tau landed inside the domain")
    w = domain.w
    zt_over_n = zt * pow(N, -1, p) % p
    # the denominators t - w^i, inverted together (Montgomery's trick)
    wi = 1
    denoms = []
    ws = []
    for _ in range(N):
        ws.append(wi)
        denoms.append((t - wi) % p)
        wi = wi * w % p
    prefix = [1] * N
    acc = 1
    for i, d in enumerate(denoms):
        prefix[i] = acc
        acc = acc * d % p
    inv = pow(acc, -1, p)
    out = [0] * N
    for i in range(N - 1, -1, -1):
        out[i] = zt_over_n * ws[i] % p * (prefix[i] * inv % p) % p
        inv = inv * denoms[i] % p
    return out


def _domain_size(cs: ConstraintSystem) -> int:
    return 1 << max(1, (cs.num_constraints + cs.num_instance - 1)
                    .bit_length())


def generate_random_parameters(circuit, commit_witness_count: int, rng,
                               ctx=bls, device="cuda") -> ProvingKey:
    """CRS generation (`generator.rs:230-440`) with trapdoors drawn from
    rng."""
    _check_ctx(ctx)
    dev = resolve_device(device)
    trapdoors = tuple(ctx.Fr.rand(rng) for _ in range(5))
    return generate_parameters_with_trapdoors(
        circuit, commit_witness_count, rng, *trapdoors, ctx=ctx, device=dev)


def generate_parameters_with_trapdoors(circuit, commit_witness_count: int,
                                       rng, alpha, beta, gamma, delta, eta,
                                       ctx=bls, g1=None, g2=None,
                                       device="cuda") -> ProvingKey:
    """CRS from explicit toxic waste (tau drawn from rng); g1/g2 override
    the group generators."""
    _check_ctx(ctx)
    dev = resolve_device(device)
    F = ctx.Fr
    cs = ConstraintSystem(F, mode="setup")
    circuit(cs)

    num_inst = cs.num_instance
    num_wit = cs.num_witness
    if num_wit < commit_witness_count:
        raise LegoGroth16Error("insufficient witnesses for commitment")
    nc = cs.num_constraints
    domain = domain_for(F, _domain_size(cs), dev)
    N = domain.n

    while True:
        t = F.rand(rng)
        if (pow(int(t), N, F.p) - 1) % F.p != 0:
            break

    u = _lagrange_coeffs_at(domain, int(t), F)
    zt = (pow(int(t), N, F.p) - 1) % F.p

    nvars = num_inst + num_wit
    p = F.p
    a = [0] * nvars
    b = [0] * nvars
    c = [0] * nvars
    for i in range(nc):
        ui = u[i]
        for coeff, idx in cs.a_rows[i]:
            a[idx] = (a[idx] + ui * coeff) % p
        for coeff, idx in cs.b_rows[i]:
            b[idx] = (b[idx] + ui * coeff) % p
        for coeff, idx in cs.c_rows[i]:
            c[idx] = (c[idx] + ui * coeff) % p
    for j in range(num_inst):
        a[j] = (a[j] + u[nc + j]) % p

    gamma_inv = pow(int(gamma), -1, p)
    delta_inv = pow(int(delta), -1, p)
    n_commit = num_inst + commit_witness_count
    gamma_abc = [(int(beta) * a[i] + int(alpha) * b[i] + c[i]) * gamma_inv % p
                 for i in range(n_commit)]
    l = [(int(beta) * a[i] + int(alpha) * b[i] + c[i]) * delta_inv % p
         for i in range(nvars)]

    if g1 is None:
        g1 = ctx.G1.generator()
    if g2 is None:
        g2 = ctx.G2.generator()

    a_query = _fixed_base_many(g1, [F(x) for x in a], dev)
    b_g1_query = _fixed_base_many(g1, [F(x) for x in b], dev)
    b_g2_query = _fixed_base_many(g2, [F(x) for x in b], dev)
    zt_delta_inv = zt * delta_inv % p
    h_scalars = []
    ti = 1
    for _ in range(N - 1):
        h_scalars.append(F(zt_delta_inv * ti % p))
        ti = ti * int(t) % p
    h_query = _fixed_base_many(g1, h_scalars, dev)
    l_query = _fixed_base_many(g1, [F(x) for x in l[n_commit:]], dev)
    gamma_abc_g1 = _fixed_base_many(g1, [F(x) for x in gamma_abc], dev)

    vk = VerifyingKey(
        alpha_g1=(g1 * int(alpha)).normalize(),
        beta_g2=(g2 * int(beta)).normalize(),
        gamma_g2=(g2 * int(gamma)).normalize(),
        delta_g2=(g2 * int(delta)).normalize(),
        gamma_abc_g1=_normalized(gamma_abc_g1),
        eta_gamma_inv_g1=(g1 * (int(eta) * gamma_inv % p)).normalize(),
        commit_witness_count=commit_witness_count,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=(g1 * int(beta)).normalize(),
        delta_g1=(g1 * int(delta)).normalize(),
        eta_delta_inv_g1=(g1 * (int(eta) * delta_inv % p)).normalize(),
        a_query=_normalized(a_query),
        b_g1_query=_normalized(b_g1_query),
        b_g2_query=_normalized(b_g2_query),
        h_query=_normalized(h_query),
        l_query=_normalized(l_query),
    )


def qap_h(domain: NTTDomain, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    """The device half of the QAP witness map: the row evaluations a, b, c
    ((L, N) Montgomery limbs on the domain's device) -> the (L, N)
    coefficients of h = (A B - C) / Z_H, by iNTT, coset NTT, the
    pointwise product over the coset's Z_H and a coset iNTT."""
    T = domain.T
    ca = domain.coset_ntt(domain.intt(a))
    cb = domain.coset_ntt(domain.intt(b))
    cc = domain.coset_ntt(domain.intt(c))
    ab = T.sub(T.mul(ca, cb), cc)
    zinv = pow(domain.z_on_coset(), -1, domain.F.p)
    ab = T.mul(ab, T._col(T.pack(zinv), ab.dim()))
    return domain.coset_intt(ab)


def witness_map(cs: ConstraintSystem, F: Field = F,
                device="cuda") -> list:
    """QAP witness map -> the h coefficients (`r1cs_to_qap.rs:150-209`):
    the rows evaluated on the host, then `qap_h` on `device`."""
    dev = resolve_device(device)
    p = F.p
    z = [int(v) for v in cs.full_assignment()]
    nc = cs.num_constraints
    num_inst = cs.num_instance
    domain = domain_for(F, _domain_size(cs), dev)
    N = domain.n
    a = [0] * N
    b = [0] * N
    c = [0] * N
    for i in range(nc):
        a[i] = evaluate_row(cs.a_rows[i], z, p)
        b[i] = evaluate_row(cs.b_rows[i], z, p)
        c[i] = evaluate_row(cs.c_rows[i], z, p)
    for j in range(num_inst):
        a[nc + j] = z[j]

    T = domain.T
    h = qap_h(domain, T.pack(a), T.pack(b), T.pack(c))
    return [int(v) for v in np.atleast_1d(T.unpack(h))]


def create_proof(circuit, pk: ProvingKey, rng, v: Fp | None = None,
                 ctx=bls, device="cuda"):
    """(Proof, v, committed witnesses): v is the commitment randomness the
    caller needs to open D (`prover.rs:32-120`)."""
    _check_ctx(ctx)
    dev = resolve_device(device)
    F = ctx.Fr
    cs = ConstraintSystem(F, mode="prove")
    circuit(cs)
    if not cs.is_satisfied():
        raise LegoGroth16Error("constraints unsatisfied")

    r, s = F.rand(rng), F.rand(rng)
    if v is None:
        v = F.rand(rng)
    h = witness_map(cs, F, device=dev)

    vk = pk.vk
    cwc = vk.commit_witness_count
    inst = [int(x) for x in cs.instance_assignment]
    wits = [int(x) for x in cs.witness_assignment]
    assignment = inst[1:] + wits  # every variable but the leading ONE

    h_acc = _msm_query(pk, "h_query", [F(x) for x in h[:len(pk.h_query)]],
                       device=dev)
    l_acc = _msm_query(pk, "l_query", [F(x) for x in wits[cwc:]],
                       device=dev) if pk.l_query else ctx.G1.infinity()

    def calculate_coeff(initial, qname, vk_param):
        query = getattr(pk, qname)
        acc = initial + query[0]
        if assignment and len(query) > 1:
            acc = acc + _msm_query(pk, qname, [F(x) for x in assignment],
                                   offset=1, device=dev)
        return acc + vk_param

    g_a = calculate_coeff(pk.delta_g1 * int(r), "a_query", vk.alpha_g1)
    g1_b = calculate_coeff(pk.delta_g1 * int(s), "b_g1_query", pk.beta_g1)
    g2_b = calculate_coeff(vk.delta_g2 * int(s), "b_g2_query", vk.beta_g2)

    g_c = g_a * int(s) + g1_b * int(r) \
        - pk.delta_g1 * (int(r) * int(s) % F.p) \
        + l_acc + h_acc - pk.eta_delta_inv_g1 * int(v)

    committed = wits[:cwc]
    n_pub = vk.num_public_inputs
    g_d = ctx.G1.infinity()
    if committed:
        g_d = _msm(vk.gamma_abc_g1[n_pub:n_pub + cwc],
                   [F(x) for x in committed], dev)
    g_d = g_d + vk.eta_gamma_inv_g1 * int(v)

    proof = Proof(a=g_a.normalize(), b=g2_b.normalize(),
                  c=g_c.normalize(), d=g_d.normalize())
    return proof, v, [F(x) for x in committed]


# ---------------------------------------------------------------------------
# rerandomisation and verification (host, `ctx`'s pairing)
# ---------------------------------------------------------------------------

def rerandomize_proof(proof: Proof, vk: VerifyingKey, rng, ctx=bls) -> Proof:
    """BKSV20-style rerandomisation (`legogroth16/src/prover.rs:478-508`):
    A' = A/r1, B' = r1 B + r1 r2 (delta + gamma), C' = C + r2 A, D' = D
    + r2 A.  D no longer commits to the witnesses afterwards."""
    _check_ctx(ctx)
    F = ctx.Fr
    r1 = F.rand_nonzero(rng)
    r2 = F.rand_nonzero(rng)
    a_r2 = proof.a * int(r2)
    return Proof(
        a=(proof.a * int(r1.inverse())).normalize(),
        b=(proof.b * int(r1)
           + (vk.delta_g2 + vk.gamma_g2) * int(r1 * r2)).normalize(),
        c=(proof.c + a_r2).normalize(),
        d=(proof.d + a_r2).normalize())


def rerandomize_proof_1(proof: Proof, old_v: Fp, new_v: Fp,
                        vk: VerifyingKey, eta_delta_inv_g1: Point, rng,
                        ctx=bls) -> Proof:
    """Rerandomisation that keeps D a commitment to the witnesses, with the
    fresh randomness new_v (`legogroth16/src/prover.rs:510-549`): C' = C +
    r2 A + (old_v - new_v) eta/delta G1, D' = D + (new_v - old_v)
    eta/gamma G1."""
    _check_ctx(ctx)
    F = ctx.Fr
    r1 = F.rand_nonzero(rng)
    r2 = F.rand_nonzero(rng)
    a_r2 = proof.a * int(r2)
    return Proof(
        a=(proof.a * int(r1.inverse())).normalize(),
        b=(proof.b * int(r1) + vk.delta_g2 * int(r1 * r2)).normalize(),
        c=(proof.c + a_r2
           + eta_delta_inv_g1 * int(old_v - new_v)).normalize(),
        d=(proof.d + vk.eta_gamma_inv_g1 * int(new_v - old_v)).normalize())


def prepare_inputs(vk: VerifyingKey, public_inputs, ctx=bls) -> Point:
    """gamma_abc[0] + sum_i x_i gamma_abc[i + 1] over the public inputs."""
    _check_ctx(ctx)
    F = ctx.Fr
    inp = [F(1)] + [F(int(x)) for x in public_inputs]
    if len(inp) > vk.num_public_inputs:
        raise LegoGroth16Error("too many public inputs")
    return msm_host(vk.gamma_abc_g1[:len(inp)], inp)


def verify_qap_proof(pvk: PreparedVerifyingKey, a: Point, b: Point,
                     c: Point, d: Point, ctx=bls) -> bool:
    """The bare 3-pairing QAP check with a whole d accumulator
    (`verifier.rs:62-85`): e(a, b) e(c, -delta) e(d, -gamma) == e(alpha,
    beta)."""
    _check_ctx(ctx)
    vk = pvk.vk
    neg_delta = (-vk.delta_g2).normalize()
    neg_gamma = (-vk.gamma_g2).normalize()
    lhs = ctx.multi_pairing([(a, b), (c, neg_delta),
                             (d.normalize(), neg_gamma)])
    return lhs == pvk.alpha_beta


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof, public_inputs,
                 ctx=bls) -> bool:
    """The 3-pairing check of a proof and its public inputs
    (`verifier.rs:64-110`)."""
    d = prepare_inputs(pvk.vk, public_inputs, ctx) + proof.d
    return verify_qap_proof(pvk, proof.a, proof.b, proof.c, d, ctx)


def verify_proof_with_checker(pvk: PreparedVerifyingKey, proof: Proof,
                              public_inputs, checker, ctx=bls) -> None:
    """Adds the verification equation e(A, B) e(C, -delta) e(D + inputs,
    -gamma) == e(alpha, beta) to a shared `RandomizedPairingChecker`
    (`utils/checkers.py`, BLS12-381 only, as the reference's; `verifier.rs`
    with `VerifierConfig`)."""
    vk = pvk.vk
    d = (prepare_inputs(vk, public_inputs, ctx) + proof.d).normalize()
    checker.add_multiple_sources_and_target(
        [proof.a, proof.c, d],
        [proof.b, (-vk.delta_g2).normalize(), (-vk.gamma_g2).normalize()],
        pvk.alpha_beta)


def verify_commitment(vk: VerifyingKey, proof: Proof, public_inputs,
                      committed_witnesses, v: Fp, ctx=bls) -> bool:
    """Opens D: D == sum gamma_abc[committed slot i] w_i + v eta/gamma
    (`verifier.rs` `verify_commitment`)."""
    _check_ctx(ctx)
    n_pub = vk.num_public_inputs
    bases = vk.gamma_abc_g1[n_pub:n_pub + len(committed_witnesses)]
    expect = msm_host(bases + [vk.eta_gamma_inv_g1],
                      list(committed_witnesses) + [v])
    return expect == proof.d
