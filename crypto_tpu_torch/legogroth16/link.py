"""cp_link: QA-NIZK subspace SNARK linking LegoGroth16's witness commitment
D to an external Pedersen commitment (reference `legogroth16/src/link/`):
the port's copy of `crypto_tpu/legogroth16/link.py`.

PESubspaceSnark (appendix D of the LegoSNARK paper): for a public matrix M
(l x t) of G1 elements, prove knowledge of w with x_i = sum_j M[i][j]*w_j:
  keygen: trapdoor k (l scalars), a;  P_j = sum_i k_i*M[i][j];
          VK: C_i = g2*(a*k_i),  A = g2*a
  prove:  pi = sum_j w_j * P_j
  verify: prod e(x_i, C_i) * e(pi, -A) == 1

For LegoGroth16 linking, M has two rows:
  row 0 (cp_link = <link_bases, wits> + link_v * h):   [link_bases | h | 0]
  row 1 (D = <gamma_abc_wits, wits> + v * eta/gamma):  [bases_D    | 0 | eta/gamma]
witness vector w = [committed wits | link_v | v].

Host code over the port's host MSM and pairing, as in the reference; the
LegoGroth16 proof of `create_proof_incl_cp_link` comes from the port's
prover on `device` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..fields.host import Fp
from ..utils.msm import msm
from . import snark

F = bls.Fr


@dataclass
class SubspaceSnarkEK:
    p: list  # t G1 elements


@dataclass
class SubspaceSnarkVK:
    c: list  # l G2 elements
    a: Point


def subspace_keygen(rng, matrix: list) -> tuple:
    """matrix: l rows of t G1 Points (infinity for zero entries)."""
    l = len(matrix)
    t = len(matrix[0])
    k = [F.rand(rng) for _ in range(l)]
    a = F.rand_nonzero(rng)
    p = []
    for j in range(t):
        acc = bls.G1.infinity()
        for i in range(l):
            if not matrix[i][j].is_infinity():
                acc = acc + matrix[i][j] * int(k[i])
        p.append(acc.normalize())
    g2 = bls.G2.generator()
    vk = SubspaceSnarkVK(
        c=[(g2 * int(a * ki)).normalize() for ki in k],
        a=(g2 * int(a)).normalize())
    return SubspaceSnarkEK(p=p), vk


def subspace_prove(ek: SubspaceSnarkEK, w: list) -> Point:
    return msm(ek.p[:len(w)], w).normalize()


def subspace_verify(vk: SubspaceSnarkVK, x: list, pi: Point) -> bool:
    pairs = [(xi, ci) for xi, ci in zip(x, vk.c)]
    pairs.append((pi, (-vk.a).normalize()))
    return bls.multi_pairing(pairs).is_one()


# ---------------------------------------------------------------------------
# LegoGroth16 integration
# ---------------------------------------------------------------------------

@dataclass
class LinkKeys:
    link_bases: list     # Pedersen bases for cp_link (per committed witness)
    link_h: Point        # randomness base of cp_link
    ek: SubspaceSnarkEK
    vk: SubspaceSnarkVK


def generate_link_keys(rng, lg_vk: snark.VerifyingKey) -> LinkKeys:
    cwc = lg_vk.commit_witness_count
    link_bases = [bls.G1.rand(rng).normalize() for _ in range(cwc)]
    link_h = bls.G1.rand(rng).normalize()
    n_pub = lg_vk.num_public_inputs
    d_bases = lg_vk.gamma_abc_g1[n_pub:n_pub + cwc]
    inf = bls.G1.infinity()
    row0 = link_bases + [link_h, inf]
    row1 = list(d_bases) + [inf, lg_vk.eta_gamma_inv_g1]
    ek, vk = subspace_keygen(rng, [row0, row1])
    return LinkKeys(link_bases=link_bases, link_h=link_h, ek=ek, vk=vk)


@dataclass
class ProofWithLink:
    groth16_proof: snark.Proof
    link_d: Point    # cp_link commitment
    link_pi: Point   # subspace proof


def create_proof_incl_cp_link(circuit, pk: snark.ProvingKey, link: LinkKeys,
                              rng, device="cuda") -> tuple:
    """Returns (ProofWithLink, link_v) — link_v opens cp_link."""
    proof, v, committed = snark.create_proof(circuit, pk, rng, device=device)
    link_v = F.rand(rng)
    link_d = msm(link.link_bases + [link.link_h],
                 committed + [link_v]).normalize()
    w = committed + [link_v, v]
    link_pi = subspace_prove(link.ek, w)
    return ProofWithLink(groth16_proof=proof, link_d=link_d,
                         link_pi=link_pi), link_v, committed


def verify_proof_incl_cp_link(pvk: snark.PreparedVerifyingKey,
                              link: LinkKeys, proof: ProofWithLink,
                              public_inputs) -> bool:
    if not subspace_verify(link.vk, [proof.link_d, proof.groth16_proof.d],
                           proof.link_pi):
        return False
    return snark.verify_proof(pvk, proof.groth16_proof, public_inputs)


def verify_link_commitment(link: LinkKeys, link_d: Point, witnesses, link_v) -> bool:
    expect = msm(link.link_bases + [link.link_h],
                 list(witnesses) + [link_v]).normalize()
    return expect == link_d
