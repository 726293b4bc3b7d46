"""SAVER verifiable encryption (reference `saver/` crate, paper 2019/1270):
the port's copy of `crypto_tpu/saver/core.py`, Groth16 form.

Message (field element) is decomposed into n big-endian chunks of
`chunk_bit_size` bits; each chunk is encrypted with an exponent-ElGamal
variant whose key is structurally bound to a Groth16 CRS:

  SNARK CRS: BitsizeCheckCircuit with the n chunks as PUBLIC inputs;
  g_i := gamma_abc[1..] of the vk; delta_g := delta*G; gamma_g := -gamma*G.
  keygen (`keygen.rs:239-300`): rho, s_i, t_i, v_i random;
    EK: X_0 = delta_g, X_i = delta_g*s_i, Y_i = g_i*t_{i+1}, Z_i = H*t_i,
        P_1 = delta_g*(t_0 + sum s_j t_{j+1}), P_2 = gamma_g*(1 + sum s_j)
    DK: V_0 = H*rho, V_1_i = H*(s_i v_i), V_2_i = H*(rho v_i)

  encrypt (`encryption.rs:627-698`): r random;
    c_0 = X_0*r; c_i = X_i*r + g_i*m_i; psi = sum Y_i*m_i + P_1*r

  ciphertext commitment check (`encryption.rs:367-392`):
    e(c_0, Z_0) * prod e(c_i, Z_i) * e(-psi, H) == 1

  SNARK proof: Groth16 proof over the chunks with C adjusted by r*P_2;
  verification uses d = c_0 + sum c_i + gamma_abc[0] as the public-input
  accumulator (`saver_groth16.rs:83-162`) — the ciphertext IS the statement.

  decrypt (`encryption.rs:569-614`): per chunk
    p = e(c_i, V_2_i) * e(-rho*c_0, V_1_i);  m_i = dlog_{e(g_i, V_2_i)}(p)
    solved by BSGS bounded by 2^chunk_bit_size; recombine big-endian.

The pairing products go through `curves/tpairing.py`
`multi_pairings_routed`, a call's products together: `decrypt` sends every
chunk's 2-pair product and every chunk's base e(g_i, V_2_i) in one call
(the reference computes a base only where the product is not 1; the
outputs are the same), `verify_decryption` its 1 + n products, and the
two ciphertext checks their one product each; the router sends a call
to the device as one batch or to the host by its pairs and products
(`pairing_route`: at 8-bit chunks a decryption's 96 pairs in 64 products
go to the device, a commitment check's 34 pairs in one product stay on
the host).  The SNARK proof is the port's LegoGroth16 prover
(`legogroth16/snark.py`: the witness map's NTTs on the device, MSMs from
its thresholds on).  Every entry point that pairs or proves runs on
`device`, CUDA unless the caller names the CPU, and raises without a
card; the rest is host code, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import resolve_device
from ..curves import bls12_381 as bls
from ..curves.sw import Point
from ..curves.tpairing import multi_pairings_routed
from ..fields.host import Fp
from ..r1cs.cs import ConstraintSystem, LinearCombination, ONE
from ..legogroth16 import snark
from ..utils.msm import WindowTable, msm
from ..utils.elgamal import solve_discrete_log_bsgs
from ..hashing import group_elem_from_try_and_incr, concat_slices

F = bls.Fr


class SaverError(Exception):
    pass


def chunks_count(chunk_bit_size: int) -> int:
    return -(-F.bits // chunk_bit_size)


def decompose(message: Fp, chunk_bit_size: int) -> list[int]:
    """Big-endian chunk decomposition (`utils.rs:17-46`)."""
    n = chunks_count(chunk_bit_size)
    v = int(message)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = v & ((1 << chunk_bit_size) - 1)
        v >>= chunk_bit_size
    assert v == 0
    return out


def compose(chunks: list[int], chunk_bit_size: int) -> Fp:
    v = 0
    for c in chunks:
        v = (v << chunk_bit_size) | int(c)
    return F(v)


@dataclass
class EncryptionGens:
    """Independent generators G (G1), H (G2) (`setup.rs`)."""
    G: Point
    H: Point

    @classmethod
    def new(cls, label: bytes):
        return cls(
            G=group_elem_from_try_and_incr(
                bls.G1, concat_slices(label, b" : G")).normalize(),
            H=group_elem_from_try_and_incr(
                bls.G2, concat_slices(label, b" : H")).normalize())


def bitsize_check_circuit(chunk_bit_size: int, num_chunks: int,
                          chunk_values=None):
    """R1CS circuit: each chunk (public input) is < 2^chunk_bit_size,
    enforced by boolean bit decomposition (`saver/src/circuit.rs:12-85`)."""
    def circuit(cs: ConstraintSystem):
        vals = chunk_values
        inputs = []
        for i in range(num_chunks):
            inputs.append(cs.new_input(None if vals is None else F(vals[i])))
        for i, chunk_var in enumerate(inputs):
            bits = []
            for j in range(chunk_bit_size - 1, -1, -1):
                bv = None
                if vals is not None:
                    bv = F((int(vals[i]) >> j) & 1)
                b_var = cs.new_witness(bv)
                # booleanity: b * (1 - b) = 0
                one_minus = LinearCombination.from_var(ONE) - b_var.lc()
                cs.enforce(b_var.lc(), one_minus, LinearCombination.zero())
                bits.append((b_var, 1 << j))
            # sum bits*2^j == chunk
            lhs = LinearCombination(
                [(F(w), v) for v, w in bits])
            cs.enforce(lhs, LinearCombination.from_var(ONE), chunk_var.lc())
    return circuit


@dataclass
class SaverProvingKey:
    pk: snark.ProvingKey
    gamma_g1: Point  # -gamma * G


def generate_srs(chunk_bit_size: int, gens: EncryptionGens, rng,
                 device="cuda") -> SaverProvingKey:
    """Groth16 CRS for the bitsize circuit with SAVER's generator choice.
    NB: our generator uses the standard curve generators for G1/G2; the
    binding that matters is exposing -gamma*G1 for P_2."""
    device = resolve_device(device)
    n = chunks_count(chunk_bit_size)
    alpha, beta, gamma, delta, eta = (F.rand(rng) for _ in range(5))
    pk = snark.generate_parameters_with_trapdoors(
        bitsize_check_circuit(chunk_bit_size, n), 0, rng,
        alpha, beta, gamma, delta, eta, device=device)
    gamma_g1 = (bls.G1.generator() * int(-gamma)).normalize()
    return SaverProvingKey(pk=pk, gamma_g1=gamma_g1)


def get_gs_for_encryption(vk: snark.VerifyingKey) -> list:
    return vk.gamma_abc_g1[1:]


@dataclass
class SaverSecretKey:
    rho: Fp


@dataclass
class EncryptionKey:
    X_0: Point
    X: list
    Y: list
    Z: list
    P_1: Point
    P_2: Point

    def commitment_key(self):
        return self.Y + [self.P_1]


@dataclass
class DecryptionKey:
    V_0: Point
    V_1: list
    V_2: list


def keygen(rng, chunk_bit_size: int, gens: EncryptionGens, g_i: list,
           delta_g: Point, gamma_g: Point):
    """The reference's keys from the same draws of `rng`; the multiples of
    H (Z, V_0, V_1, V_2) and of delta_g (X) come from one host window
    table each (`utils/msm.py` `WindowTable`), the same points as the
    reference's one scalar multiplication each."""
    n = chunks_count(chunk_bit_size)
    if n > len(g_i):
        raise SaverError("not enough g_i")
    rho = F.rand_nonzero(rng)
    s = [F.rand(rng) for _ in range(n)]
    t = [F.rand(rng) for _ in range(n + 1)]
    v = [F.rand(rng) for _ in range(n)]
    h_mul = WindowTable(1 + 3 * n + 1, gens.H).mul
    x_mul = WindowTable(n, delta_g).mul
    ek = EncryptionKey(
        X_0=delta_g,
        X=[x_mul(si).normalize() for si in s],
        Y=[(g_i[i] * int(t[i + 1])).normalize() for i in range(n)],
        Z=[h_mul(ti).normalize() for ti in t],
        P_1=(delta_g * int(
            t[0] + sum((s[j] * t[j + 1] for j in range(n)), F(0)))).normalize(),
        P_2=(gamma_g * int(F(1) + sum(s, F(0)))).normalize(),
    )
    dk = DecryptionKey(
        V_0=h_mul(rho).normalize(),
        V_1=[h_mul(s[i] * v[i]).normalize() for i in range(n)],
        V_2=[h_mul(rho * v[i]).normalize() for i in range(n)],
    )
    return SaverSecretKey(rho), ek, dk


@dataclass
class Ciphertext:
    X_r: Point          # c_0
    enc_chunks: list    # c_1..c_n
    commitment: Point   # psi


def encrypt(rng, message: Fp, ek: EncryptionKey, g_i: list,
            chunk_bit_size: int):
    chunks = decompose(message, chunk_bit_size)
    n = len(ek.X)
    if len(chunks) != n:
        raise SaverError("chunk count mismatch")
    r = F.rand(rng)
    c0 = (ek.X_0 * int(r)).normalize()
    cs = [(ek.X[i] * int(r) + g_i[i].mul_raw(chunks[i])).normalize()
          for i in range(n)]
    psi = msm(ek.commitment_key(), [F(m) for m in chunks] + [r]).normalize()
    return Ciphertext(X_r=c0, enc_chunks=cs, commitment=psi), r


def encrypt_with_proof(rng, message: Fp, ek: EncryptionKey,
                       spk: SaverProvingKey, chunk_bit_size: int,
                       device="cuda"):
    device = resolve_device(device)
    g_i = get_gs_for_encryption(spk.pk.vk)
    ct, r = encrypt(rng, message, ek, g_i, chunk_bit_size)
    chunks = decompose(message, chunk_bit_size)
    circuit = bitsize_check_circuit(
        chunk_bit_size, len(chunks), chunks)
    # v = 0: no witness commitment -> plain Groth16 (SAVER uses the
    # ciphertext itself as the commitment)
    proof, v, _ = snark.create_proof(circuit, spk.pk, rng, v=F(0),
                                     device=device)
    # C adjustment: proof.c += r * P_2 (`saver_groth16.rs:99-102`)
    proof = snark.Proof(a=proof.a, b=proof.b,
                        c=(proof.c + ek.P_2 * int(r)).normalize(),
                        d=proof.d)
    return ct, r, proof


def rerandomize_ciphertext_and_proof(ct: Ciphertext, proof: snark.Proof,
                                     vk, ek: EncryptionKey, rng):
    """Fresh-looking ciphertext + proof from an existing pair (reference
    `saver/src/encryption.rs:208-238` + `saver_groth16.rs:109-136`):
    adds X_i*r' to every ciphertext component and fixes the Groth16 proof
    with A*z1, B/z1 + delta*z2, C + A*z1*z2 + P_2*r'.  Returns
    (ct', r', proof'); the total encryption randomness becomes r + r'."""
    r_prime = F.rand_nonzero(rng)
    xr = (ct.X_r + ek.X_0 * int(r_prime)).normalize()
    enc = [(c + ek.X[i] * int(r_prime)).normalize()
           for i, c in enumerate(ct.enc_chunks)]
    comm = (ct.commitment + ek.P_1 * int(r_prime)).normalize()
    z1 = F.rand_nonzero(rng)
    z2 = F.rand_nonzero(rng)
    new_proof = snark.Proof(
        a=(proof.a * int(z1)).normalize(),
        b=(proof.b * int(z1.inverse()) + vk.delta_g2 * int(z2)).normalize(),
        c=(proof.c + proof.a * int(z1 * z2)
           + ek.P_2 * int(r_prime)).normalize(),
        d=proof.d)
    return Ciphertext(X_r=xr, enc_chunks=enc, commitment=comm), r_prime, \
        new_proof


def verify_ciphertext_commitment(ct: Ciphertext, ek: EncryptionKey,
                                 gens: EncryptionGens,
                                 device="cuda") -> bool:
    pairs = [(ct.X_r, ek.Z[0])]
    for i, c in enumerate(ct.enc_chunks):
        pairs.append((c, ek.Z[i + 1]))
    pairs.append(((-ct.commitment).normalize(), gens.H))
    return multi_pairings_routed([pairs], device)[0].is_one()


def verify_ciphertext_proof(ct: Ciphertext, proof: snark.Proof,
                            pvk: snark.PreparedVerifyingKey,
                            device="cuda") -> bool:
    """d = c_0 + sum c_i + gamma_abc[0] (`saver_groth16.rs:138-162`)."""
    d = ct.X_r
    for c in ct.enc_chunks:
        d = d + c
    d = (d + pvk.vk.gamma_abc_g1[0]).normalize()
    neg_delta = (-pvk.vk.delta_g2).normalize()
    neg_gamma = (-pvk.vk.gamma_g2).normalize()
    lhs = multi_pairings_routed([[
        (proof.a, proof.b), (proof.c, neg_delta), (d, neg_gamma)]],
        device)[0]
    return lhs == pvk.alpha_beta


def decrypt(ct: Ciphertext, sk: SaverSecretKey, dk: DecryptionKey,
            g_i: list, chunk_bit_size: int, device="cuda"):
    """Returns (message, nu) where nu = rho*c_0 (used by verify_decryption).
    Every chunk's product and base go through one routed call; the
    discrete logs are solved on the host."""
    n = len(ct.enc_chunks)
    chunk_max = (1 << chunk_bit_size) - 1
    c0_neg_rho = (ct.X_r * int(-sk.rho)).normalize()
    gts = multi_pairings_routed(
        [[(ct.enc_chunks[i], dk.V_2[i]), (c0_neg_rho, dk.V_1[i])]
         for i in range(n)] + [[(g_i[i], dk.V_2[i])] for i in range(n)],
        device)
    chunks = []
    for i in range(n):
        p, base = gts[i], gts[n + i]
        if p.is_one():
            chunks.append(0)
            continue
        m = solve_discrete_log_bsgs(chunk_max, base, p)
        if m is None:
            raise SaverError("could not find discrete log")
        chunks.append(m)
    nu = (ct.X_r * int(sk.rho)).normalize()
    return compose(chunks, chunk_bit_size), nu


def verify_decryption(ct: Ciphertext, message: Fp, nu: Point,
                      dk: DecryptionKey, g_i: list, gens: EncryptionGens,
                      chunk_bit_size: int, device="cuda") -> bool:
    """`encryption.rs:425-553`: check nu = rho*c_0 via
    e(nu, H) == e(c_0, V_0) and per chunk
    e(c_i - g_i*m_i, V_2_i) == e(nu, V_1_i): the 1 + n products in one
    routed call (the reference stops at the first that fails; the
    verdict is the same)."""
    chunks = decompose(message, chunk_bit_size)
    neg_nu = (-nu).normalize()
    groups = [[(nu, gens.H), ((-ct.X_r).normalize(), dk.V_0)]]
    for i, c in enumerate(ct.enc_chunks):
        lhs = (c - g_i[i].mul_raw(chunks[i])).normalize()
        groups.append([(lhs, dk.V_2[i]), (neg_nu, dk.V_1[i])])
    return all(p.is_one() for p in multi_pairings_routed(groups, device))
