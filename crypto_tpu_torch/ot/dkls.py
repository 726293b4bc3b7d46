"""DKLS18/DKLS19 actively secure two-party multiplication over KOS OT
extension (reference `oblivious_transfer/src/ot_based_multiplication/
{dkls18_mul_2p,dkls19_batch_mul_2p}.rs`).  The port of
`crypto_tpu/ot/dkls.py`: the same draws from `rng` and the same shares,
the field arithmetic of its long loops on the host's integers.

Party1 holds alpha, Party2 holds beta; they end with additive shares of
alpha*beta.  Party2 encodes beta as choice bits against the gadget
vector g = (1, 2, 4, ..., 2^{kappa-1}, eta_1..eta_{kappa+2s}): the first
kappa bits are the binary decomposition of beta - <eta, gamma> for
random pad bits gamma, so <g, encoded> = beta while the pad statistically
hides it.  Each correlated OT i yields t_A_i + t_B_i = choice_i * (alpha,
alpha_hat); the shares are gadget-weighted sums of the first components.
Active security: the (chi, chi_hat) random linear combination lets
Party2 check that Party1 used one alpha in every OT.

The batch (DKLS19) variant multiplies one alpha by a batch of betas over
one KOS extension."""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..fields.host import Fp
from ..hashing import blake2b512, field_elem_from_try_and_incr
from .kos_ote import KOSReceiverSetup, KOSSenderSetup, OTError
from .ot_extension import OTEReceiver, OTESender

F = bls.Fr
DEFAULT_KAPPA = 256
DEFAULT_SSP = 80


@dataclass
class MultiplicationOTEParams:
    kappa: int = DEFAULT_KAPPA
    ssp: int = DEFAULT_SSP     # statistical security parameter

    @property
    def num_extensions(self) -> int:
        return 2 * (self.kappa + self.ssp)

    @property
    def overhead(self) -> int:
        return self.kappa + 2 * self.ssp


@dataclass
class GadgetVector:
    params: MultiplicationOTEParams
    g: list

    @classmethod
    def new(cls, params: MultiplicationOTEParams, label: bytes,
            digest=blake2b512):
        g = [F(1)]
        for _ in range(params.kappa - 1):
            g.append(g[-1] + g[-1])
        for i in range(params.overhead):
            g.append(field_elem_from_try_and_incr(
                F, label + b"-" + i.to_bytes(4, "big"), digest))
        return cls(params=params, g=g)


def encode_beta(rng, beta: Fp, gadget: GadgetVector) -> list:
    """Choice bits with <g, bits> = beta (`dkls18_mul_2p.rs` `encode`)."""
    p = gadget.params
    gamma = [rng.randrange(2) for _ in range(p.overhead)]
    ip = sum(int(gadget.g[p.kappa + i]) for i, gm in enumerate(gamma)
             if gm) % F.p
    adjusted = (int(beta) - ip) % F.p
    return [(adjusted >> i) & 1 for i in range(p.kappa)] + gamma


def _gadget_sums(t: list, gadget: GadgetVector, m: int, k: int) -> list:
    """sum_i t[j*m + i][0] * g[i] for each of the k blocks of m OTs."""
    g = [int(v) for v in gadget.g[:m]]
    return [F(sum(a * gi for (a, _), gi in zip(t[j * m:(j + 1) * m], g))
              % F.p) for j in range(k)]


def _chis(tau):
    """(chi, chi_hat) from the serialised tags (int pairs or Fp pairs)."""
    nb = F.nbytes
    buf = b"".join(int(t0).to_bytes(nb, "little") + int(t1).to_bytes(
        nb, "little") for t0, t1 in tau)
    chi = field_elem_from_try_and_incr(F, b"chi" + buf)
    chi_hat = field_elem_from_try_and_incr(F, b"chi_hat" + buf)
    return chi, chi_hat


@dataclass
class DklsRLC:
    r: list
    u: Fp


def _sender_side(setup: KOSSenderSetup, alpha: Fp, alpha_hat: Fp):
    """Party1's transfer: (t_A int pairs, tau as Fp pairs, its RLC)."""
    p = F.p
    t_A, tau = setup.transfer_ints((int(alpha), int(alpha_hat)))
    chi, chi_hat = (int(v) for v in _chis(tau))
    r = [F((chi * a + chi_hat * ah) % p) for a, ah in t_A]
    u = F((chi * int(alpha) + chi_hat * int(alpha_hat)) % p)
    return t_A, [(F(a), F(b)) for a, b in tau], DklsRLC(r=r, u=u)


def _receiver_side(setup: KOSReceiverSetup, bits: list, tau, rlc: DklsRLC,
                   what: str) -> list:
    """Party2's outputs t_B (int pairs), after checking Party1's RLC."""
    p = F.p
    t_B = setup.receive_ints(tau)
    chi, chi_hat = (int(v) for v in _chis(tau))
    u = int(rlc.u)
    for (b0, b1), r_i, bit in zip(t_B, rlc.r, bits):
        if (chi * b0 + chi_hat * b1 + int(r_i) - (u if bit else 0)) % p:
            raise OTError(f"DKLS {what}consistency check failed")
    return t_B


@dataclass
class Party1:
    """Holds alpha; acts as KOS extension SENDER."""
    alpha: Fp
    alpha_hat: Fp
    params: MultiplicationOTEParams
    ote_sender: OTESender

    @classmethod
    def new(cls, rng, alpha: Fp, ote_sender: OTESender,
            params: MultiplicationOTEParams = None):
        params = params or MultiplicationOTEParams()
        if ote_sender.kappa != params.kappa:
            raise OTError("base-OT count != kappa")
        return cls(alpha=alpha, alpha_hat=F.rand(rng), params=params,
                   ote_sender=ote_sender)

    def receive(self, U, kos_rlc, gadget: GadgetVector):
        """Consumes Party2's extension message; returns
        (share, tau to send, RLC to send)."""
        n = self.params.num_extensions
        setup = KOSSenderSetup.new(self.ote_sender, n, U, kos_rlc,
                                   statistical_security=self.params.ssp)
        t_A, tau, rlc = _sender_side(setup, self.alpha, self.alpha_hat)
        return _gadget_sums(t_A, gadget, n, 1)[0], tau, rlc


@dataclass
class Party2:
    """Holds beta; acts as KOS extension RECEIVER."""
    beta: Fp
    encoded_beta: list
    params: MultiplicationOTEParams
    kos_setup: KOSReceiverSetup

    @classmethod
    def new(cls, rng, beta: Fp, ote_receiver: OTEReceiver,
            gadget: GadgetVector,
            params: MultiplicationOTEParams = None):
        """Returns (party, U, kos_rlc): the extension message for P1."""
        params = params or MultiplicationOTEParams()
        encoded = encode_beta(rng, beta, gadget)
        setup, U, rlc = KOSReceiverSetup.new(
            rng, ote_receiver, encoded, statistical_security=params.ssp)
        return cls(beta=beta, encoded_beta=encoded, params=params,
                   kos_setup=setup), U, rlc

    def receive(self, tau, rlc: DklsRLC, gadget: GadgetVector) -> Fp:
        """Checks Party1's consistency RLC; returns the share."""
        t_B = _receiver_side(self.kos_setup, self.encoded_beta, tau, rlc, "")
        return _gadget_sums(t_B, gadget, len(t_B), 1)[0]


# ---------------------------------------------------------------------------
# DKLS19 batch multiplication: one alpha, many betas, one extension
# ---------------------------------------------------------------------------

def batch_mul_party2_round1(rng, betas: list, ote_receiver: OTEReceiver,
                            gadget: GadgetVector,
                            params: MultiplicationOTEParams = None):
    params = params or MultiplicationOTEParams()
    encodings = [encode_beta(rng, b, gadget) for b in betas]
    flat = [bit for enc in encodings for bit in enc]
    setup, U, rlc = KOSReceiverSetup.new(
        rng, ote_receiver, flat, statistical_security=params.ssp)
    return (encodings, setup), U, rlc


def batch_mul_party1(rng, alpha: Fp, num_betas: int, U, kos_rlc,
                     ote_sender: OTESender, gadget: GadgetVector,
                     params: MultiplicationOTEParams = None):
    params = params or MultiplicationOTEParams()
    m = params.num_extensions
    setup = KOSSenderSetup.new(ote_sender, m * num_betas, U, kos_rlc,
                               statistical_security=params.ssp)
    t_A, tau, rlc = _sender_side(setup, alpha, F.rand(rng))
    return _gadget_sums(t_A, gadget, m, num_betas), tau, rlc


def batch_mul_party2_round2(state, tau, rlc: DklsRLC,
                            gadget: GadgetVector,
                            params: MultiplicationOTEParams = None) -> list:
    params = params or MultiplicationOTEParams()
    encodings, setup = state
    flat_bits = [bit for enc in encodings for bit in enc]
    t_B = _receiver_side(setup, flat_bits, tau, rlc, "batch ")
    return _gadget_sums(t_B, gadget, params.num_extensions, len(encodings))
