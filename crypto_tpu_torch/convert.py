"""Carry field elements between the JAX package's arrays and the port's
tensors.

The JAX package packs an element as `(..., L_jax)` int32 with 15-bit
limbs, least significant first, in Montgomery form with R_jax =
2^(15*L_jax) (L_jax = 26 for BLS12-381 Fq, 17 for Fr).  The port packs it
as `(L, ...)` int32 with 32-bit limbs (uint32 bit patterns), R = 2^(32L).
Conversion goes through plain Python ints: unpack, multiply by
R_jax^-1 * R mod p, repack; any prime works (BN254's Fq and Fr take 17
JAX limbs and 8 port limbs).  The limb widths and radices are constants
here, so nothing of the JAX package is needed.  An Fq2 element is
`(..., 2, L_jax)` in the JAX package and `(2L, ...)` in the port
(`jax_to_port_fq2`, `port_to_jax_fq2`); Fq6 `(..., 3, 2, L_jax)` and
`(6L, ...)`, Fq12 `(..., 2, 3, 2, L_jax)` and `(12L, ...)` likewise.

Host objects cross by their attributes alone: a point's `.X`, `.Y`, `.Z`
as integers (`carry_point` builds the same point on a curve of the other
package; `carry_pairs` for (G1, G2) pairs), a host Fq12 element as its
nested ints (`carry_fp12`), a LegoGroth16 proving key field by field
onto the port's curve module of its curve (`proving_key_to_port`), a
proof as the integers that rebuild it (`proof_ints`), and the protocol
objects (the BBS+, BBS23 and Schnorr params, keys, signatures and proofs;
LegoGroth16 keys and proofs; SAVER's generators, keys and ciphertexts;
SnarkPack's SRSs and `AggregateProof`; cp_link's `LinkKeys`; the range
proofs' setup params, keys, signatures and proofs, Pedersen commitment
keys and parsed Circom circuits; the PS/Coconut, BBDT16 and keyed
accumulator keys, signatures, MACs and proofs; the KB universal
accumulator with its two states, `Omega`, and the statements, witnesses
and proofs of `statements_more` and `statements_kv`; ElGamal keys, TZ21
and RDkgith proofs and their compressed ciphertexts; the BBS# params,
keys, MACs, tokens and proofs, whose points lie on secp256r1) as the port's
classes of the same names in the port's modules of the same names
(`protocol_to_port`; a class with `__slots__`, as
`utils/commitment.py`'s key, slot by slot; an accumulator's in-memory
state, `persistence.py`'s `InMemoryState` or `InMemoryInitialElements`,
by its set of element ints).  `canonical` reads an object of either
package as plain nested tuples of ints, so two objects compare element
by element.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from . import resolve_device
from .curves import bls12_381 as bls
from .curves import extra_curves
from .legogroth16 import snark

JAX_LIMB_BITS = 15


def jax_limbs(p: int) -> int:
    return -(-p.bit_length() // JAX_LIMB_BITS)


def port_limbs(p: int) -> int:
    return -(-p.bit_length() // 32)


def _factor(p: int, to_port: bool, mont: bool) -> int:
    if not mont:
        return 1
    r_jax = 1 << (JAX_LIMB_BITS * jax_limbs(p))
    r_port = 1 << (32 * port_limbs(p))
    f = pow(r_jax, -1, p) * r_port % p
    return f if to_port else pow(f, -1, p)


def jax_to_port(arr, p: int, mont: bool = True,
                device="cuda") -> torch.Tensor:
    """(..., L_jax) 15-bit-limb array -> (L, ...) int32 tensor on `device`
    (CUDA unless the caller names the CPU)."""
    device = resolve_device(device)
    a = np.asarray(arr).astype(np.int64)
    Lj, L = a.shape[-1], port_limbs(p)
    shape = a.shape[:-1]
    rows = a.reshape(-1, Lj)
    f = _factor(p, True, mont)
    buf = bytearray()
    for row in rows:
        v = 0
        for limb in row[::-1]:
            v = (v << JAX_LIMB_BITS) | int(limb)
        buf += (v * f % p).to_bytes(4 * L, "little")
    out = np.frombuffer(bytes(buf), dtype="<u4").reshape(-1, L)
    t = torch.from_numpy(out.view(np.int32).T.copy())
    return t.reshape((L,) + shape).to(device)


def port_to_jax(t: torch.Tensor, p: int, mont: bool = True) -> np.ndarray:
    """(L, ...) int32 tensor -> (..., L_jax) 15-bit-limb int32 array."""
    a = t.detach().to("cpu").numpy()
    L, Lj = a.shape[0], jax_limbs(p)
    shape = a.shape[1:]
    rows = np.ascontiguousarray(a.reshape(L, -1).T).view("<u4")
    f = _factor(p, False, mont)
    out = np.zeros((rows.shape[0], Lj), dtype=np.int32)
    mask = (1 << JAX_LIMB_BITS) - 1
    for i, row in enumerate(rows):
        v = int.from_bytes(row.tobytes(), "little") * f % p
        for j in range(Lj):
            out[i, j] = v & mask
            v >>= JAX_LIMB_BITS
    return out.reshape(shape + (Lj,))


def jax_to_port_fq2(arr, p: int, mont: bool = True,
                    device="cuda") -> torch.Tensor:
    """Fq2 over the base prime p: (..., 2, L_jax) array (the JAX package's
    `JQuadField` layout) -> (2L, ...) tensor on `device`, c0's limbs in
    rows [:L] and c1's in [L:] (`fields/ttower.py`)."""
    a = np.asarray(arr)
    return torch.cat([jax_to_port(a[..., k, :], p, mont, device)
                      for k in (0, 1)])


def port_to_jax_fq2(t: torch.Tensor, p: int, mont: bool = True) -> np.ndarray:
    """(2L, ...) Fq2 tensor -> (..., 2, L_jax) array."""
    L = port_limbs(p)
    return np.stack([port_to_jax(t[:L], p, mont), port_to_jax(t[L:], p, mont)],
                    axis=-2)


def jax_to_port_fq6(arr, p: int, mont: bool = True,
                    device="cuda") -> torch.Tensor:
    """Fq6: (..., 3, 2, L_jax) array (`JCubicField`) -> (6L, ...) tensor,
    c0's 2L rows, then c1's, then c2's (`fields/ttower.py`)."""
    a = np.asarray(arr)
    return torch.cat([jax_to_port_fq2(a[..., k, :, :], p, mont, device)
                      for k in range(3)])


def port_to_jax_fq6(t: torch.Tensor, p: int, mont: bool = True) -> np.ndarray:
    """(6L, ...) Fq6 tensor -> (..., 3, 2, L_jax) array."""
    return np.stack([port_to_jax_fq2(c, p, mont) for c in t.chunk(3)],
                    axis=-3)


def jax_to_port_fq12(arr, p: int, mont: bool = True,
                     device="cuda") -> torch.Tensor:
    """Fq12: (..., 2, 3, 2, L_jax) array (`JQuadOverCubicField`) ->
    (12L, ...) tensor, c0's 6L rows, then c1's."""
    a = np.asarray(arr)
    return torch.cat([jax_to_port_fq6(a[..., k, :, :, :], p, mont, device)
                      for k in range(2)])


def port_to_jax_fq12(t: torch.Tensor, p: int,
                     mont: bool = True) -> np.ndarray:
    """(12L, ...) Fq12 tensor -> (..., 2, 3, 2, L_jax) array."""
    return np.stack([port_to_jax_fq6(c, p, mont) for c in t.chunk(2)],
                    axis=-4)


# ---------------------------------------------------------------------------
# host objects: points, proving keys and proofs, read by attribute only
# ---------------------------------------------------------------------------

def _coord_ints(e) -> tuple:
    """A coordinate as ints: (v,) over a prime field, (c0, c1) over Fq2."""
    return (int(e.c0), int(e.c1)) if hasattr(e, "c0") else (int(e),)


def point_ints(pt) -> tuple:
    """A host point's Jacobian coordinates as int tuples, read from its
    `.X`, `.Y`, `.Z` (a point of either package)."""
    return tuple(_coord_ints(c) for c in (pt.X, pt.Y, pt.Z))


def point_from_ints(ints: tuple, curve):
    """The point of `curve` (an `SWCurve` of either package) with these
    coordinate ints (`point_ints`' form)."""
    K = curve.K
    X, Y, Z = (K(*c) for c in ints)
    return type(curve.infinity())(X, Y, Z, curve)


def carry_point(pt, curve):
    """A host point of one package as the same point of `curve`, a curve
    of the other (or the same) package: the reference's `Point` to the
    port's and back."""
    return point_from_ints(point_ints(pt), curve)


def fp12_ints(x) -> tuple:
    """A host Fq12 element of either package as nested int tuples,
    ((c0.c0.c0, c0.c0.c1), ...), read from its `.c0`/`.c1`/`.c2`."""
    return tuple(tuple((int(c2.c0), int(c2.c1)) for c2 in (c6.c0, c6.c1, c6.c2))
                 for c6 in (x.c0, x.c1))


def fp12_from_ints(ints: tuple, fq12):
    """The element of `fq12` (a `QuadOverCubic` of either package) with
    these ints (`fp12_ints`' form)."""
    fq6 = fq12.fq6
    return fq12(*(fq6(*(fq6.fq2(*c2) for c2 in c6)) for c6 in ints))


def carry_fp12(x, fq12):
    """A host Fq12 element of one package as the same element of `fq12`,
    a tower of the other (or the same) package."""
    return fp12_from_ints(fp12_ints(x), fq12)


def carry_pairs(pairs, g1, g2) -> list:
    """Host (G1, G2) pairs of one package as the same pairs on the curves
    `g1` and `g2` of the other."""
    return [(carry_point(p, g1), carry_point(q, g2)) for p, q in pairs]


def _port_curve(pt, mod):
    """The port's curve that `pt` lies on: secp256r1 (BBS#) by name, else
    the G1 or G2 of the port's curve module `mod`."""
    if pt.curve.name == extra_curves.secp256r1.name:
        return extra_curves.secp256r1
    return mod.G2 if hasattr(pt.X, "c0") else mod.G1


def proving_key_to_port(pk, mod=bls):
    """A LegoGroth16 `ProvingKey` of the reference as the port's, over the
    port's curve module `mod` (`curves.bls12_381`, the default, or
    `curves.bn254`: the key's own curve), read attribute by attribute."""
    def pt(p):
        return carry_point(p, _port_curve(p, mod))

    vk = pk.vk
    return snark.ProvingKey(
        vk=snark.VerifyingKey(
            alpha_g1=pt(vk.alpha_g1), beta_g2=pt(vk.beta_g2),
            gamma_g2=pt(vk.gamma_g2), delta_g2=pt(vk.delta_g2),
            gamma_abc_g1=[pt(q) for q in vk.gamma_abc_g1],
            eta_gamma_inv_g1=pt(vk.eta_gamma_inv_g1),
            commit_witness_count=int(vk.commit_witness_count)),
        beta_g1=pt(pk.beta_g1), delta_g1=pt(pk.delta_g1),
        eta_delta_inv_g1=pt(pk.eta_delta_inv_g1),
        **{name: [pt(q) for q in getattr(pk, name)]
           for name in ("a_query", "b_g1_query", "b_g2_query", "h_query",
                        "l_query")})


def proof_ints(proof) -> dict:
    """A LegoGroth16 `Proof` as {"a", "b", "c", "d": `point_ints`}: what
    rebuilds it in the other package (`point_from_ints` on that package's
    G1, and G2 for "b")."""
    return {k: point_ints(getattr(proof, k)) for k in ("a", "b", "c", "d")}


_PORT_FIELDS = {bls.Fr.p: bls.Fr, bls.Fq.p: bls.Fq,
                extra_curves.secp256r1_Fr.p: extra_curves.secp256r1_Fr}
_REFERENCE = "crypto_tpu."


def _port_class(obj):
    """The port's class of the same name as `obj`'s, in the port's module
    of the same name (`crypto_tpu.saver.core` -> `crypto_tpu_torch.saver.
    core`)."""
    mod, name = type(obj).__module__, type(obj).__name__
    if not mod.startswith(_REFERENCE):
        raise TypeError(f"{name} is not a class of the reference package")
    port = importlib.import_module(
        "crypto_tpu_torch." + mod[len(_REFERENCE):])
    cls = getattr(port, name, None)
    if cls is None:
        raise TypeError(f"the port has no protocol class {name}")
    return cls


def _is_fp12(obj) -> bool:
    return hasattr(obj, "c1") and hasattr(getattr(obj, "c0", None), "c2")


def _slots(obj) -> tuple:
    """The `__slots__` of a protocol class of either package (a Pedersen
    commitment key), which its constructor takes by name; () otherwise."""
    mod = type(obj).__module__
    if not mod.startswith(("crypto_tpu.", "crypto_tpu_torch.")):
        return ()
    return tuple(getattr(type(obj), "__slots__", ()))


def _store(obj) -> bool:
    """Whether `obj` is an accumulator's in-memory element store of either
    package (`accumulator/persistence.py`): its elements are the int set
    `db`."""
    return type(obj).__module__.endswith(".accumulator.persistence") and \
        isinstance(getattr(obj, "db", None), set)


def protocol_to_port(obj, _memo=None):
    """A protocol object of the reference (params, keys, signatures,
    proofs, protocols, ciphertexts, SRSs, and the proof system's specs,
    statements, meta-statements, witnesses and composite proofs) as the
    port's object of the class of the same name, field by field: points
    through `carry_point` onto the port's BLS12-381 (or secp256r1, by
    curve name), GT elements through `carry_fp12`, field
    elements by value, lists, tuples, sets and dicts item by item; ints,
    bools, bytes, strings and None as they are.  An object met twice in
    one call is carried once, so objects that several statements
    share stay shared (`DerivedParamsTracker` keys on identity)."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)][1]

    def carry(x):
        return protocol_to_port(x, memo)

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = _port_class(obj)(**{f.name: carry(getattr(obj, f.name))
                                  for f in dataclasses.fields(obj)})
    elif hasattr(obj, "curve") and hasattr(obj, "Z"):
        out = carry_point(obj, _port_curve(obj, bls))
    elif _is_fp12(obj):
        out = carry_fp12(obj, bls.Fq12)
    elif hasattr(obj, "f") and hasattr(obj, "v"):
        out = _PORT_FIELDS[obj.f.p](int(obj))
    elif _slots(obj) and obj.__class__.__module__.startswith(_REFERENCE):
        out = _port_class(obj)(**{s: carry(getattr(obj, s))
                                  for s in _slots(obj)})
    elif _store(obj) and obj.__class__.__module__.startswith(_REFERENCE):
        out = _port_class(obj)()
        out.db = set(obj.db)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        out = type(obj)(carry(x) for x in obj)
    elif isinstance(obj, dict):
        out = {k: carry(v) for k, v in obj.items()}
    elif obj is None or isinstance(obj, (bool, int, bytes, str)):
        return obj
    else:
        raise TypeError(f"cannot carry a {type(obj).__name__} to the port")
    memo[id(obj)] = (obj, out)     # obj held: its id stays its own
    return out


def canonical(obj):
    """An object of either package as plain nested tuples: a dataclass as
    its class name and fields, a point as its affine coordinate ints (or
    "inf"), a GT element as `fp12_ints`, a field element as its int, lists
    and tuples item by item, a set as its items' sorted forms.  Equal
    objects of the two packages give equal values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, canonical(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if hasattr(obj, "curve") and hasattr(obj, "Z"):
        if obj.is_infinity():
            return "inf"
        return tuple(_coord_ints(c) for c in obj.to_affine())
    if _is_fp12(obj):
        return fp12_ints(obj)
    if hasattr(obj, "f") and hasattr(obj, "v"):
        return int(obj)
    if _slots(obj):
        return (type(obj).__name__,) + tuple(
            (s, canonical(getattr(obj, s))) for s in _slots(obj))
    if _store(obj):
        return (type(obj).__name__, tuple(sorted(obj.db)))
    if isinstance(obj, (list, tuple)):
        return tuple(canonical(x) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set",) + tuple(sorted(canonical(x) for x in obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, canonical(v)) for k, v in obj.items()))
    if obj is None or isinstance(obj, (bool, int, bytes, str)):
        return obj
    raise TypeError(f"no canonical form for a {type(obj).__name__}")
