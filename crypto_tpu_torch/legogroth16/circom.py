"""Circom frontend, binary `.r1cs` reader and circuit adapter: the port's
own copy of `crypto_tpu/legogroth16/circom.py` (reference
`legogroth16/src/circom/{r1cs_reader,r1cs,circuit}.rs`).  Host code: the
circuit it synthesizes is proven by `legogroth16/snark.py`, whose
witness map and query MSMs run on the device.

Parses the iden3 R1CS binary format (magic "r1cs", sectioned):
  header: field byte size, prime (LE), nWires, nPubOut, nPubIn, nPrvIn,
          nLabels, nConstraints
  constraints: per constraint three sparse linear combinations, each
          [n_entries u32][ (wire_id u32, coeff field-LE) * n ]
  wire-to-label map (ignored here)

Wire convention (circom): wire 0 = ONE, wires 1..nPubOut+nPubIn are public
(outputs first), the rest private.  `CircomCircuit` synthesizes these into
our ConstraintSystem so LegoGroth16 can prove against circuits compiled by
circom.  The header's prime names the curve: BLS12-381's r, or BN254's
(circom's default); `circom_circuit` takes the matching scalar field.

Witness generation from the companion `.wasm` (circom's generated
calculator) is not ported: callers supply the wire assignment.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..curves import bls12_381 as bls
from ..fields.host import Field
from ..r1cs.cs import ConstraintSystem, LinearCombination, Variable, SynthesisError

F = bls.Fr

R1CS_MAGIC = b"r1cs"
SEC_HEADER = 1
SEC_CONSTRAINTS = 2
SEC_WIRE2LABEL = 3


@dataclass
class CircomR1CS:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_constraints: int
    constraints: list  # [(A, B, C)] with each a list[(coeff int, wire int)]

    @property
    def n_public(self) -> int:
        return self.n_pub_out + self.n_pub_in


def parse_r1cs(path: str) -> CircomR1CS:
    """The circuit of an iden3 `.r1cs` file."""
    with open(path, "rb") as f:
        return parse_r1cs_bytes(f.read())


def parse_r1cs_bytes(data: bytes) -> CircomR1CS:
    """The circuit of an iden3 `.r1cs` file's bytes."""
    if data[:4] != R1CS_MAGIC:
        raise SynthesisError("not an r1cs file")
    version, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        sec_type, sec_size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[sec_type] = (off, sec_size)
        off += sec_size

    ho, hs = sections[SEC_HEADER]
    fs = struct.unpack_from("<I", data, ho)[0]
    prime = int.from_bytes(data[ho + 4: ho + 4 + fs], "little")
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from(
        "<IIII", data, ho + 4 + fs)
    _n_labels, n_constraints = struct.unpack_from(
        "<QI", data, ho + 4 + fs + 16)

    co, cs_size = sections[SEC_CONSTRAINTS]
    pos = co
    constraints = []

    def read_lc():
        nonlocal pos
        n = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        out = []
        for _ in range(n):
            wire = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            coeff = int.from_bytes(data[pos:pos + fs], "little")
            pos += fs
            out.append((coeff, wire))
        return out

    for _ in range(n_constraints):
        a = read_lc()
        b = read_lc()
        c = read_lc()
        constraints.append((a, b, c))

    return CircomR1CS(prime=prime, n_wires=n_wires, n_pub_out=n_pub_out,
                      n_pub_in=n_pub_in, n_prv_in=n_prv_in,
                      n_constraints=n_constraints, constraints=constraints)


def circom_circuit(r1cs: CircomR1CS, field: Field = None,
                   wire_assignment: list | None = None,
                   commit_witness_count: int = 0):
    """ConstraintSynthesizer over a parsed circom circuit.

    `wire_assignment`: full wire values [1, publics..., privates...] in
    circom wire order (required in proving mode)."""
    field = field or F
    if r1cs.prime != field.p:
        raise SynthesisError("r1cs curve mismatch")

    def circuit(cs: ConstraintSystem):
        wa = wire_assignment
        if cs.mode == "prove" and wa is None:
            raise SynthesisError("missing wire assignment")
        # allocate public wires 1..n_public as inputs, rest as witnesses
        for w in range(1, r1cs.n_public + 1):
            cs.new_input(None if wa is None else field(int(wa[w])))
        for w in range(r1cs.n_public + 1, r1cs.n_wires):
            cs.new_witness(None if wa is None else field(int(wa[w])))
        # circom wire ids == our variable indices (same layout)
        for (a, b, c) in r1cs.constraints:
            mk = lambda lc: LinearCombination(
                [(field(coeff), Variable(wire)) for coeff, wire in lc])
            cs.enforce(mk(a), mk(b), mk(c))
    return circuit
