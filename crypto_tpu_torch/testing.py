"""Helpers for the port's CPU tests."""

from __future__ import annotations

import os

import torch


def cap_threads() -> int:
    """Give PyTorch's intra-op pool this process's share of the cores: all
    of them over the number of pytest-xdist workers
    (`PYTEST_XDIST_WORKER_COUNT`, 1 outside xdist), at least one.  Under
    six workers on eight cores each worker's pool would otherwise start
    eight threads, and the CPU-heavy tests would contend for the cores
    about sixfold.  Returns the thread count set."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // max(1, workers))
    torch.set_num_threads(n)
    return n


def r1cs_bytes(prime: int, n_pub_out: int, n_pub_in: int, n_prv_in: int,
               n_wires: int, constraints) -> bytes:
    """An iden3 `.r1cs` file (version 1: the header, constraints and
    wire-to-label sections) over the scalar field of `prime`, as circom
    writes one: wire 0 is ONE, then the public outputs, the public inputs,
    the private inputs and the other wires.  `constraints`: [(A, B, C)],
    each a list of (coefficient int, wire) terms.  Test support: what
    `legogroth16/circom.py` `parse_r1cs` reads."""
    import struct
    fs = 32 * -(-prime.bit_length() // 256)

    def section(kind: int, body: bytes) -> bytes:
        return struct.pack("<IQ", kind, len(body)) + body

    header = struct.pack("<I", fs) + prime.to_bytes(fs, "little") + \
        struct.pack("<IIIIQI", n_wires, n_pub_out, n_pub_in, n_prv_in,
                    n_wires, len(constraints))
    body = bytearray()
    for lcs in constraints:
        for lc in lcs:
            body += struct.pack("<I", len(lc))
            for coeff, wire in lc:
                body += struct.pack("<I", wire)
                body += (coeff % prime).to_bytes(fs, "little")
    labels = b"".join(struct.pack("<Q", w) for w in range(n_wires))
    return b"r1cs" + struct.pack("<II", 1, 3) + section(1, header) + \
        section(2, bytes(body)) + section(3, labels)


def r1cs_of(cs, n_pub_out: int, n_prv_in: int) -> bytes:
    """The `.r1cs` bytes of a synthesized `r1cs.cs.ConstraintSystem` whose
    variables follow circom's order: its public inputs are the circuit's
    `n_pub_out` outputs (no public input), its first `n_prv_in`
    witnesses the private inputs."""
    n_pub = cs.num_instance - 1
    if n_pub != n_pub_out:
        raise ValueError(f"{n_pub} public variables, {n_pub_out} outputs")
    return r1cs_bytes(cs.F.p, n_pub_out, 0, n_prv_in,
                      cs.num_instance + cs.num_witness,
                      [([(c, i) for c, i in a], [(c, i) for c, i in b],
                        [(c, i) for c, i in c_])
                       for a, b, c_ in zip(cs.a_rows, cs.b_rows,
                                           cs.c_rows)])
