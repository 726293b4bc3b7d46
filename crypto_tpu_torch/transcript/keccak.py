"""Keccak-f[1600] permutation (host side): the port's own copy of
`crypto_tpu/transcript/keccak.py`, in pure Python.

Foundation of the STROBE-128 sponge used by merlin transcripts (reference
vendors a merlin fork: `merlin/src/strobe.rs`).  Implemented from the Keccak
specification; operates on a 200-byte bytearray in place.  The reference
also loads a C++ permutation from its native library when it is built;
the port keeps to Python, whose permutation is the same function.
"""

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes),
    in pure Python."""
    assert len(state) == 200
    # load lanes A[x][y]
    A = [[0] * 5 for _ in range(5)]
    for y in range(5):
        for x in range(5):
            off = 8 * (5 * y + x)
            A[x][y] = int.from_bytes(state[off:off + 8], "little")

    for rc in _ROUND_CONSTANTS:
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x][y] ^= D[x]
        # rho + pi
        B = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y] & _MASK) & B[(x + 2) % 5][y])
        # iota
        A[0][0] ^= rc

    for y in range(5):
        for x in range(5):
            off = 8 * (5 * y + x)
            state[off:off + 8] = A[x][y].to_bytes(8, "little")
