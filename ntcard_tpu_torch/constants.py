"""ntHash constants, the split rotation on Python ints, and the base coding
(the port's copy of what it needs from ntcard_tpu/constants.py).

The four per-base 64-bit seeds are the frozen, published ntHash constants
(reference vendor/ntHash/nthash.hpp:22-29): every hash value depends on
them bit for bit, so they are copied, never derived.

ntHash treats a 64-bit word as two independent cyclic rings, a 33-bit ring
in bits 0..32 and a 31-bit ring in bits 33..63 (nthash.hpp:185-217); the
reference's per-base rotation tables are ``rot_seed(b, n) == srol^n(seed(b))``.

Base coding: 0=A, 1=C, 2=G, 3=T(=U), 4=N/other.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK33 = (1 << 33) - 1
MASK31 = (1 << 31) - 1

# Frozen ntHash seed constants (nthash.hpp:25-29).
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

# Base codes.
A, C, G, T, N = 0, 1, 2, 3, 4

# seeds indexed by base code; N hashes to 0.
SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T, SEED_N)

# complement code: A<->T, C<->G, N->N.
COMP_CODE = (T, G, C, A, N)


def srol_n(v: int, n: int) -> int:
    """srol applied n times, in O(1): rotate each ring by n mod its width."""
    v &= MASK64
    lo33 = v & MASK33
    hi31 = v >> 33
    s33 = n % 33
    s31 = n % 31
    lo33 = ((lo33 << s33) | (lo33 >> (33 - s33))) & MASK33 if s33 else lo33
    hi31 = ((hi31 << s31) | (hi31 >> (31 - s31))) & MASK31 if s31 else hi31
    return (hi31 << 33) | lo33


def rot_seed(code: int, n: int) -> int:
    """srol^n(seed(code)): the reference's ``msTab31l[ch][n%31] |
    msTab33r[ch][n%33]`` (nthash.hpp:115-183) for this base code."""
    return srol_n(SEEDS[code], n)


# ASCII -> base-code table (seedTab semantics, nthash.hpp:31-64): 'A'/'a' ->
# A, 'C'/'c' -> C, 'G'/'g' -> G, 'T'/'t'/'U'/'u' -> T, everything else -> N.
ASCII_TO_CODE = np.full(256, N, dtype=np.uint8)
for _chars, _code in (("Aa", A), ("Cc", C), ("Gg", G), ("TtUu", T)):
    for _ch in _chars:
        ASCII_TO_CODE[ord(_ch)] = _code
del _chars, _code, _ch
