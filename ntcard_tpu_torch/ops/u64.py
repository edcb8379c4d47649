"""Unsigned 64-bit arithmetic on int64 tensors (port of ntcard_tpu/utils/u64.py).

The JAX package carries a 64-bit hash as a (hi, lo) pair of uint32 arrays
because the TPU has no 64-bit lanes. PyTorch has int64 on every device, but
its CPU build has no ``>>``, ``<`` or ``minimum`` for uint32/uint64. So a
hash here is one int64 tensor holding the uint64 bit pattern:

* left shifts, XOR, AND and OR are the same bits in int64 (shifts wrap);
* a right shift is arithmetic in int64, so :func:`lsr` masks the sign fill;
* an unsigned compare flips the sign bit of both sides (:func:`ult`).
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
_MIN64 = -(1 << 63)


def as_i64(v: int) -> int:
    """A uint64 Python int as the int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def to_u64(x: torch.Tensor):
    """int64 tensor -> numpy uint64 array with the same bits (tests, debug)."""
    return x.cpu().numpy().view("uint64")


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of a uint64 bit pattern by a constant 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit a < b."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit elementwise min."""
    return torch.where(ult(a, b), a, b)


def lut5(code: torch.Tensor, table5: torch.Tensor) -> torch.Tensor:
    """Lookup into a 5-entry int64 table by base code: 0..3 index their
    entry and every other code reads entry 4 (N), as the JAX select chain
    does."""
    return table5[code.clamp(max=4).long()]
