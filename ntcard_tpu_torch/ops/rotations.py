"""ntHash's split rotation P^n on int64 tensors (port of
ntcard_tpu/ops/rotations.py) and the per-base seed tables.

P = srol rotates a 33-bit ring in bits 0..32 and a 31-bit ring in bits
33..63 left by one (reference nthash.hpp:185-217), so P^n rotates the rings
by n mod 33 and n mod 31. The JAX package needs two forms on the TPU, one
with constant shifts (``srol_const``) and one with multiplies for amounts
that vary per element (``srol_var_iota``); with native 64-bit shifts both are
:func:`srol_n`, with ``n`` an int or an int64 tensor.
"""

from __future__ import annotations

import torch

from ntcard_tpu_torch import constants as C
from ntcard_tpu_torch.ops.u64 import as_i64, lsr

_M33 = (1 << 33) - 1


def srol_n(x: torch.Tensor, n) -> torch.Tensor:
    """P^n of a uint64 bit pattern held in int64; ``n`` is a non-negative
    int or an int64 tensor of per-element amounts (broadcast against x)."""
    s33 = n % 33
    s31 = n % 31
    lo = x & _M33  # 33-bit ring, non-negative
    hi = lsr(x, 33)  # 31-bit ring, non-negative
    # a ring value below 2^33 shifted right by up to 33 bits needs no mask;
    # the left shift may wrap past bit 63, which the ring mask discards
    lo = ((lo << s33) | (lo >> (33 - s33))) & _M33
    hi = ((hi << s31) | (hi >> (31 - s31))) & C.MASK31
    return (hi << 33) | lo


def seed_table(device=None) -> torch.Tensor:
    """(5,) int64 seeds by base code (N hashes to 0)."""
    return torch.tensor([as_i64(s) for s in C.SEEDS], dtype=torch.int64, device=device)


def comp_seed_table(device=None) -> torch.Tensor:
    """(5,) int64 seeds of the complement base, by base code."""
    return torch.tensor(
        [as_i64(C.SEEDS[C.COMP_CODE[b]]) for b in range(5)], dtype=torch.int64, device=device
    )


_DEVICE_SEEDS: dict = {}


def device_seeds(device: torch.device) -> torch.Tensor:
    """(10,) int64 on ``device``: seed_table then comp_seed_table, the seed
    input of the hand kernels; made once per device, so no launch copies it."""
    if device not in _DEVICE_SEEDS:
        _DEVICE_SEEDS[device] = torch.cat([seed_table(), comp_seed_table()]).to(device)
    return _DEVICE_SEEDS[device]


def strip_tables(k: int, mask_positions, device=None):
    """Spaced-seed strip tables, two (n_mask, 5) int64 tensors by base code:
    the forward contribution P^(k-1-p)(seed(b)) and the reverse one
    P^p(seed(comp b)) of a base b at masked position p
    (ntcard_tpu/ops/nthash.py:371-383)."""

    def table(rows):
        return torch.tensor(
            [[as_i64(v) for v in row] for row in rows], dtype=torch.int64, device=device
        ).reshape(len(rows), 5)

    fwd = [[C.rot_seed(b, k - 1 - p) for b in range(5)] for p in mask_positions]
    rev = [[C.rot_seed(C.COMP_CODE[b], p) for b in range(5)] for p in mask_positions]
    return table(fwd), table(rev)
