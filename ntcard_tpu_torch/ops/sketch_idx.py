"""K1: hash, sample and bucket every window (port of the Pallas kernel
ntcard_tpu/ops/nthash_pallas.py::sketch_idx_pallas).

:func:`sketch_idx` is the wrapper: on a CUDA tensor it launches the hand
kernel csrc/sketch_idx.cu, on a CPU tensor it runs :func:`sketch_idx_plain`.
Emit protocol (nthash_pallas.py:15-21): per window start p and k, a table
index in [0, 2^(r+1)), or S0 = 2^(r+1) when the window is valid but
unsampled, or S1 = S0 + 1 when it holds an N or p >= stride. With
``mask_positions`` (spaced seeds, a single k) the hash is the spaced-seed
hash of ntcard_tpu.ops.nthash.window_hashes_doubling.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ntcard_tpu_torch import _build
from ntcard_tpu_torch.ops.nthash import make_sketch_emit, window_hashes_doubling
from ntcard_tpu_torch.ops.rotations import device_seeds, strip_tables


def _check_args(codes, ks, stride, s_bits, r_bits, mask_positions):
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype}{list(codes.shape)}")
    if not ks or min(ks) < 1:
        raise ValueError(f"ks must be positive, got {ks}")
    if stride < 1 or stride + max(ks) - 1 > codes.shape[1]:
        raise ValueError(
            f"stride ({stride}) + kmax ({max(ks)}) - 1 must be within the row length "
            f"({codes.shape[1]})"
        )
    make_sketch_emit(s_bits, r_bits)  # validates s_bits / r_bits
    if mask_positions:
        if len(ks) != 1:
            raise ValueError("spaced seeds support a single k only (reference parity)")
        if not all(0 <= p < ks[0] for p in mask_positions):
            raise ValueError(f"mask positions must lie in [0, {ks[0]}), got {mask_positions}")


def sketch_idx_plain(
    codes: torch.Tensor,
    ks: Sequence[int],
    stride: int,
    s_bits: int,
    r_bits: int,
    mask_positions: Sequence[int] | None = None,
) -> torch.Tensor:
    """Plain PyTorch K1: window doubling + ntcard's emit + the S0/S1 map."""
    _check_args(codes, ks, stride, s_bits, r_bits, mask_positions)
    B, L = codes.shape
    sent1 = 2 * (1 << r_bits) + 1
    emit = make_sketch_emit(s_bits, r_bits)
    hashes = window_hashes_doubling(codes.T, tuple(ks), stride, mask_positions)
    out = torch.full((len(ks), B, L), sent1, dtype=torch.int32, device=codes.device)
    for t, k in enumerate(ks):
        h, valid = hashes[k]  # [stride, B]
        # emit maps invalid windows to S0; they are S1 in this protocol
        out[t, :, :stride] = torch.where(valid, emit(h, valid), sent1).T
    return out


_PARAMS: dict = {}


def _params(dev: torch.device, ks: tuple, mask: tuple):
    """The kernel's constant inputs on ``dev``, built once per (device, ks,
    mask): no H2D copy per batch."""
    key = (dev, ks, mask)
    if key not in _PARAMS:
        strips = None
        if mask:
            ft, rt = strip_tables(ks[0], mask, dev)
            strips = (torch.tensor(mask, dtype=torch.int32, device=dev), ft, rt)
        _PARAMS[key] = (torch.tensor(ks, dtype=torch.int32, device=dev), strips)
    return _PARAMS[key]


def sketch_idx(
    codes: torch.Tensor,
    ks: Sequence[int],
    stride: int,
    s_bits: int,
    r_bits: int,
    mask_positions: Sequence[int] | None = None,
) -> torch.Tensor:
    """[B, L] uint8 codes (any strides) -> [nK, B, L] int32 emit indices.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises). The position-major [L, B] stream of the main path is passed
    as its transposed view, which the kernel reads with coalesced loads."""
    if codes.device.type != "cuda":
        return sketch_idx_plain(codes, ks, stride, s_bits, r_bits, mask_positions)
    _check_args(codes, ks, stride, s_bits, r_bits, mask_positions)
    B, L = codes.shape
    dev = codes.device
    mask = tuple(mask_positions or ())
    out = torch.empty((len(ks), B, L), dtype=torch.int32, device=dev)
    ks_t, strips = _params(dev, tuple(ks), mask)
    mpos, mf, mr = (t.data_ptr() for t in strips) if strips else (None, None, None)
    P, I, LL = _build.P, _build.I, _build.LL
    fn = _build.fn(
        "sketch_idx", "ntc_sketch_idx", [P, LL, LL, I, I, P, I, I, P, P, P, P, I, I, I, I, P, P]
    )
    with torch.cuda.device(dev):
        rc = fn(
            codes.data_ptr(), codes.stride(0), codes.stride(1), B, L,
            ks_t.data_ptr(), len(ks), max(ks), device_seeds(dev).data_ptr(), mpos, mf, mr,
            len(mask), stride, s_bits, r_bits, out.data_ptr(), _build.stream_ptr(codes),
        )
        sketch_idx.launches += 1
    _build.check(rc, "sketch_idx")
    return out


sketch_idx.launches = 0
