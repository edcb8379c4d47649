"""K5: the nthll register update, hash + leading zeros + register max in one
kernel (csrc/hll_update.cu). The JAX package has no Pallas kernel here: its
contract is the XLA scatter max of ntcard_tpu/models/hll.py:27-30 over
ntcard_tpu.ops.nthash.hll_scan.

:func:`hll_update_` is the wrapper: on a CUDA tensor it launches the hand
kernel (or raises), on a CPU tensor it runs :func:`hll_update_plain`. A
call is two launches of the one source: the register minima, then the
update, which skips every window that cannot beat the least register.
"""

from __future__ import annotations

import torch

from ntcard_tpu_torch import _build
from ntcard_tpu_torch.ops.nthash import hll_scan, make_hll_emit
from ntcard_tpu_torch.ops.rotations import device_seeds


def _check_args(regs, codes, k, stride, n_bits):
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype}{list(codes.shape)}")
    if k < 1 or stride < 1 or stride + k - 1 > codes.shape[1]:
        raise ValueError(
            f"stride ({stride}) + k ({k}) - 1 must be within the row length ({codes.shape[1]})"
        )
    make_hll_emit(n_bits)  # validates n_bits
    if (
        regs.dtype != torch.int32
        or tuple(regs.shape) != (1 << n_bits,)
        or not regs.is_contiguous()
        or regs.device != codes.device
    ):
        raise ValueError(
            f"regs must be a contiguous int32 [{1 << n_bits}] tensor on {codes.device}, got "
            f"{regs.dtype}{list(regs.shape)} on {regs.device}"
        )


def hll_update_plain(
    regs: torch.Tensor, codes: torch.Tensor, k: int, stride: int, n_bits: int
) -> torch.Tensor:
    """Plain PyTorch K5: hll_scan, then a scatter max into ``regs``."""
    _check_args(regs, codes, k, stride, n_bits)
    reg, run0 = hll_scan(codes, k, stride, n_bits)
    return regs.scatter_reduce_(0, reg.long(), run0, "amax")


def hll_update_(
    regs: torch.Tensor, codes: torch.Tensor, k: int, stride: int, n_bits: int
) -> torch.Tensor:
    """regs[h & (2^n_bits-1)] = max(itself, clz64(h & ~(2^n_bits-1))) over
    the canonical hash h of every N-free window starting before ``stride``
    in the [B, L] uint8 ``codes`` (any strides); int32 ``regs``
    [2^n_bits] is updated in place and returned."""
    if codes.device.type != "cuda":
        return hll_update_plain(regs, codes, k, stride, n_bits)
    _check_args(regs, codes, k, stride, n_bits)
    dev = codes.device
    P, I, LL = _build.P, _build.I, _build.LL
    fn = _build.fn("hll_update", "ntc_hll_update", [P, LL, LL, I, I, I, P, I, I, P, P, P])
    n_partial = _build.fn("hll_update", "ntc_hll_partials", [I])(n_bits)
    partial = torch.empty(n_partial, dtype=torch.int32, device=dev)  # the register minima
    with torch.cuda.device(dev):
        rc = fn(
            codes.data_ptr(), codes.stride(0), codes.stride(1), codes.shape[0], codes.shape[1],
            k, device_seeds(dev).data_ptr(), stride, n_bits, regs.data_ptr(),
            partial.data_ptr(), _build.stream_ptr(codes),
        )
        hll_update_.launches += 1
    _build.check(rc, "hll_update")
    return regs


hll_update_.launches = 0
