"""Explicit device resolution: the port never picks the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA request on a machine without CUDA
    raises instead of carrying on on the CPU: the CPU runs only the plain
    versions of the kernels, and a caller must ask for that by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ntcard_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ntcard_tpu_torch: unsupported device {dev}")
    return dev
