"""Explicit device resolution: the port never picks the CPU on its own."""

from __future__ import annotations

from typing import List

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


class DeviceCountError(ValueError):
    """More CUDA devices were asked for than the machine has."""


def resolve_devices(device=None, count: int = 0) -> List[torch.device]:
    """The devices a run counts on, one private sketch each.

    ``device`` is a sequence (those devices, in order; a device may repeat),
    ``None`` or ``"cuda"`` (the first ``count`` local cards, every local card
    for 0), or any other single device (that device alone). Asking for more
    cards than the machine has raises :class:`DeviceCountError`: a run never
    drops the work of a card it does not have."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("ntcard_tpu_torch: an empty device list")
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    n_local = torch.cuda.device_count()
    if count > n_local:
        raise DeviceCountError(
            f"--devices {count} asks for more than the {n_local} local CUDA device(s)"
        )
    return [torch.device("cuda", i) for i in range(count or n_local)]
