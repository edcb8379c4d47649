"""nthll's HyperLogLog sketch on one device (port of
ntcard_tpu/models/hll.py::HllSketch).

State: int32 registers [2^n_bits] on the device. A batch step decodes the
wire (ops/nthash.codes_T) and runs K5 (ops/hll.hll_update_), which hashes
every owned window and max-updates the registers in place. Max commutes,
so any batching gives the same registers.
"""

from __future__ import annotations

import numpy as np
import torch

from ntcard_tpu_torch.device import resolve_device
from ntcard_tpu_torch.ops.hll import hll_update_
from ntcard_tpu_torch.ops.nthash import codes_T


class HllSketch:
    """Streaming nthll sketch: :meth:`update` with wire or code batches,
    :meth:`registers` for the uint8 registers that
    models.estimate.estimate_f0 reads. ``device=None`` means CUDA and raises
    without it (device.resolve_device)."""

    def __init__(self, k: int, n_bits: int, stride: int, device=None):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax) so the sketch and "
                "packer agree on window ownership"
            )
        self.k = k
        self.n_bits = n_bits
        self.n_buck = 1 << n_bits
        self.stride = stride
        self.device = resolve_device(device)
        self.regs = torch.zeros(self.n_buck, dtype=torch.int32, device=self.device)

    def update(self, codes: torch.Tensor, packed=False) -> None:
        """codes: a [B, L] uint8 code batch, or a wire batch when ``packed``
        (see ntcard_tpu_torch.ops.nthash.codes_T), on the sketch's device."""
        cT = codes_T(codes, packed)  # [L, B]
        hll_update_(self.regs, cT.T, self.k, self.stride, self.n_bits)

    def registers(self) -> np.ndarray:
        return self.regs.cpu().numpy().astype(np.uint8)
