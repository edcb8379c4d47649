"""Host-CPU engine: the full sketch pipeline without touching a device (the
port's copy of ntcard_tpu/models/host_engine.py).

It runs the same hash -> sample -> count semantics as the device kernels, in
the native C++ layer (packer.cpp ntcard_host_update /
ntcard_host_hll_update), over the SAME [batch_rows, chunk_len] packed
batches (identical separator / halo / stride window ownership), threading
within each batch over rows. The CLIs run it only beside the device, under
NTCARD_ENGINE=hybrid (pipeline.hybrid_feed); it is also the independent
full-size reference that chip_smoke.py holds the device path against.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ntcard_tpu_torch import native


class HostCountTableSketch:
    """ntcard count-table sketch on the host: uint16 [nK, 2*r_buck] table
    (the reference's exact layout and wrap semantics, ntcard.cpp:437-439)
    plus exact int64 F1 counts; update / finalize as CountTableSketch."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        n_threads: int = 0,
    ):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax)"
            )
        self.ks = tuple(ks)
        self.s_bits = s_bits
        self.r_bits = r_bits
        self.stride = stride
        self.gap_positions = tuple(gap_positions) if gap_positions else None
        self.r_buck = 1 << r_bits
        self.n_threads = n_threads
        nk = len(self.ks)
        self.tables = np.zeros((nk, 2 * self.r_buck), np.uint16)
        self.f1s = np.zeros((nk,), np.int64)

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        if packed:
            raise ValueError("host engine consumes raw [B, L] code batches")
        native.host_update(
            codes,
            self.stride,
            self.ks,
            self.s_bits,
            self.r_bits,
            self.tables,
            self.f1s,
            mask_positions=self.gap_positions,
            n_threads=self.n_threads,
        )

    def finalize(self, cov_max: int = 65535) -> Dict[int, dict]:
        """Same result dict as CountTableSketch.finalize: per-k counter-value
        histograms over bins 0..cov_max (native threaded scan) + exact F1."""
        nbins = min(cov_max + 1, 65536)
        out = {}
        for i, k in enumerate(self.ks):
            hist = np.empty((2, nbins), np.int64)
            for s in range(2):
                row = self.tables[i, s * self.r_buck : (s + 1) * self.r_buck]
                hist[s] = native.hist_u16_direct(row)[:nbins]
            out[k] = {"hist": hist, "f1": int(self.f1s[i])}
        return out


class HostHllSketch:
    """nthll HyperLogLog sketch on the host: uint8 [2^n_bits] registers,
    max-merge semantics identical to models/hll.HllSketch."""

    def __init__(self, k: int, n_bits: int, stride: int, n_threads: int = 0):
        if stride % 8 or stride < 8:
            raise ValueError(f"stride ({stride}) must be a positive multiple of 8")
        self.k = k
        self.n_bits = n_bits
        self.n_buck = 1 << n_bits
        self.stride = stride
        self.n_threads = n_threads
        self.regs = np.zeros((self.n_buck,), np.uint8)

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        if packed:
            raise ValueError("host engine consumes raw [B, L] code batches")
        native.host_hll_update(
            codes, self.stride, self.k, self.n_bits, self.regs, self.n_threads
        )

    def registers(self) -> np.ndarray:
        return self.regs
