"""Data parallelism over the local devices: one private single-device sketch
per device, folded at the end (the port of ntcard_tpu/parallel/data_parallel.py's
PerDeviceCountTableSketch and PerDeviceHllSketch).

Whole wire batches go to the devices in turn (pipeline.device_feed's
round-robin slots); the JAX package splits each batch's rows into per-device
shards instead. The fold is a sum of tables (and of F1s) and a max of HLL
registers: both commute, so any assignment of batches to devices gives
tables and registers equal bit for bit to one device's.

A device may repeat in the list: the private sketches then share that card
(and its current stream, which every kernel wrapper launches on), which is
how a machine with one card exercises the merge.

Not ported, because each works around the TPU runtime: the shard_map engine
(ShardedCountTableSketch, ShardedHllSketch), data_mesh, sharded_backend /
NTCARD_SHARDED, the per-shard wires (pack_shard_wires) and the superbatch
axis.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ntcard_tpu_torch.models.hll import HllSketch
from ntcard_tpu_torch.models.sketch import CountTableSketch


def _check_devices(devices) -> None:
    if not devices:
        raise ValueError("at least one device is needed")


class PerDeviceCountTableSketch:
    """One private CountTableSketch on each of ``devices``. :meth:`update`
    feeds the sketch of one slot; :meth:`merged` sums every sketch into the
    first device's (tables one at a time) and returns it."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        devices: Sequence[torch.device] = (),
    ):
        _check_devices(devices)
        self._sketches = [
            CountTableSketch(ks, s_bits, r_bits, stride, gap_positions=gap_positions, device=d)
            for d in devices
        ]
        self.devices = [s.device for s in self._sketches]

    def update(self, slot: int, codes: torch.Tensor, packed=False) -> None:
        """Count a batch that lies on ``self.devices[slot]`` into that
        device's sketch."""
        self._sketches[slot].update(codes, packed=packed)

    def merged(self) -> CountTableSketch:
        """Fold every sketch into the first (CountTableSketch.merge_: one
        table crosses at a time, so the first device never holds a second
        full set) and return it; the others are released."""
        head = self._sketches[0]
        for other in self._sketches[1:]:
            head.merge_(other)
        self._sketches = [head]
        return head

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        return self.merged().finalize(return_table=return_table, cov_max=cov_max)


class PerDeviceHllSketch:
    """One private HllSketch on each of ``devices``; :meth:`registers` is
    their elementwise max."""

    def __init__(self, k: int, n_bits: int, stride: int, devices: Sequence[torch.device] = ()):
        _check_devices(devices)
        self._sketches = [HllSketch(k, n_bits, stride, device=d) for d in devices]
        self.devices = [s.device for s in self._sketches]

    def update(self, slot: int, codes: torch.Tensor, packed=False) -> None:
        self._sketches[slot].update(codes, packed=packed)

    def registers(self) -> np.ndarray:
        return np.stack([s.registers() for s in self._sketches]).max(axis=0)
