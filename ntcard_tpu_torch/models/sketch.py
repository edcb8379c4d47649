"""The ntCard sampled count-table sketch on one device (port of
ntcard_tpu/models/sketch.py::CountTableSketch).

State: one int32 table [2 * 2^r + 1] per k on the device and the exact F1
per k as int64 on the device. Entry 2 * 2^r is the JAX layout's dump row:
no kernel here writes it and finalize never reads it (it reads
[:2 * 2^r]); .npz save, load and merge only carry it. A batch step runs K1
(hash, sample, bucket) and then, per k,

* r <= 16: K2 adds every sampled index into the table in place;
* r > 16: K3 compacts the sampled indices into a cap-sized buffer
  (``emit_cap``); K2, gated by "the count fits the cap", adds the buffer
  (it skips the -1 slots), and K2 gated by the overflow flag adds the whole
  emit stream instead. Both flags stay on the device, so the batch
  contributes exactly once either way with no host sync per batch (the JAX
  package drops an overflowed buffer and replays the batch from the host).

Tables wrap mod 2^16 only when finalize reads them (K4), as the reference's
uint16 table does. Not ported, because each works around the TPU runtime:
chains, scatter deferral, the first-batch and finalize fusions, warm and AOT
loading, superbatch stacks, the density guard and the deferred replay.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ntcard_tpu_torch.device import resolve_device
from ntcard_tpu_torch.ops.scatter import compact, counter_hist, hist_add, table_add_
from ntcard_tpu_torch.ops.nthash import codes_T
from ntcard_tpu_torch.ops.sketch_idx import sketch_idx


def emit_cap(n: int) -> int:
    """Compaction slots for an n-window emit stream, as
    ntcard_tpu.models.sketch._emit_cap: 1/64 of the windows (the sampled
    share is ~1.17% at sBits=7), at least 128 and at most 2^20, rounded up
    to a multiple of 128."""
    cap = min(max(n // 64, 128), 1 << 20)
    return (cap + 127) // 128 * 128


class CountTableSketch:
    """Streaming ntcard sketch on one device: :meth:`update` with wire or
    code batches, :meth:`finalize` for the counter-value histograms and the
    exact F1 counts. ``gap_positions`` (spaced seeds, a single k) are the
    masked positions of the seed, as cli.gap_positions makes them.
    ``device=None`` means CUDA and raises without it (device.resolve_device);
    the CPU runs the plain versions of the kernels and must be asked for."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
        device=None,
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
        self.device = resolve_device(device)
        nk = len(self.ks)
        self.tables = [
            torch.zeros(2 * self.r_buck + 1, dtype=torch.int32, device=self.device)
            for _ in range(nk)
        ]
        self.f1 = torch.zeros(nk, dtype=torch.int64, device=self.device)
        self._f1_loaded = [0] * nk  # totals merged in by load / merge_
        # (batch, k) pairs whose compaction overflowed (stats; device-side)
        self._overflows = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def replays(self) -> int:
        """How many (batch, k) updates took the overflow path (host sync)."""
        return int(self._overflows)

    def update(self, codes: torch.Tensor, packed=False) -> None:
        """codes: a [B, L] uint8 code batch, or a wire batch when ``packed``
        (see ntcard_tpu_torch.ops.nthash.codes_T), on the sketch's device."""
        cT = codes_T(codes, packed)  # [L, B]
        idx = sketch_idx(
            cT.T, self.ks, self.stride, self.s_bits, self.r_bits, self.gap_positions
        )
        sent = 2 * self.r_buck
        for t in range(len(self.ks)):
            flat = idx[t].reshape(-1)
            self.f1[t] += (flat != sent + 1).sum()
            if self.r_bits <= 16:
                hist_add(flat, self.r_bits, out=self.tables[t])
            else:
                self._compact_add(self.tables[t], flat, sent)

    def _compact_add(self, table: torch.Tensor, flat: torch.Tensor, sent: int) -> None:
        cap = emit_cap(flat.numel())
        vals, cnt = compact(flat, sent, cap)
        over = (cnt > cap).to(torch.int32).reshape(1)
        # all or nothing: K2 adds the buffer (skipping its -1 slots) unless
        # it overflowed, as JAX's drop-mode scatter of the masked buffer ...
        table_add_(table, vals, sent, gate=1 - over)
        # ... and the same kernel gated by the flag adds the whole stream
        table_add_(table, flat, sent, gate=over)
        self._overflows += over[0]

    def _f1_totals(self):
        return [a + int(b) for a, b in zip(self._f1_loaded, self.f1.tolist())]

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        """-> {k: {"hist": int64 [2, nbins], "f1": int, ["table": uint16
        [2, 2^r]]}} with nbins = min(cov_max + 1, 65536), as
        ntcard_tpu.models.sketch.CountTableSketch.finalize."""
        nbins = min(cov_max + 1, 65536)
        f1s = self._f1_totals()
        out = {}
        for i, k in enumerate(self.ks):
            rows = self.tables[i][: 2 * self.r_buck].view(2, self.r_buck)
            hist = counter_hist(rows, nbins)
            out[k] = {"hist": hist.cpu().numpy().astype(np.int64), "f1": f1s[i]}
            if return_table:
                out[k]["table"] = rows.cpu().numpy().astype(np.uint16)
        return out

    def save(self, path: str) -> None:
        """Checkpoint in ntcard_tpu's .npz sketch format (loadable by
        ntcard_tpu.models.sketch.CountTableSketch.load and the offline
        merge tool, and the other way round)."""
        np.savez_compressed(
            path,
            tables=np.stack([t.cpu().numpy() for t in self.tables]),
            f1s=np.asarray(self._f1_totals(), np.int64),
            ks=np.asarray(self.ks, np.int64),
            s_bits=self.s_bits,
            r_bits=self.r_bits,
            stride=self.stride,
            gap=np.asarray(self.gap_positions or [], np.int64),
        )

    @classmethod
    def load(cls, path: str, device=None) -> "CountTableSketch":
        z = np.load(path)
        gap = tuple(int(x) for x in z["gap"]) or None
        self = cls(
            tuple(int(k) for k in z["ks"]),
            int(z["s_bits"]),
            int(z["r_bits"]),
            int(z["stride"]),
            gap_positions=gap,
            device=device,
        )
        self.tables = [
            torch.from_numpy(np.ascontiguousarray(z["tables"][i], np.int32)).to(self.device)
            for i in range(len(self.ks))
        ]
        self._f1_loaded = [int(v) for v in z["f1s"]]
        return self

    def _check_config(self, other) -> None:
        mine = (self.ks, self.s_bits, self.r_bits, self.stride, self.gap_positions)
        theirs = (other.ks, other.s_bits, other.r_bits, other.stride, other.gap_positions)
        if mine != theirs:
            raise ValueError(f"sketch configs differ; cannot merge ({mine} vs {theirs})")

    def merge_(self, other: "CountTableSketch") -> None:
        """Fold another sketch's counts into this one (sum merge); the hash
        configuration must match. The other sketch may live on another
        device: its tables cross one at a time, so at most one table's copy
        is in flight (none on the same device)."""
        self._check_config(other)
        for t, o in zip(self.tables, other.tables):
            t += o.to(t.device)
        self._f1_loaded = [a + b for a, b in zip(self._f1_loaded, other._f1_totals())]
        self._overflows += other._overflows.to(self.device)

    def merge_host_(self, host) -> None:
        """Fold a models.host_engine.HostCountTableSketch's counts into this
        sketch (the hybrid engine's merge, ntcard_tpu's
        CountTableSketch.merge_host_): its uint16 tables add into the int32
        tables and its F1s into the F1 totals. uint16-wrapped counts summed
        mod 2^16 equal the unwrapped counts mod 2^16, so finalize's wrap
        gives the single-engine histogram exactly."""
        self._check_config(host)
        for t, h in zip(self.tables, host.tables):
            t[: 2 * self.r_buck] += torch.from_numpy(h.astype(np.int32)).to(t.device)
        self._f1_loaded = [a + int(b) for a, b in zip(self._f1_loaded, host.f1s)]
