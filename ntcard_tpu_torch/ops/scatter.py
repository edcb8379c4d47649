"""K2, K3 and K4: the count-table update and the finalize histogram (ports of
the Pallas kernels in ntcard_tpu/ops/scatter_pallas.py).

Each kernel has one wrapper (table_add_, compact, counter_hist): on a CUDA
tensor it launches its hand kernel (csrc/hist_add.cu, compact.cu,
counter_hist.cu) or raises; on a CPU tensor it runs the ``*_plain`` version
beside it. hist_add is hist_add_pallas's r <= 16 contract on top of
table_add_. Emit values at or above
the sentinel, and negative values, are never counted: that is JAX's
contract on its domain ([0, sentinel]) and lets K1's second sentinel S1
pass straight through.
"""

from __future__ import annotations

import torch

from ntcard_tpu_torch import _build

P, I, LL = _build.P, _build.I, _build.LL


def _flat_int32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32:
        raise ValueError(f"expected an int32 tensor, got {x.dtype}")
    x = x.reshape(-1)
    if x.numel() >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 elements, got {x.numel()}")
    return x.contiguous()


def _kept(flat: torch.Tensor, sent: int) -> torch.Tensor:
    return flat[(flat >= 0) & (flat < sent)]


def _check_table(table: torch.Tensor, idx: torch.Tensor, size: int) -> None:
    if (
        table.dtype != torch.int32
        or table.dim() != 1
        or table.numel() < size
        or not table.is_contiguous()
        or table.device != idx.device
    ):
        raise ValueError(
            f"table must be a contiguous int32 [>= {size}] tensor on {idx.device}, got "
            f"{table.dtype}{list(table.shape)} on {table.device}"
        )


# ---- K2: table_add (scatter_pallas.py:125 hist_add_pallas) ----------------


def _check_gate(gate: torch.Tensor, flat: torch.Tensor) -> None:
    if gate.dtype != torch.int32 or gate.numel() != 1 or gate.device != flat.device:
        raise ValueError("gate must be a one-element int32 tensor on the same device")


def table_add_plain(table: torch.Tensor, idx: torch.Tensor, sent: int, gate=None):
    """table[:sent] += bincount(idx in [0, sent)); unchanged when ``gate`` is
    given and 0."""
    flat = _flat_int32(idx)
    _check_table(table, flat, sent)
    h = torch.bincount(_kept(flat, sent), minlength=sent)[:sent].to(torch.int32)
    if gate is not None:
        _check_gate(gate, flat)
        h = h * (gate.reshape(()) != 0)
    table[:sent] += h
    return table


def table_add_(table: torch.Tensor, idx: torch.Tensor, sent: int, gate=None):
    """K2: add every element of ``idx`` (any shape) in [0, sent) into the
    int32 ``table`` in place. With ``gate`` (a one-element int32 device
    flag) the kernel reads the flag first and returns at once when it is 0:
    the exact recovery of a batch whose compaction overflowed, added once
    and with no host sync."""
    if idx.device.type != "cuda":
        return table_add_plain(table, idx, sent, gate)
    flat = _flat_int32(idx)
    _check_table(table, flat, sent)
    if gate is not None:
        _check_gate(gate, flat)
        gate = gate.contiguous()
    fn = _build.fn("hist_add", "ntc_table_add", [P, LL, I, P, P, P])
    with torch.cuda.device(flat.device):
        rc = fn(
            flat.data_ptr(), flat.numel(), sent, table.data_ptr(),
            None if gate is None else gate.data_ptr(), _build.stream_ptr(flat),
        )
        table_add_.launches += 1
    _build.check(rc, "table_add")
    return table


table_add_.launches = 0


def hist_add(idx: torch.Tensor, r_bits: int, out: torch.Tensor | None = None):
    """The table update for r <= 16, hist_add_pallas's contract: counts
    every emit index in [0, 2^(r+1)) of ``idx`` (any shape) into a new int32
    [2^(r+1)+1] table, or into ``out`` in place; the sentinel bin stays 0.
    Raises outside r in [1, 16], as hist_add_pallas does."""
    if not 1 <= r_bits <= 16:
        raise ValueError(f"hist_add requires r_bits in [1, 16], got {r_bits}")
    sent = 2 << r_bits
    if out is None:
        out = torch.zeros(sent + 1, dtype=torch.int32, device=idx.device)
    _check_table(out, idx, sent + 1)
    return table_add_(out, idx, sent)


# ---- K3: compact (scatter_pallas.py:306 compact_pallas, plain mode) --------


def _check_cap(cap: int) -> None:
    if cap <= 0 or cap % 128:
        raise ValueError(f"cap ({cap}) must be a positive multiple of 128")


def compact_plain(idx: torch.Tensor, sent: int, cap: int):
    """(int32[cap] survivors in stream order then -1, int32 true count)."""
    _check_cap(cap)
    kept = _kept(_flat_int32(idx), sent)
    vals = torch.full((cap,), -1, dtype=torch.int32, device=idx.device)
    m = min(kept.numel(), cap)
    vals[:m] = kept[:m]
    return vals, torch.tensor(kept.numel(), dtype=torch.int32, device=idx.device)


# device -> int32 [2] (counter, ticket), 0 between launches. One pair a
# device is enough because every launch on a device goes to that device's
# current stream: several private sketches on one card (parallel/
# data_parallel.py with a repeated device) share that stream rather than
# get one each, so their K3 launches never overlap on the pair.
_COMPACT_SCRATCH: dict = {}


def compact(idx: torch.Tensor, sent: int, cap: int):
    """K3: pack the elements of ``idx`` in [0, sent) into int32[cap]
    (unused slots -1; order is free) and return it with the true count as a
    0-d int32 device tensor. When the count exceeds ``cap`` the buffer is
    invalid and the caller must discard it, as with compact_pallas. One
    launch a call: the kernel fills the unused slots itself and keeps its
    counter in a per-device scratch pair that it leaves at 0 (calls on one
    device must share a stream, as the port's do)."""
    _check_cap(cap)
    if idx.device.type != "cuda":
        return compact_plain(idx, sent, cap)
    flat = _flat_int32(idx)
    vals = torch.empty(cap, dtype=torch.int32, device=flat.device)
    count = torch.empty(1, dtype=torch.int32, device=flat.device)
    scratch = _COMPACT_SCRATCH.get(flat.device)
    if scratch is None:
        scratch = _COMPACT_SCRATCH[flat.device] = torch.zeros(
            2, dtype=torch.int32, device=flat.device)
    fn = _build.fn("compact", "ntc_compact", [P, LL, I, P, I, P, P, P])
    with torch.cuda.device(flat.device):
        rc = fn(
            flat.data_ptr(), flat.numel(), sent, vals.data_ptr(), cap, count.data_ptr(),
            scratch.data_ptr(), _build.stream_ptr(flat),
        )
        compact.launches += 1
    _build.check(rc, "compact")
    return vals, count[0]


compact.launches = 0


# ---- K4: counter_hist (compact_pallas prefilter mode + sketch.py:468-488) --


def _check_rows(rows: torch.Tensor, nbins: int) -> None:
    if not 1 <= nbins <= 65536:
        raise ValueError(f"nbins must be in [1, 65536], got {nbins}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(
            f"rows must be a contiguous int32 [R, n] tensor, got {rows.dtype}{list(rows.shape)}"
        )


def counter_hist_plain(rows: torch.Tensor, nbins: int) -> torch.Tensor:
    """int32 [R, nbins]: per row, how many counters wrap to each value
    v & 0xFFFF < nbins (bin 0 = the wrapped zeros)."""
    _check_rows(rows, nbins)
    return torch.stack(
        [torch.bincount(r & 0xFFFF, minlength=65536)[:nbins] for r in rows]
    ).to(torch.int32)


def counter_hist(rows: torch.Tensor, nbins: int) -> torch.Tensor:
    """K4: the finalize counter histogram of every row of ``rows`` (e.g. a
    table's two sample rows, [2, 2^r]) over bins [0, nbins), exact for every
    nbins in [1, 65536]."""
    _check_rows(rows, nbins)
    if rows.device.type != "cuda":
        return counter_hist_plain(rows, nbins)
    out = torch.zeros((rows.shape[0], nbins), dtype=torch.int32, device=rows.device)
    fn = _build.fn("counter_hist", "ntc_counter_hist", [P, LL, I, I, P, P])
    with torch.cuda.device(rows.device):
        rc = fn(
            rows.data_ptr(), rows.shape[1], rows.shape[0], nbins, out.data_ptr(),
            _build.stream_ptr(rows),
        )
        counter_hist.launches += 1
    _build.check(rc, "counter_hist")
    return out


counter_hist.launches = 0
