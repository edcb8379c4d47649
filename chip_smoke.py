#!/usr/bin/env python3
"""Smoke run of the ntcard_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (each one raises on a failure; the script then exits nonzero and
prints no result):

1. build every hand kernel from ntcard_tpu_torch/csrc with nvcc (and print
   what ptxas says of each: registers, spills), and the port's native
   decode + pack library with g++;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, bit for bit (integer outputs, tolerance 0), and time
   both by their device time (torch.profiler, every device-side event a call
   launches), beside the one PyTorch call that comes nearest to
   the kernel's function where there is one (the port never calls it) and
   beside the kernel's bound: the larger of the bytes it must move over
   3.35 TB/s and the int32 operations these inputs need over the card's
   INT32 peak (SMs x 64 lanes x the maximum SM clock). K1 also with
   spaced-seed masks; K2 also over K3's cap buffer and gated with the flag
   set and unset; K3 also at the edges of its contract (unaligned starts
   and lengths, no survivor, cap, cap + 1, all survivors); K4 at five
   nbins; K5 at k 25, 33 and 64 and two register widths, from zeros, a
   random base and a high floor;
3. run the port CLIs on the card over the reference goldens in
   tests/golden: ntcard (with -g2), nthll, and the offline merge of two
   sketches the port saved;
4. the main paths at full width: a seeded 1,000,000-read FASTQ (150 Mbp,
   30x of a 5 Mbp genome) through the port CLI at -k64,96,128 and the
   default r = 27 (three 1.07 GB tables on the card), at -k64 -r16, and at
   -k64 -g2 (r = 27); each .hist must equal the one the port's native host
   engine (ntcard_tpu_torch.models.host_engine, an independent C++ hash and
   count) writes from the same file; then through the port nthll at -k64,
   whose registers and F0 line must equal the host engine's. Each run
   starts with every launch count at 0, and each kernel of its path must
   have been launched in it;
5. where the time of those runs goes: decode + pack alone against the
   end-to-end wall, device busy time and idle share (torch.profiler), and
   the device step, wire decode and finalize (CUDA events);
6. the scale-out layer on the one card, against phase 4's host-engine
   outputs: the port CLI with two private sketches on the card
   (device=["cuda:0", "cuda:0"], --devices 2) at r = 27 -k64,96,128 and
   nthll -k64, with the merge of two r27 3-k sketches timed alone; two
   processes joined by torch.distributed (gloo for the host route) on the
   two halves of the FASTQ, ntcard -k64 -r16 by the flags and nthll -k64 by
   the environment, where only process 0 writes; the device route of the
   cross-process finalize (reduce-scatter, K4 on the owned slice,
   all-reduce) in a one-rank NCCL group on a full-size r27 3-k sketch
   against its own finalize; and NTCARD_ENGINE=hybrid for ntcard -k64 -r16
   and nthll -k64. Each run starts with every launch count at 0 (a
   process's counts come back on its stderr) and must launch its path's
   kernels.

The last two lines are a {"kernels": [...]} record and the result line
{"ok": true, "device": {...}}. Imports nothing of JAX and nothing of
ntcard_tpu: it fails if either was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
GOLD = REPO / "tests" / "golden"

# main-path shapes: default geometry at kmax = 128 (pipeline.default_geometry)
B, L, KS, S_BITS = 8192, 1024, (64, 96, 128), 7
N_READS = 1_000_000  # reads of the full-size FASTQ (150 bp each)
# spaced-seed masks at k = 64: -g2, and a gap of 12 (cli.gap_positions)
GAP_MASKS = ((31, 32), tuple(range(26, 38)))
K4_NBINS = (1, 65, 1001, 58112, 65536)  # 1001: -c1000, the default

# the card's peaks: HBM3 at 3.35 TB/s, and 64 INT32 lanes an SM at the
# maximum SM clock (set in main from nvidia-smi and the device)
HBM_BYTES_PER_S = 3.35e12
INT32_PER_S = 0.0
# the least int32 operations a window and k needs on 32-bit halves
# (derivation in PERF.md): one rolling step through tables that combine the
# incoming and outgoing base, ntcard's emit, nthll's emit, and the strip of
# one masked position; memory reads and stores are counted as bytes only
OPS_ROLL, OPS_EMIT, OPS_HLL_EMIT, OPS_STRIP = 20, 15, 13, 6
OPS_SCAN = 3  # a table-update or histogram pass: range test, test, add


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of fn() in ms, by CUDA events around ``iters`` back-to-back
    calls: the device's time, or the host's launch overhead where that is
    longer (phase 5's step times)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, min_events: int):
    """(fn()'s result, device seconds: the sum of every device-side event
    of the run, which run one at a time on the one stream) by
    torch.profiler. A trace with fewer than ``min_events`` device events has
    lost some (seen on the card: one kernel of ten calls, or none), so it is
    taken again, at most three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        n, total_us = 0, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None)
                total_us += e.self_cuda_time_total if t is None else t
                n += 1
        if n >= min_events:
            return out, total_us / 1e6
    raise AssertionError(f"torch.profiler kept {n} device events, fewer than {min_events}")


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms: the device-side events (kernels,
    fills, copies) that ``iters`` calls launch, each at least one. Unlike
    CUDA events around back-to-back calls, it does not count the host's
    per-call overhead, which exceeds a short kernel's run."""
    for _ in range(warmup):
        fn()
    return profiled(lambda: [fn() for _ in range(iters)], iters)[1] * 1e3 / iters


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def sig(x: float) -> float:
    """x to six significant digits (a bound of a few bytes stays nonzero)."""
    return float(f"{x:.6g}")


def expect_equal(name: str, a, b) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def random_codes(rng, rows: int, cols: int) -> np.ndarray:
    """[rows, cols] codes: random ACGT, scattered Ns, and record separators
    (an N every 151 bases at a per-row offset), as the packer makes them."""
    codes = rng.integers(0, 4, (rows, cols), dtype=np.uint8)
    codes[rng.random((rows, cols)) < 0.003] = 4
    off = rng.integers(0, 151, rows)
    codes[(np.arange(cols)[None, :] + off[:, None]) % 151 == 0] = 4
    return codes


def bound_ms(nbytes: float, ops: float):
    """(least time in ms the card needs for the work, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sampled_repeat_batch(k: int, stride: int, period: int = 8):
    """One [B, L] batch of a record with a short period whose k-mer passes
    the sample test, so one in ``period`` windows is sampled and the count
    exceeds the compaction cap (the telomeric-repeat shape of
    __graft_entry__._dryrun_production_paths). The unit's k-mer is hashed by
    the port's plain version on the CPU."""
    import torch

    from ntcard_tpu_torch.constants import ASCII_TO_CODE
    from ntcard_tpu_torch.io.packing import pack_records
    from ntcard_tpu_torch.ops.nthash import window_hashes_doubling

    rng = np.random.default_rng(99)
    smask = (1 << (S_BITS - 1)) - 1
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    while True:
        unit = bytes(rng.choice(alphabet, size=period))
        kmer = ASCII_TO_CODE[np.frombuffer(unit * (k // period), np.uint8)]
        h, _ = window_hashes_doubling(torch.from_numpy(kmer)[:, None], (k,), 1)[k]
        hi = (int(h) >> 32) & 0xFFFFFFFF
        if (hi >> (31 - S_BITS)) == 1 or (hi >> (32 - S_BITS)) == smask:
            break
    record = unit * ((B * stride + 2 * L) // period)
    return next(iter(pack_records([record], L, B, max(KS))))


def table_add_library_ms(flat, sent: int) -> float:
    """The fastest of the three PyTorch calls that count an emit stream into
    a table with room for both sentinels (K2's function); prints each."""
    import torch

    idx, ones = flat.long(), torch.ones_like(flat)
    table = torch.zeros(sent + 2, dtype=torch.int32, device=flat.device)
    times = {
        "index_put_ accumulate": device_ms(
            lambda: table.index_put_((idx,), ones, accumulate=True), iters=3, warmup=1),
        "index_add_": device_ms(lambda: table.index_add_(0, idx, ones)),
        "bincount": device_ms(lambda: torch.bincount(flat, minlength=sent + 2)),
    }
    print("  library calls for K2: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return min(times.values())


def compact_edges(dev, sent: int, cap: int) -> None:
    """K3 against its plain version at the edges of its contract, each case
    launched twice (the kernel's scratch counter must be back at 0): lengths
    that are not a multiple of 4, starts 4 and 12 bytes past a 16-byte
    boundary, no survivor, exactly cap, cap + 1, and all survivors (cap of
    them, and a whole batch). The survivors are distinct, so an overflowed
    buffer must hold cap distinct survivors and no -1."""
    import torch

    from ntcard_tpu_torch.ops import scatter as S

    rng = np.random.default_rng(11)
    n = B * L

    def stream(n_surv: int, length: int = n):
        x = np.full(length, sent, np.int32)  # S0: valid, not sampled
        x[rng.random(length) < 0.05] = sent + 1  # S1
        x[rng.choice(length, n_surv, replace=False)] = rng.choice(sent, n_surv, replace=False)
        return torch.from_numpy(x).to(dev)

    main = stream(n // 100)  # about the sampled share of the main path
    every = torch.arange(n, dtype=torch.int32, device=dev)
    cases = {
        "length 4m + 1": main[: n - 3],
        "start 4 bytes past a 16-byte boundary": main[1:],
        "start 12 bytes past, length 4m + 2": main[3: n - 1],
        "three elements at an offset": main[1:4],
        "empty": main[:0],
        "no survivor": stream(0),
        "exactly cap": stream(cap),
        "cap + 1": stream(cap + 1),
        "all survivors, cap of them": every[:cap],
        "all survivors, a whole batch": every,
    }
    for name, x in cases.items():
        pv, pc = S.compact_plain(x, sent, cap)
        for _ in range(2):
            v, c = S.compact(x, sent, cap)
            if int(c) != int(pc):
                raise AssertionError(f"compact ({name}): count {int(c)} vs plain {int(pc)}")
            if int(c) <= cap:
                expect_equal(f"compact ({name})", torch.sort(v).values, torch.sort(pv).values)
            else:
                kept = x[(x >= 0) & (x < sent)]
                if not (bool(torch.isin(v, kept).all()) and torch.unique(v).numel() == cap):
                    raise AssertionError(f"compact ({name}): the overflowed buffer is not "
                                         f"{cap} distinct survivors")
    print(f"  compact edges bit-exact (or cap distinct survivors past the cap), each twice: "
          f"{', '.join(cases)}")


def phase_kernels(dev, seed: int) -> list:
    import torch

    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.models.sketch import CountTableSketch, emit_cap
    from ntcard_tpu_torch.ops import scatter as S
    from ntcard_tpu_torch.ops.hll import hll_update_, hll_update_plain
    from ntcard_tpu_torch.ops.sketch_idx import sketch_idx, sketch_idx_plain

    rng = np.random.default_rng(seed)
    stride = aligned_stride(L, max(KS))
    # the main path hands K1 the position-major [L, B] stream as a [B, L] view
    cT = torch.from_numpy(np.ascontiguousarray(random_codes(rng, B, L).T)).to(dev)
    codes = cT.T
    recs = []

    def rec(name, source, replaces, err, ms, plain_ms, nbytes, ops, library_ms=None):
        bound, by = bound_ms(nbytes, ops)
        recs.append(
            {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": 0, "max_abs_err": err, "ms": sig(ms), "plain_ms": sig(plain_ms),
             "bound_ms": sig(bound), "bound_by": by, "share_of_bound": sig(bound / ms),
             "library_ms": None if library_ms is None else sig(library_ms)}
        )
        lib = "no single call" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {name}: max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bound:.6g} ms ({by}), {100 * bound / ms:.2f}% of it")

    def table_bytes(flat, sent):
        """The emit stream read once, and each table entry it adds to read
        and written once."""
        kept = flat[(flat >= 0) & (flat < sent)]
        return 4 * flat.numel() + 8 * torch.unique(kept).numel()

    # K1 at r = 27 and r = 16
    idx = {}
    for r in (27, 16):
        got = sketch_idx(codes, KS, stride, S_BITS, r)
        want = sketch_idx_plain(codes, KS, stride, S_BITS, r)
        err = expect_equal(f"sketch_idx r{r}", got, want)
        idx[r] = got
        print(f"  sketch_idx r{r}: bit-exact over {got.numel()} emit indices")
    windows = B * stride  # owned window starts a k; the rest of a row is S1
    rec("sketch_idx", "ntcard_tpu_torch/csrc/sketch_idx.cu",
        "ntcard_tpu/ops/nthash_pallas.py:215", err,
        device_ms(lambda: sketch_idx(codes, KS, stride, S_BITS, 27)),
        device_ms(lambda: sketch_idx_plain(codes, KS, stride, S_BITS, 27), iters=3, warmup=1),
        B * L + 4 * len(KS) * B * L, len(KS) * windows * (OPS_ROLL + OPS_EMIT))
    # K1 with spaced seeds (a single k): the -g2 seed of k64, the main
    # path's gap run, and a 12-gap
    for mask in GAP_MASKS:
        for r in (27, 16):
            err = expect_equal(f"sketch_idx k64 mask {mask} r{r}",
                               sketch_idx(codes, (64,), stride, S_BITS, r, mask),
                               sketch_idx_plain(codes, (64,), stride, S_BITS, r, mask))
        ms = device_ms(lambda: sketch_idx(codes, (64,), stride, S_BITS, 27, mask))
        plain_ms = device_ms(lambda: sketch_idx_plain(codes, (64,), stride, S_BITS, 27, mask),
                           iters=3, warmup=1)
        unmasked_ms = device_ms(lambda: sketch_idx(codes, (64,), stride, S_BITS, 27))
        print(f"  sketch_idx k64 mask of {len(mask)} at r27 and r16: bit-exact; r27 kernel "
              f"{ms:.4f} ms (unmasked k64 {unmasked_ms:.4f} ms), plain {plain_ms:.4f} ms")
        if mask == GAP_MASKS[0]:
            rec("sketch_idx_masked", "ntcard_tpu_torch/csrc/sketch_idx.cu",
                "ntcard_tpu/ops/nthash.py:371", err, ms, plain_ms, B * L + 4 * B * L,
                windows * (OPS_ROLL + OPS_EMIT + OPS_STRIP * len(mask)))

    # K2 at r = 16 on K1's k=64 emit stream
    flat16 = idx[16][0].reshape(-1)
    zeros16 = torch.zeros((2 << 16) + 1, dtype=torch.int32, device=dev)
    err = expect_equal("table_add r16", S.hist_add(flat16, 16),
                       S.table_add_plain(zeros16.clone(), flat16, 2 << 16))
    rec("table_add", "ntcard_tpu_torch/csrc/hist_add.cu",
        "ntcard_tpu/ops/scatter_pallas.py:125", err,
        device_ms(lambda: S.table_add_(zeros16, flat16, 2 << 16)),
        device_ms(lambda: S.table_add_plain(zeros16, flat16, 2 << 16)),
        table_bytes(flat16, 2 << 16), OPS_SCAN * flat16.numel(),
        table_add_library_ms(flat16, 2 << 16))

    # K3 at r = 27 on K1's k=64 emit stream, at the JAX cap
    sent = 2 << 27
    flat27 = idx[27][0].reshape(-1)
    cap = emit_cap(flat27.numel())
    (v, c), (pv, pc) = S.compact(flat27, sent, cap), S.compact_plain(flat27, sent, cap)
    if int(c) != int(pc) or int(c) > cap:
        raise AssertionError(f"compact: count {int(c)} vs plain {int(pc)} (cap {cap})")
    err = expect_equal("compact", torch.sort(v).values, torch.sort(pv).values)
    print(f"  compact: {int(c)} survivors of {flat27.numel()} at cap {cap}")
    rec("compact", "ntcard_tpu_torch/csrc/compact.cu",
        "ntcard_tpu/ops/scatter_pallas.py:306", err,
        device_ms(lambda: S.compact(flat27, sent, cap)),
        device_ms(lambda: S.compact_plain(flat27, sent, cap)),
        4 * flat27.numel() + 4 * cap + 4, OPS_SCAN * flat27.numel(),
        device_ms(lambda: flat27[(flat27 >= 0) & (flat27 < sent)]))
    compact_edges(dev, sent, cap)
    # K2 over K3's cap buffer, gated by "the count fits": the r > 16 path's
    # table update (models/sketch._compact_add)
    fits = (c <= cap).to(torch.int32).reshape(1)
    table = torch.zeros(sent + 1, dtype=torch.int32, device=dev)
    err = expect_equal("table_add over the cap buffer",
                       S.table_add_(table.clone(), v, sent, gate=fits),
                       S.table_add_plain(table.clone(), v, sent, gate=fits))
    vlong, vones = v.long(), torch.ones_like(v)
    rec("table_add_buffer", "ntcard_tpu_torch/csrc/hist_add.cu",
        "ntcard_tpu/ops/scatter_pallas.py:125", err,
        device_ms(lambda: S.table_add_(table, v, sent, gate=fits)),
        device_ms(lambda: S.table_add_plain(table, v, sent, gate=fits)),
        table_bytes(v, sent) + 4, OPS_SCAN * v.numel(),
        # JAX's own drop-mode scatter of the buffer: the -1 slots wrap to the
        # dump entry, as index_put_ wraps a negative index
        device_ms(lambda: table.index_put_((vlong,), vones, accumulate=True), iters=3, warmup=1))
    # the same kernel gated by the overflow flag, unset: the stream add that
    # the main path launches after every K3 and that returns at once
    unset = torch.zeros(1, dtype=torch.int32, device=dev)
    err = expect_equal("table_add gated, flag unset",
                       S.table_add_(table.clone(), flat27, sent, gate=unset),
                       S.table_add_plain(table.clone(), flat27, sent, gate=unset))
    rec("table_add_gated_unset", "ntcard_tpu_torch/csrc/hist_add.cu",
        "ntcard_tpu/ops/scatter_pallas.py:125", err,
        device_ms(lambda: S.table_add_(table, flat27, sent, gate=unset)),
        device_ms(lambda: S.table_add_plain(table, flat27, sent, gate=unset)),
        4, 1)  # the flag read and its test
    del table, vlong, vones
    # forced overflow: counts agree past the cap, and the sketch's gated
    # full-stream add makes the table exact
    over_codes = torch.from_numpy(sampled_repeat_batch(64, stride)).to(dev)
    oidx = sketch_idx(over_codes, (64,), stride, S_BITS, 27)[0].reshape(-1)
    (_, oc), (_, opc) = S.compact(oidx, sent, cap), S.compact_plain(oidx, sent, cap)
    if int(oc) != int(opc) or int(oc) <= cap:
        raise AssertionError(f"forced overflow: count {int(oc)} vs plain {int(opc)} (cap {cap})")
    sk = CountTableSketch((64,), S_BITS, 27, stride, device=dev)
    sk.update(over_codes)
    ref = torch.bincount(oidx[(oidx >= 0) & (oidx < sent)], minlength=sent)[:sent]
    expect_equal("overflow update", sk.tables[0][:sent], ref)
    if sk.replays != 1:
        raise AssertionError(f"forced overflow: {sk.replays} overflowed updates, expected 1")
    print(f"  forced overflow: count {int(oc)} > cap {cap}, table exact after the gated add")
    del sk, ref
    # K2 gated by a set overflow flag, on the forced-overflow stream
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    table = torch.zeros(sent + 1, dtype=torch.int32, device=dev)
    err = expect_equal(
        "table_add gated",
        S.table_add_(table.clone(), oidx, sent, gate=flag),
        S.table_add_plain(table.clone(), oidx, sent, gate=flag),
    )
    rec("table_add_gated", "ntcard_tpu_torch/csrc/hist_add.cu",
        "ntcard_tpu/ops/scatter_pallas.py:125", err,
        device_ms(lambda: S.table_add_(table, oidx, sent, gate=flag)),
        device_ms(lambda: S.table_add_plain(table, oidx, sent, gate=flag)),
        table_bytes(oidx, sent) + 4, OPS_SCAN * oidx.numel(),
        table_add_library_ms(oidx, sent))
    del table

    # K4 on an r = 27 table: mostly zero counters, some past the uint16 wrap
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.zeros((2, 1 << 27), dtype=torch.int32, device=dev)
    hit = torch.rand(rows.shape, generator=gen, device=dev) < 0.02
    vals = torch.randint(1, 1 << 18, rows.shape, generator=gen, device=dev, dtype=torch.int32)
    small = torch.randint(1, 64, rows.shape, generator=gen, device=dev, dtype=torch.int32)
    rows = torch.where(hit, torch.where(vals < (1 << 17), small, vals), rows)
    del hit, vals, small
    lib_ms = device_ms(lambda: [torch.bincount(r & 0xFFFF, minlength=65536) for r in rows],
                     iters=3, warmup=1)
    for nbins in K4_NBINS:
        err = expect_equal(
            f"counter_hist nbins={nbins}",
            S.counter_hist(rows, nbins),
            S.counter_hist_plain(rows, nbins),
        )
        ms = device_ms(lambda: S.counter_hist(rows, nbins))
        plain_ms = device_ms(lambda: S.counter_hist_plain(rows, nbins), iters=3, warmup=1)
        nbytes = 4 * rows.numel() + 4 * rows.shape[0] * nbins
        bound = bound_ms(nbytes, OPS_SCAN * rows.numel())[0]
        print(f"  counter_hist nbins={nbins}: bit-exact; kernel {ms:.4f} ms "
              f"({100 * bound / ms:.1f}% of its bound), plain {plain_ms:.4f} ms")
        if nbins == 1001:  # -c1000, the default
            rec("counter_hist", "ntcard_tpu_torch/csrc/counter_hist.cu",
                "ntcard_tpu/ops/scatter_pallas.py:306", err, ms, plain_ms,
                nbytes, OPS_SCAN * rows.numel(), lib_ms)
    del rows

    # K5 on the same batch at k 64 (nthll's default), 25 and 33 (not
    # multiples of the 32-base sub-block), b16 and b10: from zeros, from a
    # nonzero base, from a base whose floor is high but that some windows
    # still beat, and repeated on one array
    for k in (25, 33):
        hs = aligned_stride(L, k)
        for n_bits in (16, 10):
            zeros = torch.zeros(1 << n_bits, dtype=torch.int32, device=dev)
            expect_equal(f"hll_update k{k} b{n_bits}",
                         hll_update_(zeros.clone(), codes, k, hs, n_bits),
                         hll_update_plain(zeros.clone(), codes, k, hs, n_bits))
    hstride = aligned_stride(L, 64)
    for n_bits in (16, 10):
        zeros = torch.zeros(1 << n_bits, dtype=torch.int32, device=dev)
        err = expect_equal(f"hll_update b{n_bits}",
                           hll_update_(zeros.clone(), codes, 64, hstride, n_bits),
                           hll_update_plain(zeros.clone(), codes, 64, hstride, n_bits))
        base = torch.randint(0, 8, zeros.shape, generator=gen, device=dev, dtype=torch.int32)
        expect_equal(f"hll_update b{n_bits} from a nonzero base",
                     hll_update_(base.clone(), codes, 64, hstride, n_bits),
                     hll_update_plain(base.clone(), codes, 64, hstride, n_bits))
        high = torch.randint(9, 12, zeros.shape, generator=gen, device=dev, dtype=torch.int32)
        got = hll_update_(high.clone(), codes, 64, hstride, n_bits)
        expect_equal(f"hll_update b{n_bits} from a floor of 9", got,
                     hll_update_plain(high.clone(), codes, 64, hstride, n_bits))
        if torch.equal(got, high):
            raise AssertionError(f"hll_update b{n_bits}: no window beat a register above 9")
        # from zeros (the first batch of a run), then repeated launches on
        # one register array: after the first, the floor and the reads
        # settle nearly every window, as on a long input
        first_ms = (device_ms(lambda: hll_update_(zeros.zero_(), codes, 64, hstride, n_bits))
                    - device_ms(lambda: zeros.zero_()))
        ms = device_ms(lambda: hll_update_(zeros, codes, 64, hstride, n_bits))
        plain_ms = device_ms(lambda: hll_update_plain(zeros, codes, 64, hstride, n_bits),
                           iters=3, warmup=1)
        print(f"  hll_update k64 b{n_bits}: bit-exact; kernel {ms:.4f} ms repeated "
              f"(from zeros {first_ms:.4f} ms), plain {plain_ms:.4f} ms")
        if n_bits == 16:  # nthll's default register width
            rec("hll_update", "ntcard_tpu_torch/csrc/hll_update.cu",
                "ntcard_tpu/models/hll.py:27", err, ms, plain_ms,
                B * L + 2 * 4 * zeros.numel(), B * hstride * (OPS_ROLL + OPS_HLL_EMIT))
    torch.cuda.empty_cache()
    return recs


def run_cli(argv, device, capture_stderr=False):
    from ntcard_tpu_torch.cli import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err) if capture_stderr else contextlib.nullcontext():
        rc = main([str(a) for a in argv], device=device)
    if rc != 0:
        raise AssertionError(f"port CLI {argv} returned {rc}")
    return err.getvalue()


def run_nthll(argv, device) -> str:
    """The port nthll's standard output."""
    from ntcard_tpu_torch.cli_hll import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv], device=device)
    if rc != 0:
        raise AssertionError(f"port nthll {argv} returned {rc}")
    return out.getvalue()


def cli_metrics(stderr: str) -> dict:
    """The JSON object that a --metrics run writes to stderr."""
    for line in stderr.splitlines():
        if line.startswith("{") and '"phases_sec"' in line:
            return json.loads(line)
    raise AssertionError("no --metrics record on the CLI's stderr")


def phase_goldens(tmp: Path) -> None:
    def same(out, good):
        if (tmp / out).read_bytes() != (GOLD / good).read_bytes():
            raise AssertionError(f"{out} differs from tests/golden/{good}")

    run_cli(["-k12", "-c1000", "-r16", "-p", tmp / "a", DATA / "reads.fq"], "cuda")
    same("a_k12.hist", "reads_k12.hist.good")
    run_cli(["-k12", "-c1000", "-p", tmp / "d", DATA / "reads.fq"], "cuda")
    same("d_k12.hist", "reads_r27_k12.hist.good")
    run_cli(["-k32,64,96", "-c64", "-r16", "-p", tmp / "m", DATA / "reads.fq"], "cuda")
    for k in (32, 64, 96):
        same(f"m_k{k}.hist", f"reads_k{k}.hist.good")
    run_cli(["-k25,96", "-c64", "-r16", "-p", tmp / "c", DATA / "contig.fa"], "cuda")
    same("c_k25.hist", "contig_k25.hist.good")
    same("c_k96.hist", "contig_k96.hist.good")
    run_cli(["-k12", "-c1000", "-r16", "-p", tmp / "b", DATA / "reads.fq", DATA / "contig.fa"],
            "cuda")
    same("b_k12.hist", "both_k12.hist.good")
    err = run_cli(["-k12,32", "-c64", "-r16", "-o", tmp / "o.tsv", DATA / "reads.fq"], "cuda",
                  capture_stderr=True)
    same("o.tsv", "reads_compact.tsv.good")
    klines = "".join(line + "\n" for line in err.splitlines() if line.startswith("k="))
    if klines != (GOLD / "reads_compact.stderr.good").read_text():
        raise AssertionError("compact stderr differs from tests/golden/reads_compact.stderr.good")
    run_cli(["-k12", "-c1000", "-r16", "-g2", "-p", tmp / "g", DATA / "reads.fq"], "cuda")
    same("g_k12.hist", "reads-gap_k12.hist.good")
    for flags, good in ((["-k25"], "nthll_k25.out.good"),
                        (["-k25", "-b10"], "nthll_k25_b10.out.good")):
        if run_nthll([*flags, DATA / "reads.fq"], "cuda") != (GOLD / good).read_text():
            raise AssertionError(f"nthll {' '.join(flags)} differs from tests/golden/{good}")
    sketches = []
    for name, src in (("s1", "reads.fq"), ("s2", "contig.fa")):
        sketches.append(tmp / f"{name}.npz")
        run_cli(["-k12", "-c1000", "-r16", "--save-sketch", sketches[-1], "-p", tmp / name,
                 DATA / src], "cuda")
    from ntcard_tpu_torch.tools.merge_sketches import main as merge_main

    if merge_main(["-p", str(tmp / "mg"), "-c", "1000", *map(str, sketches)], device="cuda") != 0:
        raise AssertionError("the port merge tool failed")
    same("mg_k12.hist", "both_k12.hist.good")
    print("  14 golden files byte-equal (reads k12 r16 and r27, k32/64/96, contig k25/k96, "
          "both k12, compact TSV + stderr, gap k12, nthll k25 and k25 -b10, both k12 by the "
          "merge tool)")


def write_fastq(path: Path, seed: int, genome_len=5_000_000, n_reads=N_READS,
                read_len=150, sub_rate=0.005, n_read_frac=0.01) -> None:
    """Seeded reads of a random genome: both strands, substitutions at
    ``sub_rate``, and a run of 1-10 Ns in ``n_read_frac`` of the reads."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    letters = np.frombuffer(b"ACGT", np.uint8)
    cols = np.arange(read_len)
    with open(path, "wb") as f:
        for lo in range(0, n_reads, 100_000):
            n = min(100_000, n_reads - lo)
            starts = rng.integers(0, genome_len - read_len + 1, n)
            reads = genome[starts[:, None] + cols]
            rc = rng.random(n) < 0.5
            reads[rc] = 3 - reads[rc, ::-1]
            sub = rng.random((n, read_len)) < sub_rate
            reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
            seq = letters[reads]
            nrun = rng.random(n) < n_read_frac
            s0 = rng.integers(0, read_len, n)[:, None]
            ln = rng.integers(1, 11, n)[:, None]
            seq[nrun[:, None] & (cols >= s0) & (cols < s0 + ln)] = ord("N")
            ids = lo + np.arange(n)
            digits = (ids[:, None] // 10 ** np.arange(6, -1, -1)) % 10 + ord("0")
            rec = np.concatenate(
                [
                    np.broadcast_to(np.frombuffer(b"@r", np.uint8), (n, 2)),
                    digits.astype(np.uint8),
                    np.full((n, 1), ord("\n"), np.uint8),
                    seq,
                    np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3)),
                    np.full((n, read_len), ord("I"), np.uint8),
                    np.full((n, 1), ord("\n"), np.uint8),
                ],
                axis=1,
            )
            f.write(rec.tobytes())


# the full-size ntcard runs: (tag, CLI flags, ks); phase 5 breaks down the
# first two
RUNS = [("r27", ["-k64,96,128", "-c1000"], (64, 96, 128)), ("r16", ["-k64", "-r16"], (64,))]
GAP_RUN = ("gap", ["-k64", "-g2", "-c1000"], (64,))
BREAKDOWN_REPS = 3  # decode-alone / wall pairs per run; the median is read
HLL_K, HLL_BITS = 64, 16  # the full-size nthll run: nthll's defaults

# the kernels each full-size path must launch (phase 6: md_ two private
# sketches on the card, mh_ two processes, route the device route of the
# cross-process finalize, hy_ the hybrid engine)
PATH_KERNELS = {
    "r27": ("sketch_idx", "compact", "table_add", "counter_hist"),
    "r16": ("sketch_idx", "table_add", "counter_hist"),
    "gap": ("sketch_idx", "compact", "table_add", "counter_hist"),
    "nthll": ("hll_update",),
    "md_r27": ("sketch_idx", "compact", "table_add", "counter_hist"),
    "md_nthll": ("hll_update",),
    "mh_r16": ("sketch_idx", "table_add", "counter_hist"),
    "mh_nthll": ("hll_update",),
    "route": ("counter_hist",),
    "hy_r16": ("sketch_idx", "table_add", "counter_hist"),
    "hy_nthll": ("hll_update",),
}
R27_RUNS = ("r27", "gap", "md_r27")  # the r > 16 runs: two K2 launches a K3
PHASE6_RUNS = ("md_r27", "md_nthll", "mh_r16", "mh_nthll", "route", "hy_r16", "hy_nthll")
# each kernel record's launches: (wrapper, the runs that count, divisor).
# K1 unmasked and masked; K2 ungated (r16) and, on the r > 16 runs, two
# launches after every K3 (models/sketch._compact_add; phase_full checks
# the count): one over the cap buffer and one gated over the stream, whose
# flag the set-flag and unset-flag records share
RECORD_RUNS = {
    "sketch_idx": ("sketch_idx", ("r27", "r16", "md_r27", "mh_r16", "hy_r16"), 1),
    "sketch_idx_masked": ("sketch_idx", ("gap",), 1),
    "table_add": ("table_add", ("r16", "mh_r16", "hy_r16"), 1),
    "table_add_buffer": ("table_add", R27_RUNS, 2),
    "table_add_gated": ("table_add", R27_RUNS, 2),
    "table_add_gated_unset": ("table_add", R27_RUNS, 2),
    "compact": ("compact", R27_RUNS, 1),
    "counter_hist": ("counter_hist", ("r27", "r16", "gap", "md_r27", "mh_r16", "route", "hy_r16"), 1),
    "hll_update": ("hll_update", ("nthll", "md_nthll", "mh_nthll", "hy_nthll"), 1),
}


def wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches."""
    from ntcard_tpu_torch.ops import scatter as S
    from ntcard_tpu_torch.ops.hll import hll_update_
    from ntcard_tpu_torch.ops.sketch_idx import sketch_idx

    return {"sketch_idx": sketch_idx, "table_add": S.table_add_, "compact": S.compact,
            "counter_hist": S.counter_hist, "hll_update": hll_update_}


class Runs:
    """The main-path runs: each one's wall and kernel launches, with every
    count set to 0 just before it and read just after."""

    def __init__(self):
        self.walls, self.launches = {}, {}

    def drive(self, tag, fn):
        """fn() in this process; the kernels of its path must have been
        launched."""
        import torch

        for w in wrappers().values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        self.walls[tag] = time.monotonic() - t0
        self.record(tag, {name: w.launches for name, w in wrappers().items()})
        return out

    def record(self, tag, launches: dict):
        self.launches[tag] = launches
        for name in PATH_KERNELS[tag]:
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {tag} path")


def host_batches(fq: Path, kmax: int, n_threads: int, **kw):
    """The raw [B, L] code batches of ``fq`` at the default geometry, decoded
    on background threads, as the host engine consumes them."""
    from ntcard_tpu_torch.pipeline import default_geometry, parallel_batches_from_files, prefetch

    chunk_len, batch_rows = default_geometry(kmax)
    return prefetch(parallel_batches_from_files(
        [str(fq)], chunk_len, batch_rows, kmax, n_threads, **kw))


def host_ntcard(flags, prefix: Path, fq: Path) -> None:
    """The reference .hist files of one ntcard run: the port's parser, batch
    stream, native host engine and writers, with no device."""
    from ntcard_tpu_torch.cli import estimate_and_write, gap_positions, parse_args
    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.models.host_engine import HostCountTableSketch
    from ntcard_tpu_torch.pipeline import default_geometry
    from ntcard_tpu_torch.utils.metrics import Metrics

    opt, _ = parse_args([*flags, "-p", str(prefix), str(fq)])
    opt.s_bits = 7  # the <50 GB rule the port CLI applied
    kmax = max(opt.k_list)
    stride = aligned_stride(default_geometry(kmax)[0], kmax)
    sketch = HostCountTableSketch(opt.k_list, opt.s_bits, opt.r_bits, stride,
                                  gap_positions=gap_positions(opt))
    stats: dict = {}
    for batch in host_batches(fq, kmax, 1, stats_out=stats):
        sketch.update(batch)
    with contextlib.redirect_stderr(io.StringIO()):
        estimate_and_write(opt, sketch.finalize(cov_max=opt.cov_max), Metrics(False), stats,
                           sketch, time.monotonic())


def host_hll_registers(fq: Path) -> np.ndarray:
    """nthll's registers of ``fq`` by the port's native host engine, over the
    batch stream nthll reads (lenient sniffing, unreadable files skipped)."""
    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.models.host_engine import HostHllSketch
    from ntcard_tpu_torch.pipeline import default_geometry

    sketch = HostHllSketch(HLL_K, HLL_BITS, aligned_stride(default_geometry(HLL_K)[0], HLL_K))
    for batch in host_batches(fq, HLL_K, 1, lenient=True, on_error="skip"):
        sketch.update(batch)
    return sketch.registers()


def phase_full(fq: Path, tmp: Path, dev, runs: Runs):
    """The four full-size runs, into ``runs``; returns the host engine's
    nthll registers and F0 line."""
    from ntcard_tpu_torch.cli_hll import device_registers
    from ntcard_tpu_torch.models.estimate import estimate_f0

    metrics = {}
    ntcard_runs = [*RUNS, GAP_RUN]
    for tag, flags, _ in ntcard_runs:
        err = runs.drive(tag, lambda: run_cli([*flags, "--metrics", "-p", tmp / f"gpu_{tag}", fq],
                                              dev.type, capture_stderr=True))
        metrics[tag] = cli_metrics(err)
    f0_line = runs.drive("nthll", lambda: run_nthll([f"-k{HLL_K}", fq], dev.type))
    walls, per_run = runs.walls, runs.launches
    for tag, flags, _ in ntcard_runs:
        print(f"  {tag} {' '.join(flags)}: wall {walls[tag]:.3f} s, "
              f"{N_READS / walls[tag]:.0f} reads/s; CLI phases (s) {metrics[tag]['phases_sec']}")
    print(f"  nthll -k{HLL_K}: wall {walls['nthll']:.3f} s, {N_READS / walls['nthll']:.0f} reads/s")
    print(f"  launches in each main-path run: {json.dumps(per_run)}")
    for tag in ("r27", "gap"):
        check_k2_per_k3(tag, per_run[tag])
        print(f"  table_add ({tag}): {per_run[tag]['compact']} over the cap buffer and "
              f"{per_run[tag]['compact']} gated over the stream, of which "
              f"{int(metrics[tag]['counters']['overflow_replays'])} found the flag set and added "
              "the full stream")
    print(f"  table_add (r16): {per_run['r16']['table_add']} ungated adds")
    for tag, flags, ks in ntcard_runs:
        host_ntcard(flags, tmp / f"host_{tag}", fq)
        same_hist(tmp / f"gpu_{tag}", tmp / f"host_{tag}", ks)
    print("  every .hist byte-equal to the native host engine's")
    want = host_hll_registers(fq)
    check_registers("nthll", device_registers([str(fq)], HLL_K, HLL_BITS, 1, [dev]), want)
    host_line = f"F0, Exp# of distnt kmers(k={HLL_K}): {estimate_f0(want, canon=True)}\n"
    if f0_line != host_line:
        raise AssertionError(f"nthll F0 line {f0_line!r} vs host engine {host_line!r}")
    print(f"  nthll registers equal to the host engine's ({want.size}, max {int(want.max())}); "
          f"{f0_line.strip()}")
    return want, host_line


def check_k2_per_k3(tag: str, launches: dict) -> None:
    """In an r > 16 run every K3 launch is followed by two K2 launches: over
    the cap buffer (gated by "the count fits") and over the stream (gated by
    the overflow flag, set only for a batch that overflowed)."""
    if launches["table_add"] != 2 * launches["compact"]:
        raise AssertionError(f"{tag}: {launches['table_add']} K2 launches for "
                             f"{launches['compact']} K3")


def same_hist(prefix: Path, ref_prefix: Path, ks) -> None:
    for k in ks:
        got, want = Path(f"{prefix}_k{k}.hist"), Path(f"{ref_prefix}_k{k}.hist")
        if got.read_bytes() != want.read_bytes():
            raise AssertionError(f"{got.name} differs from the host engine's {want.name}")


def check_registers(tag: str, got, want) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{tag}: registers differ from the host engine's in "
                             f"{int((got != want).sum())} of {want.size}")


def phase_breakdown(fq: Path, tmp: Path, dev) -> None:
    """Where the full-size runs' time goes. Per run: decode + pack alone (the
    CLI's own batch stream with no device), interleaved with end-to-end
    walls; device busy time in one profiled run and the idle share against
    the median wall; the device step of one batch, its wire decode, and
    finalize, by CUDA events."""
    import torch

    from ntcard_tpu_torch.cli import parse_args, wire_batches
    from ntcard_tpu_torch.io.packing import wire_mode_of
    from ntcard_tpu_torch.io.readers import expand_file_args
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.ops.nthash import codes_T

    for tag, flags, _ in RUNS:
        opt, args = parse_args([*flags, "-p", str(tmp / f"b_{tag}"), str(fq)])
        opt.s_bits = 7  # the <50 GB rule the port CLI applies
        files = expand_file_args(args)
        decode, walls = [], []
        for _ in range(BREAKDOWN_REPS):
            t0 = time.monotonic()
            n_batches = sum(1 for _ in wire_batches(opt, files, {})[0])
            decode.append(time.monotonic() - t0)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run_cli([*flags, "-p", tmp / f"b_{tag}", fq], dev.type)
            walls.append(time.monotonic() - t0)

        def profiled_run():
            t0 = time.monotonic()
            run_cli([*flags, "-p", tmp / f"b_{tag}", fq], dev.type)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        prof_wall, busy = profiled(profiled_run, n_batches)  # K1 at least, every batch

        batches, stride, use_quad, halo = wire_batches(opt, files, {})
        wire = torch.from_numpy(next(iter(batches))).to(dev)
        packed = wire_mode_of(wire, opt.batch_rows, halo) if use_quad else True
        sk = CountTableSketch(opt.k_list, opt.s_bits, opt.r_bits, stride, device=dev)
        step_ms = cuda_ms(lambda: sk.update(wire, packed=packed))
        unpack_ms = cuda_ms(lambda: codes_T(wire, packed))
        fin_ms = cuda_ms(lambda: sk.finalize(cov_max=opt.cov_max), iters=3, warmup=1)
        del sk
        wall_med = sorted(walls)[BREAKDOWN_REPS // 2]
        rec = {
            "batches": n_batches,
            "decode_only_s": decode, "wall_s": walls, "profiled_wall_s": prof_wall,
            "device_busy_s": busy, "idle_share_of_median_wall": 1 - busy / wall_med,
            "decode_share_of_median_wall": sorted(decode)[BREAKDOWN_REPS // 2] / wall_med,
            "step_ms": step_ms, "unpack_ms": unpack_ms, "finalize_ms": fin_ms,
        }
        print(f"  {tag} breakdown: {json.dumps(rec)}")
    torch.cuda.empty_cache()


# a process of a two-process run: the port CLI ("ntcard" or "nthll") on
# the card, its launch counts on the last line of its stderr
CHILD = """
import json, sys
from ntcard_tpu_torch import cli, cli_hll
from ntcard_tpu_torch.ops import scatter as S
from ntcard_tpu_torch.ops.hll import hll_update_
from ntcard_tpu_torch.ops.sketch_idx import sketch_idx
rc = (cli if sys.argv[1] == "ntcard" else cli_hll).main(sys.argv[2:], device="cuda")
w = {"sketch_idx": sketch_idx, "table_add": S.table_add_, "compact": S.compact,
     "counter_hist": S.counter_hist, "hll_update": hll_update_}
print("LAUNCHES " + json.dumps({n: f.launches for n, f in w.items()}), file=sys.stderr)
sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def env_set(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def two_processes(runs: Runs, tag: str, prog: str, argv_of, env_of) -> list:
    """``prog`` as processes 0 and 1 of one run on the card, each with its
    own arguments and environment; records the run's wall (both processes,
    start to exit) and the sum of their launches; returns their (stdout,
    stderr)."""
    t0 = time.monotonic()
    procs = [
        subprocess.Popen([sys.executable, "-c", CHILD, prog, *argv_of(pid)], cwd=str(REPO),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env={**os.environ, **env_of(pid)})
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    runs.walls[tag] = time.monotonic() - t0
    total = dict.fromkeys(wrappers(), 0)
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: process {pid} exited {p.returncode}: {err[-3000:]}")
        line = next(ln for ln in err.splitlines() if ln.startswith("LAUNCHES "))
        counts = json.loads(line.split(" ", 1)[1])
        for name in total:
            total[name] += counts[name]
    runs.record(tag, total)
    return outs


def split_fastq(fq: Path, tmp: Path) -> list:
    """The FASTQ cut into two files by reads (write_fastq's records are all
    one length)."""
    data = fq.read_bytes()
    rec = 0
    for _ in range(4):
        rec = data.index(b"\n", rec) + 1
    if len(data) % rec:
        raise AssertionError("the FASTQ's records are not all one length")
    cut = len(data) // rec // 2 * rec
    halves = [tmp / "reads_a.fq", tmp / "reads_b.fq"]
    halves[0].write_bytes(data[:cut])
    halves[1].write_bytes(data[cut:])
    return halves


def merge_time(dev, seed: int) -> float:
    """Seconds the fold of two private r27 3-k sketches on the card takes
    (three 1.07 GB tables summed in place, one at a time), checked against
    the sum taken beforehand."""
    import torch

    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.parallel.data_parallel import PerDeviceCountTableSketch

    sk = PerDeviceCountTableSketch(KS, S_BITS, 27, aligned_stride(L, max(KS)), devices=[dev, dev])
    gen = torch.Generator(device=dev).manual_seed(seed)
    for part in sk._sketches:
        for t in part.tables:
            t.random_(0, 1 << 12, generator=gen)
    head, other = sk._sketches
    want = [a + b for a, b in zip(head.tables, other.tables)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    merged = sk.merged()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    for i, (got, w) in enumerate(zip(merged.tables, want)):
        expect_equal(f"merged table {i}", got, w)
    del sk, merged, head, other, want
    torch.cuda.empty_cache()
    return dt


def device_route(fq: Path, dev, runs: Runs) -> None:
    """The device route of the cross-process finalize (reduce-scatter over
    NCCL, K4 on the owned slice, all-reduce) in a one-rank group on a
    full-size r27 3-k sketch, against that sketch's own finalize. A group
    of two ranks needs two cards (NCCL refuses two ranks on one)."""
    import torch
    import torch.distributed as dist

    from ntcard_tpu_torch.cli import parse_args, wire_batches
    from ntcard_tpu_torch.io.packing import wire_mode_of
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.parallel import multihost
    from ntcard_tpu_torch.pipeline import device_feed

    opt, _ = parse_args([*RUNS[0][1], "-p", "x", str(fq)])
    opt.s_bits = 7  # the <50 GB rule the port CLI applies
    batches, stride, use_quad, halo = wire_batches(opt, [str(fq)], {})
    sk = CountTableSketch(opt.k_list, opt.s_bits, opt.r_bits, stride, device=dev)
    for _, b in device_feed(batches, [dev]):
        sk.update(b, packed=wire_mode_of(b, opt.batch_rows, halo) if use_quad else True)
    want = sk.finalize(cov_max=opt.cov_max)
    nbins = opt.cov_max + 1
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        hist = runs.drive("route", lambda: multihost._finalize_reduce_scatter(sk, nbins))
    finally:
        dist.destroy_process_group()
    for i, k in enumerate(opt.k_list):
        got = hist[i].cpu().numpy().astype(np.int64)
        if not np.array_equal(got, want[k]["hist"]):
            raise AssertionError(f"device route k{k}: histogram differs from the sketch's finalize")
    del sk
    torch.cuda.empty_cache()


def phase_scaleout(fq: Path, tmp: Path, dev, runs: Runs, want_regs, host_line: str,
                   seed: int) -> None:
    """Phase 6: the scale-out layer on the one card, against phase 4's
    host-engine outputs (host_<tag>_k*.hist in ``tmp``, the registers and
    F0 line)."""
    import torch

    from ntcard_tpu_torch.cli_hll import device_registers

    walls, launches = runs.walls, runs.launches
    two = ["cuda:0", "cuda:0"]  # two private sketches on the one card

    tag, (_, flags, ks) = "md_r27", RUNS[0]
    err = runs.drive(tag, lambda: run_cli([*flags, "--devices", "2", "--metrics",
                                           "-p", tmp / tag, fq], two,
                                          capture_stderr=True))
    same_hist(tmp / tag, tmp / "host_r27", ks)
    check_k2_per_k3(tag, launches[tag])
    merge_s = merge_time(torch.device("cuda", 0), seed)
    # each table read twice and written once: 3 x 3 x (2^28 + 1) int32
    merge_bound_ms = bound_ms(9 * 4 * ((2 << 27) + 1), 0)[0]
    print(f"  two private sketches on the card, {' '.join(flags)} --devices 2: .hist byte-equal "
          f"to the host engine's; wall {walls[tag]:.3f} s (one sketch, phase 4: "
          f"{walls['r27']:.3f} s); CLI phases (s) {cli_metrics(err)['phases_sec']}; merge of two "
          f"r27 3-k sketches alone {1e3 * merge_s:.3f} ms (bound {merge_bound_ms:.3f} ms)")
    tag = "md_nthll"
    if runs.drive(tag, lambda: run_nthll([f"-k{HLL_K}", fq], two)) != host_line:
        raise AssertionError(f"{tag}: F0 line differs from the host engine's")
    check_registers(tag, device_registers([str(fq)], HLL_K, HLL_BITS, 1, two), want_regs)
    print(f"  nthll -k{HLL_K} on two private register sets: registers and F0 line equal to the "
          f"host engine's; wall {walls[tag]:.3f} s (one, phase 4: {walls['nthll']:.3f} s)")

    halves = [str(h) for h in split_fastq(fq, tmp)]
    port = free_port()
    tag, (_, flags, ks) = "mh_r16", RUNS[1]
    outs = two_processes(runs, tag, "ntcard", lambda pid: [
        *flags, "-p", str(tmp / f"{tag}_{pid}"), "--coordinator", f"127.0.0.1:{port}",
        "--num-hosts", "2", "--host-id", str(pid), *halves], lambda pid: {})
    same_hist(tmp / f"{tag}_0", tmp / "host_r16", ks)
    if list(tmp.glob(f"{tag}_1*")):
        raise AssertionError(f"{tag}: process 1 wrote output")
    runtimes = [ln.split()[-1] for _, err in outs for ln in err.splitlines()
                if ln.startswith("Runtime(sec):")]
    print(f"  two processes on the card (gloo, host route), {' '.join(flags)} over the two halves "
          f"by the flags: process 0's .hist byte-equal to the host engine's, process 1 wrote "
          f"nothing; wall {walls[tag]:.3f} s, process start included; each process's "
          f"Runtime(sec), from main() on: {', '.join(runtimes)} (one process, phase 4: "
          f"{walls['r16']:.3f} s)")
    port = free_port()
    tag = "mh_nthll"
    outs = two_processes(runs, tag, "nthll", lambda pid: [f"-k{HLL_K}", *halves], lambda pid: {
        "NTCARD_COORDINATOR": f"127.0.0.1:{port}", "NTCARD_NUM_PROCESSES": "2",
        "NTCARD_PROCESS_ID": str(pid)})
    if [ln for ln in outs[0][0].splitlines(True) if ln.startswith("F0,")] != [host_line] or \
            any(ln.startswith("F0,") for ln in outs[1][0].splitlines()):
        raise AssertionError(f"{tag}: process 0's F0 line differs from the host engine's, or "
                             f"process 1 printed one")
    print(f"  nthll -k{HLL_K} as two processes by the environment: process 0's F0 line equal to "
          f"the host engine's; wall {walls[tag]:.3f} s, process start included")
    device_route(fq, dev, runs)
    print(f"  device route of the cross-process finalize in a one-rank NCCL group, r27 3-k: "
          f"equal to the sketch's own finalize; {1e3 * walls['route']:.3f} ms")

    total = {"r16": launches["r16"]["sketch_idx"], "nthll": launches["nthll"]["hll_update"]}
    with env_set(NTCARD_ENGINE="hybrid"):
        tag, (_, flags, ks) = "hy_r16", RUNS[1]
        err = runs.drive(tag, lambda: run_cli([*flags, "--metrics", "-p", tmp / tag, fq],
                                              dev.type, capture_stderr=True))
        engine = cli_metrics(err).get("engine")
        if engine != "hybrid":
            raise AssertionError(f"{tag}: the run's engine tag is {engine!r}, not hybrid")
        same_hist(tmp / tag, tmp / "host_r16", ks)
        on_card = launches[tag]["sketch_idx"]
        print(f"  NTCARD_ENGINE=hybrid {' '.join(flags)}: engine {engine}, .hist byte-equal to the "
              f"host engine's; {on_card} batches on the card, {total['r16'] - on_card} on the "
              f"host engine; wall {walls[tag]:.3f} s (device only, phase 4: {walls['r16']:.3f} s)")
        tag = "hy_nthll"
        if runs.drive(tag, lambda: run_nthll([f"-k{HLL_K}", fq], dev.type)) != host_line:
            raise AssertionError(f"{tag}: F0 line differs from the host engine's")
        on_card = launches[tag]["hll_update"]
        print(f"  NTCARD_ENGINE=hybrid nthll -k{HLL_K}: F0 line equal to the host engine's; "
              f"{on_card} batches on the card, {total['nthll'] - on_card} on the host engine; wall "
              f"{walls[tag]:.3f} s (device only, phase 4: {walls['nthll']:.3f} s)")
    print(f"  launches in each phase 6 run: {json.dumps({t: launches[t] for t in PHASE6_RUNS})}")
    interleaved_walls(fq, tmp, dev)
    torch.cuda.empty_cache()


def interleaved_walls(fq: Path, tmp: Path, dev) -> None:
    """The one-device, two-sketch and hybrid walls in turns, REPS each, and
    decode alone of the two streams they read: the quad2 wire (the device
    paths) and raw code batches (the hybrid feed)."""
    from ntcard_tpu_torch.cli import geometry, parse_args
    from ntcard_tpu_torch.pipeline import parallel_batches_from_files

    def wall(fn):
        t0 = time.monotonic()
        fn()
        return time.monotonic() - t0

    def decode(flags, wire):
        opt, _ = parse_args([*flags, "-p", "x", str(fq)])
        chunk_len, _ = geometry(opt)
        return wall(lambda: sum(1 for _ in parallel_batches_from_files(
            [str(fq)], chunk_len, opt.batch_rows, max(opt.k_list), 1, wire_packed=wire)))

    r27, r16 = RUNS[0][1], RUNS[1][1]
    cases = {
        "r27 one sketch": lambda: run_cli([*r27, "-p", tmp / "w", fq], dev.type),
        "r27 two sketches": lambda: run_cli([*r27, "--devices", "2", "-p", tmp / "w", fq],
                                            ["cuda:0", "cuda:0"]),
        "r16 device only": lambda: run_cli([*r16, "-p", tmp / "w", fq], dev.type),
        "r16 hybrid": lambda: run_with_env(lambda: run_cli([*r16, "-p", tmp / "w", fq], dev.type),
                                           NTCARD_ENGINE="hybrid"),
        "r16 decode alone, quad2 wire": lambda: decode(r16, "quad2"),
        "r16 decode alone, raw batches": lambda: decode(r16, False),
    }
    got = {name: [] for name in cases}
    for _ in range(REPS):
        for name, fn in cases.items():
            got[name].append(wall(fn))
    print("  walls in turns (s): " + "; ".join(
        f"{name} {', '.join(f'{t:.4f}' for t in ts)} (median {sorted(ts)[REPS // 2]:.4f})"
        for name, ts in got.items()))


def run_with_env(fn, **kv):
    with env_set(**kv):
        return fn()


REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every generated input")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ntcard_tpu_torch import _build, native

    global INT32_PER_S
    dev = torch.device("cuda")
    print("phase 1: build")
    t0 = time.monotonic()
    libs = _build.build_all()
    print(f"  kernels built in {time.monotonic() - t0:.1f} s")
    for name in sorted(libs):
        print(f"  ptxas, {name}.cu: " + "; ".join(_build.ptxas_report(name).splitlines()))
    t0 = time.monotonic()
    native.get_lib()  # raises if g++ did not build it
    print(f"  native decode + pack library ready in {time.monotonic() - t0:.1f} s "
          "(g++ builds it once per checkout, into ntcard_tpu_torch/_kernels_build/native)")

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    print(smi("name,power.limit"))
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    INT32_PER_S = n_sm * 64 * clock_mhz * 1e6
    print(f"  INT32 peak {INT32_PER_S / 1e12:.3f} T/s ({n_sm} SMs x 64 lanes x {clock_mhz:.0f} "
          f"MHz), memory peak {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    print("phase 2: kernels vs plain versions at the main path's shapes")
    kernels = phase_kernels(dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tmp = Path(td)
        print("phase 3: goldens through the port CLI on the card")
        phase_goldens(tmp)
        print("phase 4: full-size main path")
        fq = tmp / "reads.fq"
        t0 = time.monotonic()
        write_fastq(fq, args.seed)
        print(f"  wrote {fq.stat().st_size} bytes of FASTQ in {time.monotonic() - t0:.1f} s")
        runs = Runs()
        want_regs, host_line = phase_full(fq, tmp, dev, runs)
        print("phase 5: where the time goes in the full-size runs")
        phase_breakdown(fq, tmp, dev)
        print("phase 6: the scale-out layer on one card")
        phase_scaleout(fq, tmp, dev, runs, want_regs, host_line, args.seed)
    for k in kernels:  # each record's launches in the main-path runs that make them
        wrapper, tags, div = RECORD_RUNS[k["name"]]
        k["launches"] = sum(runs.launches[tag][wrapper] for tag in tags) // div
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    loaded = [m for m, mod in sys.modules.items()
              if mod is not None and (m == "ntcard_tpu" or m.startswith("ntcard_tpu."))]
    if loaded:
        raise AssertionError(f"the port loaded the JAX package's modules {loaded}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
