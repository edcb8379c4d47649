"""Host-side streaming pipeline: files -> records -> packed wire batches ->
device (the port's copy of the single-device parts of ntcard_tpu/pipeline.py,
with its own host-to-device stage).

Every file's records feed one packed stream (order is irrelevant: the sketch
is a commutative fold), cut into dense [B, L] batches. Record boundaries are
N separators, so per-record window semantics are preserved exactly. Decode
and pack run in the port's native packer (ntcard_tpu_torch.native) on
background threads, one packer per thread over a deterministic file
partition.

:func:`device_feed` replaces the jax.device_put stage of
ntcard_tpu/pipeline.py:466-531: each wire batch is copied into a pinned host
buffer and sent to the card with a non-blocking copy on the current stream,
so the copy of batch i+1 overlaps the kernels of batch i. A ring of pinned
buffers is reused; before a buffer is refilled, the host waits for the event
recorded after its last copy.
"""

from __future__ import annotations

import sys
import threading
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ntcard_tpu_torch.io.decompress import DecompressError, input_size, open_input
from ntcard_tpu_torch.native import NativePacker

RING = 3  # pinned buffers: one being filled, one in flight, one spare


def batches_from_files(
    paths: Sequence[str],
    chunk_len: int,
    batch_rows: int,
    kmax: int,
    lenient: bool = False,
    on_error: str = "exit",
    stats_out: Optional[dict] = None,
    wire_packed=False,
    io_chunk: int = 1 << 22,
) -> Iterator[np.ndarray]:
    """Dense [batch_rows, chunk_len] uint8 batches over all input records,
    or, with ``wire_packed``, wire batches: True/"nibble" gives the
    [batch_rows/2, chunk_len] nibble wire, "quad" and "quad2" the 2-bit
    wires (io/packing) with a per-batch nibble fallback on N-count
    overflow; consumers pass packed=io.packing.wire_mode_of(...) to
    sketch.update. Decode and pack run in the native packer, fed
    ``io_chunk`` raw bytes at a time.

    on_error="exit": unreadable/unknown-format file -> message + exit(1)
    (ntcard contract, ntcard.cpp:459-462); "skip": silently skip unreadable
    files (nthll contract: its reader loop has no error path)."""
    packer = NativePacker(chunk_len, batch_rows, kmax, lenient, wire_packed=wire_packed)
    for path in paths:
        try:
            stream = open_input(path)
        except DecompressError as e:
            # missing filter program: clean fail-fast, mirroring the
            # reference's SIGCHLD reaper contract (SignalHandler.cpp:38-52)
            if on_error == "skip":
                continue
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)
        except (OSError, ValueError):
            if on_error == "skip":
                continue
            print(f"Error in reading file: {path}", file=sys.stderr)
            raise SystemExit(1)
        try:
            with stream:
                try:
                    while True:
                        data = stream.read(io_chunk)
                        if not data:
                            break
                        yield from packer.feed_bytes(data)
                    yield from packer.end_file()
                except ValueError:
                    if on_error == "skip":
                        packer.abort_file()
                        continue
                    print(f"Error in reading file: {path}", file=sys.stderr)
                    raise SystemExit(1)
        except DecompressError as e:
            # fail-fast on decompressor child failure, like the reference's
            # SIGCHLD reaper (Common/SignalHandler.cpp:32-62)
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)
    yield from packer.flush()
    if stats_out is not None:
        stats_out["records"], stats_out["bases"] = packer.stats()


def default_geometry(kmax: int, target_chunk: int = 1024, batch_rows: int = 8192):
    """Pick (chunk_len, batch_rows): chunk_len comfortably above kmax so halo
    overhead (kmax-1)/chunk_len stays small; batch_rows sized so one batch
    (~8 Mbases) amortizes per-dispatch overhead."""
    chunk_len = max(target_chunk, 8 * kmax)
    return chunk_len, batch_rows


def host_file_assignment(
    files: Sequence[str], sizes: Sequence[int], num_hosts: int, host_id: int
) -> List[str]:
    """Deterministic file slice of one of ``num_hosts`` workers: greedy
    longest-processing-time, files sorted by (size desc, name) each go to
    the currently least-loaded worker (ties by index). Every worker derives
    the identical partition from the same inputs, so the union is exact and
    disjoint (ntcard_tpu/parallel/multihost.py:53)."""
    order = sorted(range(len(files)), key=lambda i: (-sizes[i], files[i]))
    loads = [0] * num_hosts
    mine: List[str] = []
    for i in order:
        h = min(range(num_hosts), key=lambda j: (loads[j], j))
        loads[h] += sizes[i]
        if h == host_id:
            mine.append(files[i])
    return mine


_STATS_LOCK = threading.Lock()


def parallel_batches_from_files(
    paths: Sequence[str],
    chunk_len: int,
    batch_rows: int,
    kmax: int,
    n_threads: int,
    lenient: bool = False,
    on_error: str = "exit",
    stats_out: Optional[dict] = None,
    wire_packed=False,
) -> Iterator[np.ndarray]:
    """Decode+pack files on ``n_threads`` host threads, one packer per
    thread over a deterministic file partition (:func:`host_file_assignment`):
    the reference's file-level parallelism (`omp parallel for` over files,
    ntcard.cpp:445) without its shared-table atomics; batch order is
    irrelevant because the sketch fold commutes. The native packer releases
    the GIL, so threads genuinely overlap."""
    import queue

    n_threads = max(1, min(n_threads, len(paths)))
    if n_threads == 1:
        yield from batches_from_files(
            paths, chunk_len, batch_rows, kmax,
            lenient=lenient, on_error=on_error, stats_out=stats_out,
            wire_packed=wire_packed,
        )
        return

    sizes = [input_size(p) for p in paths]
    parts = [host_file_assignment(paths, sizes, n_threads, t) for t in range(n_threads)]
    q: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
    done = object()
    errs: list = []

    def worker(my_paths):
        stats: dict = {}
        try:
            for b in batches_from_files(
                my_paths, chunk_len, batch_rows, kmax,
                lenient=lenient, on_error=on_error, stats_out=stats,
                wire_packed=wire_packed,
            ):
                q.put(b)
        except BaseException as e:
            errs.append(e)
        finally:
            if stats_out is not None and stats:
                with _STATS_LOCK:
                    for key, v in stats.items():
                        stats_out[key] = stats_out.get(key, 0) + v
            q.put(done)

    threads = [threading.Thread(target=worker, args=(p,), daemon=True) for p in parts if p]
    for t in threads:
        t.start()
    remaining = len(threads)
    while remaining:
        item = q.get()
        if item is done:
            remaining -= 1
            continue
        yield item
    if errs:
        raise errs[0]


def prefetch(iterator: Iterable, depth: int = 3) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue, so host
    decode and pack run ahead while the device consumes batches."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate SystemExit etc. to consumer
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item


def device_feed(batches: Iterable[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Yield each numpy batch as a tensor on ``device`` (decode runs ahead
    on a background thread). On the CPU the tensor shares the batch's
    memory."""
    if device.type != "cuda":
        for b in prefetch(batches):
            yield torch.from_numpy(b)
        return
    ring: list = [None] * RING  # (pinned host tensor, event of its last copy)
    for i, b in enumerate(prefetch(batches)):
        slot = ring[i % RING]
        if slot is None or slot[0].shape != b.shape:
            slot = (torch.empty(b.shape, dtype=torch.uint8, pin_memory=True), torch.cuda.Event())
            ring[i % RING] = slot
        else:
            slot[1].synchronize()  # its previous copy to the card has finished
        host, done = slot
        host.numpy()[...] = b
        dev = host.to(device, non_blocking=True)
        done.record()
        yield dev
