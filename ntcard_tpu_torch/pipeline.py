"""Host-side streaming pipeline: files -> records -> packed wire batches ->
devices (the port's copy of ntcard_tpu/pipeline.py's streams and hybrid
feed, with its own host-to-device stage).

Every file's records feed one packed stream (order is irrelevant: the sketch
is a commutative fold), cut into dense [B, L] batches. Record boundaries are
N separators, so per-record window semantics are preserved exactly. Decode
and pack run in the port's native packer (ntcard_tpu_torch.native) on
background threads, one packer per thread over a deterministic file
partition.

:func:`device_feed` replaces the jax.device_put stage of
ntcard_tpu/pipeline.py:466-531: the batches go to the devices in turn; each
is copied into a pinned host buffer of its device's ring and sent to that
card with a non-blocking copy on the card's current stream, so the copy of
batch i+1 overlaps the kernels of batch i. Each ring is reused; before a
buffer is refilled, the host waits for the event recorded after its last
copy. :func:`hybrid_feed` shares one batch stream between the native host
engine and the device (NTCARD_ENGINE=hybrid).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

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
    stop = threading.Event()
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
                if not _put(q, b, stop):
                    break
        except BaseException as e:
            errs.append(e)
        finally:
            if stats_out is not None and stats:
                with _STATS_LOCK:
                    for key, v in stats.items():
                        stats_out[key] = stats_out.get(key, 0) + v
            _put(q, done, stop)

    threads = [threading.Thread(target=worker, args=(p,), daemon=True) for p in parts if p]
    for t in threads:
        t.start()
    try:
        remaining = len(threads)
        while remaining:
            item = q.get()
            if item is done:
                remaining -= 1
                continue
            yield item
    finally:
        # closed early: the decode threads stop at their next batch
        stop.set()
        for t in threads:
            t.join()
    if errs:
        raise errs[0]


def _put(q, item, stop: threading.Event) -> bool:
    """Put ``item`` on the bounded queue ``q`` unless ``stop`` is set first;
    whether it was put."""
    import queue

    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


def prefetch(iterator: Iterable, depth: int = 3) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue, so host
    decode and pack run ahead while the device consumes batches.

    Closing the returned iterator (its consumer raised, or stopped early)
    stops the thread at its next item, closes ``iterator`` and joins the
    thread, as ntcard_tpu/pipeline.py:447-463 does: nothing goes on
    decoding or counting underneath the failure."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                if not _put(q, item, stop):
                    break
        except BaseException as e:  # propagate SystemExit etc. to consumer
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:
                    err.append(e)
            _put(q, done, stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()


def _tail_guard_should_stop(
    total_hint: float | None,
    pulled: int,
    host_done: int,
    elapsed: float,
    dev_batch_sec: float,
) -> bool:
    """Whether the device side of hybrid_feed should stop claiming batches:
    True when the host engines alone would finish the *estimated* rest of
    the stream sooner than the device finishes one more (best-case) batch.
    Once ``pulled`` reaches the hint, the stream has proven the hint short
    (compressed inputs report their on-disk bytes), so the guard turns
    itself off rather than starve a possibly fast device."""
    if total_hint is None or host_done <= 0 or dev_batch_sec <= 0.0:
        return False
    remaining = total_hint - pulled
    if remaining <= 0:
        return False  # hint exhausted: distrust it
    host_sec_per_batch = max(elapsed, 1e-9) / host_done  # the host engine's rate
    return remaining * host_sec_per_batch < dev_batch_sec


def hybrid_feed(
    raw_batches: Iterable[np.ndarray],
    host_update,
    total_hint: float | None = None,
) -> Iterator[np.ndarray]:
    """Share one batch stream between the host engine and the device
    (ntcard_tpu/pipeline.py:215-338).

    ``host_update(batch)`` runs on a background worker for every batch the
    host side claims; the returned iterator yields the rest to the device.
    Both sides pull from one locked iterator, so the split is pure work
    stealing with no ratio to tune. The folds commute, so any split equals a
    single-engine run bit for bit (the sketches merge at the end:
    CountTableSketch.merge_host_, or a max of registers).

    The iterator joins the worker before it ends and then raises the
    worker's exception, if any, so a caller may merge the host sketch as
    soon as its loop ends. A worker's error stops the whole feed at once,
    and closing the iterator early (the consumer raised) stops and joins
    the worker and closes ``raw_batches``.

    Tail guard: with ``total_hint`` (the estimated batch count), the device
    side stops claiming once the host engines alone would finish the
    estimated rest sooner than the device finishes one more batch, judged
    from the rates both sides have shown (:func:`_tail_guard_should_stop`),
    so a slow device never holds the last batch."""
    lock = threading.Lock()
    stop = threading.Event()
    it = iter(raw_batches)
    errs: list = []
    t0 = time.perf_counter()
    host_done = [0]  # batches completed by the host worker (under lock)
    pulled = [0]  # batches claimed by anyone
    dev_pulled = [0]
    dev_last_pull = [0.0]
    dev_batch_sec = [0.0]  # least observed time between two device pulls

    def pull(for_device: bool = False):
        if stop.is_set():
            return None
        if (
            for_device
            and dev_pulled[0] >= 2  # enough samples of both rates
            and _tail_guard_should_stop(
                total_hint, pulled[0], host_done[0], time.perf_counter() - t0, dev_batch_sec[0]
            )
        ):
            return None  # the host finishes the tail before one more device batch
        with lock:
            b = next(it, None)
            if b is not None:
                pulled[0] += 1
                if for_device:
                    now = time.perf_counter()
                    if dev_pulled[0] > 0:
                        # the least, not the mean: one stalled batch must not
                        # fire the (irreversible) cutoff
                        dt = now - dev_last_pull[0]
                        dev_batch_sec[0] = dt if dev_batch_sec[0] == 0.0 else min(dev_batch_sec[0], dt)
                    dev_last_pull[0] = now
                    dev_pulled[0] += 1
            return b

    def worker():
        try:
            while True:
                b = pull()
                if b is None:
                    return
                host_update(b)
                with lock:
                    host_done[0] += 1
        except BaseException as e:
            errs.append(e)
            stop.set()

    host = threading.Thread(target=worker, daemon=True)
    host.start()
    try:
        while not stop.is_set():
            b = pull(for_device=True)
            if b is None:
                break
            yield b
        # the device side may stop early (tail guard) with batches left: the
        # host worker drains them before the iterator ends
        host.join()
    finally:
        stop.set()
        host.join()
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if errs:
        raise errs[0]


def device_feed(
    batches: Iterable[np.ndarray], devices: Sequence[torch.device]
) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (slot, tensor): batch i as a tensor on ``devices[slot]``, slot =
    i mod len(devices) (decode runs ahead on a background thread). On the CPU
    the tensor shares the batch's memory. On a card, each slot has its own
    ring of pinned buffers, and its copy and the event after it are issued
    on that card's current stream, where the sketch's kernels run. Closing
    it (the consumer raised) closes ``batches`` through :func:`prefetch`."""
    n = len(devices)
    feed = prefetch(batches)
    try:
        if all(d.type != "cuda" for d in devices):
            for i, b in enumerate(feed):
                yield i % n, torch.from_numpy(b)
        else:
            yield from _to_cards(feed, devices)
    finally:
        feed.close()  # closed early: stop and close the stream behind it


def _to_cards(feed: Iterator[np.ndarray], devices: Sequence[torch.device]):
    n = len(devices)
    rings = [[None] * RING for _ in range(n)]  # (pinned host tensor, event of its last copy)
    for i, b in enumerate(feed):
        slot, dev = i % n, devices[i % n]
        ring, j = rings[slot], (i // n) % RING
        entry = ring[j]
        if entry is None or entry[0].shape != b.shape:
            entry = ring[j] = (torch.empty(b.shape, dtype=torch.uint8, pin_memory=True),
                               torch.cuda.Event())
        else:
            entry[1].synchronize()  # its previous copy to the card has finished
        host, done = entry
        host.numpy()[...] = b
        with torch.cuda.device(dev):
            out = host.to(dev, non_blocking=True)
            done.record()
        yield slot, out
