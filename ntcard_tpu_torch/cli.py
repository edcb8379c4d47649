"""ntcard command line on one CUDA device (the port of ntcard_tpu.cli's
single-device path, _main_device_fast).

Same flags, messages and byte-identical outputs as ``ntcard_tpu.cli``, whose
jax-free host layer (argument parsing, wire selection, decode and pack, the
estimator and the writers) it reuses by import. It always runs the device
path: the JAX package's engine routing rests on TPU measurements and is not
ported. What is not ported yet is refused with a "not ported yet" message
and exit status 1, never handed to another engine.

Run: ``python -m ntcard_tpu_torch.cli -k64,96,128 -p out reads.fq``
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from ntcard_tpu.cli import PROGRAM, _estimate_and_write, _gap_positions, _select_wire, parse_args


def unported_env():
    """What the environment asks for that the port does not do yet (shared
    by both CLIs), or None."""
    if any(
        os.environ.get(v)
        for v in ("NTCARD_COORDINATOR", "NTCARD_NUM_PROCESSES", "NTCARD_PROCESS_ID")
    ):
        return "multi-host runs"
    if os.environ.get("NTCARD_ENGINE") == "hybrid":
        return "NTCARD_ENGINE=hybrid"
    return None


def _refuse_unported(opt) -> None:
    why = None
    if opt.devices > 1:
        why = "--devices > 1 (multi-device)"
    elif opt.coordinator or opt.num_hosts or opt.host_id >= 0:
        why = "multi-host runs"
    else:
        why = unported_env()
    if why:
        raise SystemExit(f"{PROGRAM}: {why} is not ported yet to ntcard_tpu_torch")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run ntcard on ``device``: None means CUDA (raises without it);
    "cpu" runs the plain PyTorch versions of the kernels."""
    s_time = time.monotonic()
    opt, args = parse_args(sys.argv[1:] if argv is None else argv)
    _refuse_unported(opt)

    from ntcard_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    from ntcard_tpu.io.decompress import input_size
    from ntcard_tpu.io.readers import expand_file_args

    in_files = expand_file_args(args)
    # <50 GB heuristic overrides -s after parsing (ntcard.cpp:427-431)
    if sum(input_size(f) for f in in_files) < 50_000_000_000:
        opt.s_bits = 7
    return _main_device(opt, in_files, s_time, dev)


def wire_batches(opt, in_files, stats: dict):
    """The run's decode + pack stream, as ntcard_tpu's device path makes it:
    (wire batches, stride, whether batches carry a wire-mode tag, halo)."""
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.pipeline import default_geometry, parallel_batches_from_files

    kmax = max(opt.k_list)
    chunk_len, _ = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    stride = aligned_stride(chunk_len, kmax)
    # superbatch stacks (the last value) are a TPU dispatch workaround: unused
    wire_fmt, use_quad, halo, _ = _select_wire(opt.batch_rows, chunk_len, stride)
    batches = parallel_batches_from_files(
        in_files, chunk_len, opt.batch_rows, kmax, opt.n_thrd, stats_out=stats,
        wire_packed=wire_fmt,
    )
    return batches, stride, use_quad, halo


def _main_device(opt, in_files, s_time, dev) -> int:
    from ntcard_tpu.io.packing import wire_mode_of
    from ntcard_tpu.utils.metrics import Metrics
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.pipeline import device_feed

    metrics = Metrics(opt.metrics)
    stats: dict = {}
    batches, stride, use_quad, halo = wire_batches(opt, in_files, stats)
    sketch = CountTableSketch(
        opt.k_list, opt.s_bits, opt.r_bits, stride, gap_positions=_gap_positions(opt), device=dev
    )
    with metrics.phase("pipeline"):
        for batch in device_feed(batches, dev):
            packed = wire_mode_of(batch, opt.batch_rows, halo) if use_quad else True
            sketch.update(batch, packed=packed)
    if opt.save_sketch:
        sketch.save(opt.save_sketch)
    with metrics.phase("finalize"):
        state = sketch.finalize(cov_max=opt.cov_max)
    metrics.tag("engine", f"torch-{dev.type}")
    return _estimate_and_write(opt, state, metrics, stats, sketch, s_time)


if __name__ == "__main__":
    raise SystemExit(main())
