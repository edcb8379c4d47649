"""nthll command line on the CUDA devices (the port of ntcard_tpu.cli_hll's
device paths: every local card, several hosts, and the hybrid host + device
engine).

Same flags, messages and output as ``ntcard_tpu.cli_hll``; the getopt spec
and the usage and version texts are the port's copies of
ntcard_tpu/cli_hll.py:12-44. It always runs the device path
(NTCARD_ENGINE=hybrid adds the native host engine beside it): the JAX
package's engine routing rests on TPU measurements and is not ported. It
counts on every local card, one private register set each; a multi-host run
(NTCARD_COORDINATOR, NTCARD_NUM_PROCESSES, NTCARD_PROCESS_ID) counts each
host's share of the files on its first card, and process 0 prints.

Run: ``python -m ntcard_tpu_torch.cli_hll -k25 reads.fq``
"""

from __future__ import annotations

import getopt
import os
import sys
from contextlib import closing
from typing import List, Optional

import numpy as np

PROGRAM = "nthll"

# -h/-c/--hash are accepted-and-ignored, matching the reference binary
GETOPT_SPEC = (
    "t:k:b:s:hc",
    ["threads=", "kmer=", "bit=", "sit=", "hash=", "help", "version"],
)

VERSION_MESSAGE = (
    "nthll-TPU 1.0.0 (capability parity with nthll 1.2.2)\n"
    "A TPU-native HyperLogLog distinct k-mer estimator.\n"
)

USAGE_MESSAGE = f"""Usage: {PROGRAM} [OPTION]... FILE(S)...
Estimates distinct number of k-mers in FILE(S).

Acceptable file formats: fastq, fasta, sam, bam and in compressed formats gz, bz, zip, xz.
Accepts a list of files by adding @ at the beginning of the list name.

 Options:

  -t, --threads=N\tuse N parallel threads [1] (N>=2 should be used when input files are >=2)
  -k, --kmer=N\tthe length of kmer [64]
      --help\tdisplay this help and exit
      --version\toutput version information and exit

Report bugs to https://github.com/bcgsc/ntCard/issues
"""


def device_registers(in_files, km_len: int, n_bits: int, n_thrd: int, devices, private=True):
    """The uint8 HLL registers of ``in_files`` at k = ``km_len``, counted on
    ``devices`` (one private register set each) and max-merged over the
    devices and, in a multi-host run, over the processes. nthll skips
    unreadable files and sniffs formats leniently (nthll.cpp:70-90,
    225-235); -t fans decode threads over files. Under NTCARD_ENGINE=hybrid
    a ``private`` run (one device, one host) shares the batches with the
    native host engine (ntcard_tpu/cli_hll.py:225-296)."""
    from ntcard_tpu_torch.cli import hybrid_note, select_wire
    from ntcard_tpu_torch.io.decompress import input_size
    from ntcard_tpu_torch.io.packing import aligned_stride, wire_mode_of
    from ntcard_tpu_torch.models.host_engine import HostHllSketch
    from ntcard_tpu_torch.parallel.data_parallel import PerDeviceHllSketch
    from ntcard_tpu_torch.parallel.multihost import merged_hll_registers
    from ntcard_tpu_torch.pipeline import (
        default_geometry,
        device_feed,
        hybrid_feed,
        parallel_batches_from_files,
    )

    chunk_len, batch_rows = default_geometry(km_len)
    stride = aligned_stride(chunk_len, km_len)
    wire_fmt, use_quad, halo = select_wire(batch_rows, chunk_len, stride)
    sketch = PerDeviceHllSketch(km_len, n_bits, stride, devices=devices)
    host_sketch = None
    if os.environ.get("NTCARD_ENGINE") == "hybrid":
        if private and len(devices) == 1:
            host_sketch = HostHllSketch(
                km_len, n_bits, stride, n_threads=max(1, (os.cpu_count() or 2) - 2)
            )
        else:
            hybrid_note(PROGRAM, "sharded/multi-host sketches are device-only")
    if host_sketch is not None:
        raw = parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd, lenient=True, on_error="skip",
        )
        est_batches = sum(input_size(f) for f in in_files) / float(batch_rows * stride)
        batches = hybrid_feed(raw, host_sketch.update, total_hint=est_batches)
    else:
        batches = parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd,
            lenient=True, on_error="skip", wire_packed=wire_fmt,
        )
    with closing(device_feed(batches, sketch.devices)) as feed:
        for slot, batch in feed:
            if host_sketch is not None:
                packed = False  # raw code batches, as the host engine takes them
            else:
                packed = wire_mode_of(batch, batch_rows, halo) if use_quad else True
            sketch.update(slot, batch, packed=packed)
    regs = merged_hll_registers(sketch)
    if host_sketch is not None:
        regs = np.maximum(regs, host_sketch.registers())
    return regs


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run nthll. ``device``: None (or "cuda") counts on every local card
    and raises without CUDA; a sequence of devices (repeats allowed) counts
    on those; any other one device ("cpu" runs the plain PyTorch version of
    the kernel) on that device alone."""
    args_in = sys.argv[1:] if argv is None else argv
    n_bits, km_len, n_thrd = 16, 64, 1
    try:
        optlist, args = getopt.gnu_getopt(args_in, *GETOPT_SPEC)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{PROGRAM}: {e}\nTry `{PROGRAM} --help' for more information.\n")
        return 1

    def uint(s, flag):
        try:
            return int(s)
        except ValueError:
            sys.stderr.write(f"{PROGRAM}: invalid option: `-{flag}{s}'\n")
            raise SystemExit(1)

    for flag, val in optlist:
        if flag in ("-t", "--threads"):
            n_thrd = uint(val, "t")
        elif flag in ("-k", "--kmer"):
            km_len = uint(val, "k")
        elif flag in ("-b", "--bit"):
            n_bits = uint(val, "b")
        elif flag in ("-s", "--sit"):
            uint(val, "s")
        # -h / -c / --hash: accepted, no effect
        elif flag == "--help":
            sys.stderr.write(USAGE_MESSAGE)
            return 0
        elif flag == "--version":
            sys.stderr.write(VERSION_MESSAGE)
            return 0

    if len(args) < 1:
        sys.stderr.write(f"{PROGRAM}: missing arguments\n")
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        return 1

    from ntcard_tpu_torch.cli import run_devices
    from ntcard_tpu_torch.io.decompress import input_size
    from ntcard_tpu_torch.io.readers import expand_file_args
    from ntcard_tpu_torch.models.estimate import estimate_f0
    from ntcard_tpu_torch.parallel import multihost
    from ntcard_tpu_torch.pipeline import host_file_assignment

    devices = run_devices(device, 0, PROGRAM)
    proc_id, n_procs = multihost.initialize_distributed(device_type=devices[0].type)
    try:
        in_files = expand_file_args(args)
        if n_procs > 1:
            # per-host private registers on the host's first device over the
            # host's slice of the files, max-merged at the end
            devices = devices[:1]
            sizes = [input_size(f) for f in in_files]
            in_files = host_file_assignment(in_files, sizes, n_procs, proc_id)
        regs = device_registers(in_files, km_len, n_bits, n_thrd, devices, private=n_procs == 1)
    finally:
        multihost.shutdown_distributed()
    if proc_id == 0:
        f0 = estimate_f0(regs, canon=True)
        sys.stdout.write(f"F0, Exp# of distnt kmers(k={km_len}): {f0}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
