"""ntcard command line on the CUDA devices (the port of ntcard_tpu.cli's
device paths: one device, several local devices, several hosts, and the
hybrid host + device engine).

Same flags, messages (the engine notes of --help aside) and byte-identical
outputs as ``ntcard_tpu.cli``. The flag parser, the wire selection and the
estimate-and-write epilogue are the port's own copies of
ntcard_tpu/cli.py:19-313 (tests/test_torch_host.py holds the parser to the
original); decode and pack, the estimator and the writers are the port's
copies too (io/, native/, models/estimate.py, output.py). It always runs
the device path (NTCARD_ENGINE=hybrid adds the native host engine beside
it): the JAX package's engine routing rests on TPU measurements and is not
ported. What is not ported yet is refused with a "not ported yet" message
and exit status 1, never handed to another engine.

Run: ``python -m ntcard_tpu_torch.cli -k64,96,128 -p out reads.fq``
"""

from __future__ import annotations

import getopt
import os
import sys
import time
from contextlib import closing
from typing import List, Optional

PROGRAM = "ntCard"

VERSION_MESSAGE = (
    "ntCard-TPU 1.0.0 (capability parity with ntCard 1.2.2)\n"
    "A TPU-native k-mer cardinality estimation framework.\n"
)

USAGE_MESSAGE = f"""Usage: {PROGRAM} [OPTION]... FILE(S)...
Estimates k-mer coverage histogram in FILE(S).

Acceptable file formats: fastq, fasta, sam, bam and in compressed formats gz, bz, zip, xz.
A list of files containing file names in each row can be passed with @ prefix.

 Options:

  -t, --threads=N\tuse N parallel threads [1] (N>=2 should be used when input files are >=2)
           \tN threads decode input files; the CUDA devices count.
  -k, --kmer=N\tthe length of kmer
  -g, --gap=N\tthe length of gap in the gap seed [0]. g mod 2 must equal k mod 2 unless g == 0
           \t-g does not support multiple k currently.
  -c, --cov=N\tthe maximum coverage of kmer in output [1000]
  -p, --pref=STRING    the prefix for output file name(s)
  -o, --output=STRING\tthe name for output file name (used when output should be a single file)
      --help\tdisplay this help and exit
      --version\toutput version information and exit

 Engine: the CUDA devices, always (ntcard_tpu_torch does not route between
 engines). --devices=N counts on the first N local cards, one private
 sketch each [0: every card]. A multi-host run (--coordinator=HOST:PORT
 --num-hosts=N --host-id=I, or NTCARD_COORDINATOR, NTCARD_NUM_PROCESSES and
 NTCARD_PROCESS_ID) counts each host's share of the files on one CUDA device
 a host; process 0 writes. NTCARD_ENGINE=hybrid shares the batches with the
 native host engine. NTCARD_WIRE=quad2|quad|nibble picks the host-to-device
 wire format [quad2].

Report bugs to https://github.com/bcgsc/ntCard/issues
"""


class Opts:
    def __init__(self):
        self.n_thrd = 1
        self.gap = 0
        self.r_bits = 27
        self.s_bits = 11
        self.cov_max = 1000
        self.prefix = ""
        self.output = ""
        self.k_list: List[int] = []
        self.chunk_len: Optional[int] = None
        self.batch_rows = 8192
        self.devices = 0  # 0 = all local devices
        self.metrics = False
        self.save_sketch = ""
        # multi-host launch (also settable via NTCARD_COORDINATOR /
        # NTCARD_NUM_PROCESSES / NTCARD_PROCESS_ID)
        self.coordinator = ""
        self.num_hosts = 0
        self.host_id = -1


def _uint(s: str, flag: str) -> int:
    """istringstream >> unsigned semantics: leading integer parse; a fully
    unparsable value is a fatal 'invalid option' (ntcard.cpp:371-374)."""
    try:
        return int(s)
    except ValueError:
        sys.stderr.write(f"{PROGRAM}: invalid option: `-{flag}{s}'\n")
        raise SystemExit(1)


def parse_args(argv: List[str]) -> tuple:
    """(options, input arguments), with the reference's flags, messages and
    exit statuses (ntcard.cpp:317-425)."""
    opt = Opts()
    die = False
    try:
        optlist, args = getopt.gnu_getopt(
            argv,
            "t:s:r:k:c:l:p:f:o:g:",
            [
                "threads=",
                "kmer=",
                "gap=",
                "cov=",
                "rbit=",
                "sbit=",
                "output=",
                "pref=",
                "chunk-len=",
                "batch-rows=",
                "devices=",
                "metrics",
                "save-sketch=",
                "coordinator=",
                "num-hosts=",
                "host-id=",
                "help",
                "version",
            ],
        )
    except getopt.GetoptError as e:
        sys.stderr.write(f"{PROGRAM}: {e}\n")
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        raise SystemExit(1)

    for flag, val in optlist:
        if flag in ("-t", "--threads"):
            opt.n_thrd = _uint(val, "t")
        elif flag in ("-s", "--sbit"):
            opt.s_bits = _uint(val, "s")
        elif flag in ("-r", "--rbit"):
            opt.r_bits = _uint(val, "r")
        elif flag in ("-c", "--cov"):
            opt.cov_max = min(_uint(val, "c"), 65535)
        elif flag in ("-p", "--pref"):
            opt.prefix = val
        elif flag in ("-o", "--output"):
            opt.output = val
        elif flag in ("-g", "--gap"):
            opt.gap = _uint(val, "g")
        elif flag in ("-k", "--kmer"):
            for token in val.split(","):
                opt.k_list.append(_uint(token, "k"))
        elif flag == "--chunk-len":
            opt.chunk_len = _uint(val, "-chunk-len")
        elif flag == "--batch-rows":
            opt.batch_rows = _uint(val, "-batch-rows")
        elif flag == "--devices":
            opt.devices = _uint(val, "-devices")
        elif flag == "--metrics":
            opt.metrics = True
        elif flag == "--save-sketch":
            opt.save_sketch = val
        elif flag == "--coordinator":
            opt.coordinator = val
        elif flag == "--num-hosts":
            opt.num_hosts = _uint(val, "-num-hosts")
        elif flag == "--host-id":
            opt.host_id = _uint(val, "-host-id")
        elif flag == "--help":
            sys.stderr.write(USAGE_MESSAGE)
            raise SystemExit(0)
        elif flag == "--version":
            sys.stderr.write(VERSION_MESSAGE)
            raise SystemExit(0)
        # -l / -f: consumed with their argument, no effect (reference
        # shortopts list them with no switch case, ntcard.cpp:69)

    if len(args) < 1:
        sys.stderr.write(f"{PROGRAM}: missing arguments\n")
        die = True
    if opt.gap != 0 and opt.k_list and (opt.gap % 2 != opt.k_list[0] % 2):
        sys.stderr.write(f"{PROGRAM}Gap size and kmer must have the same modulus\n")
        die = True
    if not opt.k_list:
        sys.stderr.write(f"{PROGRAM}: missing argument -k ... \n")
        die = True
    if not opt.prefix and not opt.output:
        sys.stderr.write(f"{PROGRAM}: missing argument -p/-o ... \n")
        die = True
    if opt.gap != 0 and len(opt.k_list) != 1:
        sys.stderr.write(f"{PROGRAM}: -g does not support multiple k currently.\n")
        die = True
    if die:
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        raise SystemExit(1)
    return opt, args


def gap_positions(opt) -> Optional[tuple]:
    """The masked positions of -g's seed '1'*(k-g)/2 + '0'*g + '1'*(k-g)/2
    (ntcard.cpp:407-413), or None without -g."""
    if opt.gap == 0:
        return None
    half = (opt.k_list[0] - opt.gap) // 2
    return tuple(range(half, half + opt.gap))


def select_wire(rows: int, chunk_len: int, stride: int):
    """The host-to-device wire format: the 2-bit quad2/quad wire when the
    geometry admits it, nibble otherwise; NTCARD_WIRE opts down. Returns
    (wire_fmt, use_quad, halo)."""
    from ntcard_tpu_torch.io.packing import quad2_ok, quad_ok

    wire_env = os.environ.get("NTCARD_WIRE", "quad2")
    if wire_env == "quad2" and quad2_ok(rows, stride):
        wire_fmt = "quad2"
    elif wire_env in ("quad", "quad2") and quad_ok(rows, chunk_len):
        wire_fmt = "quad"
    else:
        wire_fmt = True
    return wire_fmt, wire_fmt in ("quad", "quad2"), chunk_len - stride


def estimate_and_write(opt, state, metrics, stats, sketch, s_time, write_ok=True) -> int:
    """Estimate, output and the metrics epilogue of a run; only a process
    with ``write_ok`` writes the outputs (process 0 of a multi-host run)."""
    from ntcard_tpu_torch.models.estimate import comp_est_hist
    from ntcard_tpu_torch.output import write_compact, write_default

    ks = opt.k_list
    results = {}
    with metrics.phase("estimate"):
        for k in ks:
            f0, f = comp_est_hist(state[k]["hist"], opt.s_bits, opt.r_bits, opt.cov_max)
            results[k] = {"f1": state[k]["f1"], "f0": f0, "f": f}
    with metrics.phase("output"):
        if write_ok:
            if not opt.output:
                write_default(opt.prefix, ks, results, opt.cov_max)
            else:
                write_compact(opt.output, ks, results, opt.cov_max)
    metrics.add("reads", stats.get("records", 0))
    metrics.add("bases", stats.get("bases", 0))
    # (batch, k) updates that overflowed the compaction cap and took the
    # gated full-stream add: nonzero on repeat-heavy inputs
    metrics.add("overflow_replays", getattr(sketch, "replays", 0))
    metrics.report()
    sys.stderr.write(f"Runtime(sec): {time.monotonic() - s_time:.4f}\n")
    return 0


def run_devices(device, count: int, program: str) -> list:
    """The devices of a run (device.resolve_devices, shared by both CLIs);
    more cards than the machine has is exit status 1, never a run that
    drops the work of the missing ones."""
    from ntcard_tpu_torch.device import DeviceCountError, resolve_devices

    try:
        return resolve_devices(device, count)
    except DeviceCountError as e:
        raise SystemExit(f"{program}: {e}")


def hybrid_note(program: str, why: str) -> None:
    sys.stderr.write(f"{program}: NTCARD_ENGINE=hybrid ignored: {why}\n")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run ntcard. ``device``: None (or "cuda") counts on the local cards,
    the first --devices of them (every card for 0), and raises without
    CUDA; a sequence of devices (repeats allowed) counts on those, one
    private sketch each; any other one device ("cpu" runs the plain
    PyTorch versions of the kernels) counts on that device alone."""
    s_time = time.monotonic()
    opt, args = parse_args(sys.argv[1:] if argv is None else argv)
    devices = run_devices(device, opt.devices, PROGRAM)

    from ntcard_tpu_torch.io.decompress import input_size
    from ntcard_tpu_torch.io.readers import expand_file_args
    from ntcard_tpu_torch.parallel import multihost
    from ntcard_tpu_torch.pipeline import host_file_assignment

    in_files = expand_file_args(args)
    # <50 GB heuristic overrides -s after parsing (ntcard.cpp:427-431), over
    # the global input, so every host picks the same sBits
    total_size = sum(input_size(f) for f in in_files)
    if total_size < 50_000_000_000:
        opt.s_bits = 7
    launch = (
        opt.coordinator or None,
        opt.num_hosts or None,
        opt.host_id if opt.host_id >= 0 else None,
    )
    cfg = multihost.launch_config(*launch)
    if opt.save_sketch and cfg is not None and cfg[1] > 1:
        # every process would save its own partial sketch to the one path
        raise SystemExit(
            f"{PROGRAM}: --save-sketch in a multi-host run is not ported yet to ntcard_tpu_torch"
        )
    proc_id, n_procs = multihost.initialize_distributed(*launch, device_type=devices[0].type)
    try:
        if n_procs > 1:
            # one private sketch on the host's first device, over the host's
            # slice of the files; the processes merge at finalize
            devices = devices[:1]
            sizes = [input_size(f) for f in in_files]
            in_files = host_file_assignment(in_files, sizes, n_procs, proc_id)
        return _main_device(opt, in_files, total_size, s_time, devices, proc_id, n_procs)
    finally:
        multihost.shutdown_distributed()


def geometry(opt):
    """(chunk_len, stride) of the run's batches."""
    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.pipeline import default_geometry

    kmax = max(opt.k_list)
    chunk_len, _ = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    return chunk_len, aligned_stride(chunk_len, kmax)


def wire_batches(opt, in_files, stats: dict):
    """The run's decode + pack stream, as ntcard_tpu's device path makes it:
    (wire batches, stride, whether batches carry a wire-mode tag, halo)."""
    from ntcard_tpu_torch.pipeline import parallel_batches_from_files

    chunk_len, stride = geometry(opt)
    wire_fmt, use_quad, halo = select_wire(opt.batch_rows, chunk_len, stride)
    batches = parallel_batches_from_files(
        in_files, chunk_len, opt.batch_rows, max(opt.k_list), opt.n_thrd, stats_out=stats,
        wire_packed=wire_fmt,
    )
    return batches, stride, use_quad, halo


def _hybrid_host_sketch(opt, stride, private: bool):
    """The native host engine's sketch of an NTCARD_ENGINE=hybrid run, or
    None (with ntcard_tpu's note on stderr) where hybrid does not apply: a
    sketch per device or per host, or a host table too large to merge
    cheaply (ntcard_tpu/cli.py:663-697)."""
    if os.environ.get("NTCARD_ENGINE") != "hybrid":
        return None
    from ntcard_tpu_torch.models.host_engine import HostCountTableSketch

    host_table_bytes = len(opt.k_list) * 2 * (1 << opt.r_bits) * 2
    if not private:
        why = "sharded/multi-host sketches are device-only"
    elif host_table_bytes > int(os.environ.get("NTCARD_HYBRID_MAX_TABLE", 64 << 20)):
        why = (
            f"host table ({host_table_bytes >> 20} MB) exceeds "
            "NTCARD_HYBRID_MAX_TABLE (merge transfer would dominate)"
        )
    else:
        threads = int(os.environ.get("NTCARD_HYBRID_HOST_THREADS", "0"))
        return HostCountTableSketch(
            opt.k_list, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions(opt),
            n_threads=threads or max(1, (os.cpu_count() or 2) - 2),
        )
    hybrid_note(PROGRAM, why)
    return None


def _main_device(opt, in_files, total_size, s_time, devices, proc_id, n_procs) -> int:
    from ntcard_tpu_torch.io.packing import wire_mode_of
    from ntcard_tpu_torch.parallel.data_parallel import PerDeviceCountTableSketch
    from ntcard_tpu_torch.parallel.multihost import merged_finalize
    from ntcard_tpu_torch.pipeline import device_feed, hybrid_feed, parallel_batches_from_files
    from ntcard_tpu_torch.utils.metrics import Metrics

    metrics = Metrics(opt.metrics)
    stats: dict = {}
    chunk_len, stride = geometry(opt)
    sketch = PerDeviceCountTableSketch(
        opt.k_list, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions(opt),
        devices=devices,
    )
    host_sketch = _hybrid_host_sketch(opt, stride, private=len(devices) == 1 and n_procs == 1)
    with metrics.phase("pipeline"):
        if host_sketch is not None:
            # the device side takes raw code batches: the 2-bit wires exist
            # for a slow link, and a raw batch crosses PCIe in well under a ms
            raw = parallel_batches_from_files(
                in_files, chunk_len, opt.batch_rows, max(opt.k_list), opt.n_thrd,
                stats_out=stats,
            )
            est_batches = total_size / float(opt.batch_rows * stride)
            batches = hybrid_feed(raw, host_sketch.update, total_hint=est_batches)
        else:
            batches, _, use_quad, halo = wire_batches(opt, in_files, stats)
        with closing(device_feed(batches, sketch.devices)) as feed:
            for slot, batch in feed:
                if host_sketch is not None:
                    packed = False
                else:
                    packed = wire_mode_of(batch, opt.batch_rows, halo) if use_quad else True
                sketch.update(slot, batch, packed=packed)
        head = sketch.merged()
        if host_sketch is not None:
            head.merge_host_(host_sketch)
            metrics.tag("engine", "hybrid")
    if opt.save_sketch:
        head.save(opt.save_sketch)
    with metrics.phase("finalize"):
        state = merged_finalize(head, cov_max=opt.cov_max)
    if host_sketch is None:
        metrics.tag("engine", f"torch-{devices[0].type}")
    return estimate_and_write(opt, state, metrics, stats, head, s_time, write_ok=proc_id == 0)


if __name__ == "__main__":
    raise SystemExit(main())
