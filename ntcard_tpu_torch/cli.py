"""ntcard command line on one CUDA device (the port of ntcard_tpu.cli's
single-device path, _main_device_fast).

Same flags, messages (the engine notes of --help aside) and byte-identical
outputs as ``ntcard_tpu.cli``. The flag parser, the wire selection and the
estimate-and-write epilogue are the port's own copies of
ntcard_tpu/cli.py:19-313 (tests/test_torch_host.py holds the parser to the
original); decode and pack, the estimator and the writers are the port's
copies too (io/, native/, models/estimate.py, output.py). It
always runs the device path: the JAX package's engine routing rests on TPU
measurements and is not ported. What is not ported yet is refused with a
"not ported yet" message and exit status 1, never handed to another engine.

Run: ``python -m ntcard_tpu_torch.cli -k64,96,128 -p out reads.fq``
"""

from __future__ import annotations

import getopt
import os
import sys
import time
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
           \tN threads decode input files; one CUDA device counts.
  -k, --kmer=N\tthe length of kmer
  -g, --gap=N\tthe length of gap in the gap seed [0]. g mod 2 must equal k mod 2 unless g == 0
           \t-g does not support multiple k currently.
  -c, --cov=N\tthe maximum coverage of kmer in output [1000]
  -p, --pref=STRING    the prefix for output file name(s)
  -o, --output=STRING\tthe name for output file name (used when output should be a single file)
      --help\tdisplay this help and exit
      --version\toutput version information and exit

 Engine: one CUDA device, always (ntcard_tpu_torch does not route between
 engines). --devices > 1, multi-host runs and NTCARD_ENGINE=hybrid are not
 ported yet and exit with status 1. NTCARD_WIRE=quad2|quad|nibble picks the
 host-to-device wire format [quad2].

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
        # multi-host launch (refused: not ported yet)
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


def estimate_and_write(opt, state, metrics, stats, sketch, s_time) -> int:
    """Estimate, output and the metrics epilogue of a run."""
    from ntcard_tpu_torch.models.estimate import comp_est_hist
    from ntcard_tpu_torch.output import write_compact, write_default

    ks = opt.k_list
    results = {}
    with metrics.phase("estimate"):
        for k in ks:
            f0, f = comp_est_hist(state[k]["hist"], opt.s_bits, opt.r_bits, opt.cov_max)
            results[k] = {"f1": state[k]["f1"], "f0": f0, "f": f}
    with metrics.phase("output"):
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

    from ntcard_tpu_torch.io.decompress import input_size
    from ntcard_tpu_torch.io.readers import expand_file_args

    in_files = expand_file_args(args)
    # <50 GB heuristic overrides -s after parsing (ntcard.cpp:427-431)
    if sum(input_size(f) for f in in_files) < 50_000_000_000:
        opt.s_bits = 7
    return _main_device(opt, in_files, s_time, dev)


def wire_batches(opt, in_files, stats: dict):
    """The run's decode + pack stream, as ntcard_tpu's device path makes it:
    (wire batches, stride, whether batches carry a wire-mode tag, halo)."""
    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.pipeline import default_geometry, parallel_batches_from_files

    kmax = max(opt.k_list)
    chunk_len, _ = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    stride = aligned_stride(chunk_len, kmax)
    wire_fmt, use_quad, halo = select_wire(opt.batch_rows, chunk_len, stride)
    batches = parallel_batches_from_files(
        in_files, chunk_len, opt.batch_rows, kmax, opt.n_thrd, stats_out=stats,
        wire_packed=wire_fmt,
    )
    return batches, stride, use_quad, halo


def _main_device(opt, in_files, s_time, dev) -> int:
    from ntcard_tpu_torch.io.packing import wire_mode_of
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.pipeline import device_feed
    from ntcard_tpu_torch.utils.metrics import Metrics

    metrics = Metrics(opt.metrics)
    stats: dict = {}
    batches, stride, use_quad, halo = wire_batches(opt, in_files, stats)
    sketch = CountTableSketch(
        opt.k_list, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions(opt), device=dev
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
    return estimate_and_write(opt, state, metrics, stats, sketch, s_time)


if __name__ == "__main__":
    raise SystemExit(main())
