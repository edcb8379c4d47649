"""nthll command line on one CUDA device (the port of ntcard_tpu.cli_hll's
single-device path).

Same flags, messages and output as ``ntcard_tpu.cli_hll``; the getopt spec
and the usage and version texts are the port's copies of
ntcard_tpu/cli_hll.py:12-44. It always runs the device path: the JAX
package's engine routing rests on TPU measurements and is not ported. It
uses the one device it is given. Multi-host runs and NTCARD_ENGINE=hybrid are
refused with a "not ported yet" message and exit status 1.

Run: ``python -m ntcard_tpu_torch.cli_hll -k25 reads.fq``
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

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

from ntcard_tpu_torch.cli import unported_env


def device_registers(in_files, km_len: int, n_bits: int, n_thrd: int, dev):
    """The uint8 HLL registers of ``in_files`` at k = ``km_len``, counted on
    ``dev``. nthll skips unreadable files and sniffs formats leniently
    (nthll.cpp:70-90, 225-235); -t fans decode threads over files."""
    from ntcard_tpu_torch.cli import select_wire
    from ntcard_tpu_torch.io.packing import aligned_stride, wire_mode_of
    from ntcard_tpu_torch.models.hll import HllSketch
    from ntcard_tpu_torch.pipeline import (
        default_geometry,
        device_feed,
        parallel_batches_from_files,
    )

    chunk_len, batch_rows = default_geometry(km_len)
    stride = aligned_stride(chunk_len, km_len)
    wire_fmt, use_quad, halo = select_wire(batch_rows, chunk_len, stride)
    sketch = HllSketch(km_len, n_bits, stride, device=dev)
    batches = parallel_batches_from_files(
        in_files, chunk_len, batch_rows, km_len, n_thrd,
        lenient=True, on_error="skip", wire_packed=wire_fmt,
    )
    for batch in device_feed(batches, dev):
        sketch.update(batch, packed=wire_mode_of(batch, batch_rows, halo) if use_quad else True)
    return sketch.registers()


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run nthll on ``device``: None means CUDA (raises without it); "cpu"
    runs the plain PyTorch version of the kernel."""
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
    why = unported_env()
    if why:
        raise SystemExit(f"{PROGRAM}: {why} is not ported yet to ntcard_tpu_torch")

    from ntcard_tpu_torch.device import resolve_device
    from ntcard_tpu_torch.io.readers import expand_file_args
    from ntcard_tpu_torch.models.estimate import estimate_f0

    dev = resolve_device(device)
    regs = device_registers(expand_file_args(args), km_len, n_bits, n_thrd, dev)
    f0 = estimate_f0(regs, canon=True)
    sys.stdout.write(f"F0, Exp# of distnt kmers(k={km_len}): {f0}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
