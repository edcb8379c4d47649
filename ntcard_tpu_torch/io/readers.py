"""Input file arguments (the port's copy of expand_file_args from
ntcard_tpu/io/readers.py). Format sniffing and record parsing (FASTQ, FASTA,
SAM; ntcard.cpp:105-235) run in the native packer,
ntcard_tpu_torch/native/packer.cpp."""

from __future__ import annotations


def expand_file_args(args) -> list:
    """'@list' arguments expand to one path per line of the list file
    (ntcard.cpp:415-425). Every line is taken verbatim (even empty ones,
    which later fail to open — matching the reference)."""
    paths = []
    for a in args:
        if a.startswith("@"):
            with open(a[1:], "r") as fh:
                for line in fh:
                    paths.append(line.rstrip("\n"))
        else:
            paths.append(a)
    return paths
