"""Histogram output writers, byte-identical to the reference's (the port's
copy of ntcard_tpu/output.py).

outDefault (ntcard.cpp:277-298): per-k ``<prefix>_k<k>.hist`` files with
``F1\\t``, ``F0\\t`` then ``i\\tf_i`` rows. outCompact (ntcard.cpp:300-315):
single ``k\\tf\\tn`` TSV with per-k F1/F0 on stderr as ``k=<k>\\t...``.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence


def write_default(prefix: str, ks: Sequence[int], results: Dict[int, dict], cov_max: int) -> None:
    for k in ks:
        r = results[k]
        with open(f"{prefix}_k{k}.hist", "w") as f:
            f.write(f"F1\t{r['f1']}\n")
            f.write(f"F0\t{to_u64(r['f0'])}\n")
            for i in range(1, cov_max + 1):
                f.write(f"{i}\t{to_u64(int(r['f'][i]))}\n")


def write_compact(path: str, ks: Sequence[int], results: Dict[int, dict], cov_max: int) -> None:
    with open(path, "w") as f:
        f.write("k\tf\tn\n")
        for k in ks:
            r = results[k]
            sys.stderr.write(f"k={k}\tF1\t{r['f1']}\n")
            sys.stderr.write(f"k={k}\tF0\t{to_u64(r['f0'])}\n")
            for i in range(1, cov_max + 1):
                f.write(f"{k}\t{i}\t{to_u64(int(r['f'][i]))}\n")


def to_u64(v: int) -> int:
    """The reference prints doubles through (uint64_t) casts; negative values
    wrap mod 2^64 (x86-64 behavior for in-range ssize_t values)."""
    return v & ((1 << 64) - 1)
