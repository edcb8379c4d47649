"""Merge saved sketch checkpoints on one device and write the histograms
(port of ntcard_tpu.tools.merge_sketches, same flags and messages).

    python -m ntcard_tpu_torch.tools.merge_sketches -p prefix [-c cov] s1.npz s2.npz ...

Sketches saved by either package load (they share the .npz format). The
tables are summed on the device (``CountTableSketch.merge_``) and the
finalize histogram runs in K4; the estimator and the writers are the
port's copies of ntcard_tpu's. Summing commutes, so the merge of partial
sketches equals one combined run bit for bit.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Merge on ``device``: None means CUDA (raises without it); "cpu" runs
    the plain PyTorch versions of the kernels."""
    args_in = sys.argv[1:] if argv is None else argv
    prefix, output, cov_max = "", "", 1000
    try:
        optlist, args = getopt.gnu_getopt(args_in, "p:o:c:", ["pref=", "output=", "cov="])
    except getopt.GetoptError as e:
        sys.stderr.write(f"merge_sketches: {e}\n")
        return 1
    for flag, val in optlist:
        if flag in ("-p", "--pref"):
            prefix = val
        elif flag in ("-o", "--output"):
            output = val
        elif flag in ("-c", "--cov"):
            cov_max = min(int(val), 65535)
    if not args or not (prefix or output):
        sys.stderr.write("usage: merge_sketches -p PREFIX|-o FILE [-c COV] SKETCH.npz...\n")
        return 1

    from ntcard_tpu_torch.device import resolve_device
    from ntcard_tpu_torch.models.estimate import comp_est_hist
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.output import write_compact, write_default

    dev = resolve_device(device)
    merged = CountTableSketch.load(args[0], device=dev)
    for path in args[1:]:
        merged.merge_(CountTableSketch.load(path, device=dev))
    state = merged.finalize(cov_max=cov_max)

    results = {}
    for k in merged.ks:
        f0, f = comp_est_hist(state[k]["hist"], merged.s_bits, merged.r_bits, cov_max)
        results[k] = {"f1": state[k]["f1"], "f0": f0, "f": f}
    if output:
        write_compact(output, merged.ks, results, cov_max)
    else:
        write_default(prefix, merged.ks, results, cov_max)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
