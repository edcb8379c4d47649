"""ntCard's statistical estimator (histogram inversion); the port's copy of
ntcard_tpu/models/estimate.py (comp_est_hist, estimate_f0).

Reproduces compEst (reference ntcard.cpp:237-275) with its exact float64
arithmetic, including the C cast quirks that shape the output:

* ``F0 = (ssize_t)((rBits*ln2 - ln p[0]) * 2^(sBits+rBits))`` — truncation
  toward zero, then used as a double downstream.
* the recursion for f_i runs on *raw* doubles; only afterwards is each value
  mapped through ``abs((ssize_t)(f_i * F0))``.
* guard: if ``p[0]*(ln p[0] - rBits*ln2) == 0`` every f_i is 0.

The recursion's inner sum is evaluated in the reference's exact order
(j ascending), so results are bit-identical; it is O(covMax^2) scalar work on
the host, in the native library. The counter-value histogram
(the only O(2^rBits) part) is K4's, on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _trunc(x: float) -> int:
    """C (ssize_t) cast: truncate toward zero; NaN/overflow -> INT64_MIN
    (x86-64 cvttsd2si behavior, what the reference binary compiles to)."""
    if math.isnan(x) or x >= 2**63 or x < -(2**63):
        return -(2**63)
    return int(x)


def comp_est_hist(
    p: np.ndarray, s_bits: int, r_bits: int, cov_max: int
) -> Tuple[int, np.ndarray]:
    """-> (F0, f[0..cov_max] int64 array; f[0] unused), from the
    counter-value histogram p[nSamp, 65536].

    f_i for i <= cov_max depends only on p[j], f_j for j <= i, so computing
    the recursion to cov_max (not the reference's fixed 65536) yields
    identical values for every emitted row."""
    n_samp = p.shape[0]
    p_mean = [0.0] * (cov_max + 1)
    for i in range(cov_max + 1):
        acc = 0.0
        for j in range(n_samp):
            acc += float(p[j][i])
        p_mean[i] = acc / (1.0 * n_samp)

    f0 = float(
        _trunc((r_bits * math.log(2) - math.log(p_mean[0])) * 1.0 * (1 << (s_bits + r_bits)))
        if p_mean[0] > 0
        else _trunc(math.inf)
    )
    f = np.zeros(cov_max + 1, dtype=np.int64)
    denom = p_mean[0] * (math.log(p_mean[0]) - r_bits * math.log(2)) if p_mean[0] > 0 else math.nan
    if denom == 0:
        return int(f0), f

    from ntcard_tpu_torch.native import f_recursion

    fm = f_recursion(p_mean, cov_max, denom, p_mean[0])
    for i in range(1, cov_max + 1):
        v = _trunc(float(fm[i]) * f0)
        # C++ abs(INT64_MIN) stays INT64_MIN (the reference's overflow path)
        f[i] = v if v == -(2**63) else abs(v)
    return int(f0), f


def estimate_f0(regs: np.ndarray, canon: bool = True) -> int:
    """HLL harmonic-mean estimate, nthll.cpp:247-260 bit-for-bit:
    left-to-right float64 harmonic sum, alpha halved for canonical hashing,
    final (unsigned long long) cast."""
    n_buck = regs.shape[0]
    alpha = 1.4426 / (1 + 1.079 / n_buck)
    if canon:
        alpha /= 2
    p_est = 0.0
    for v in regs:
        p_est += 1.0 / float(1 << int(v))
    z_est = 1.0 / p_est
    e_est = alpha * n_buck * n_buck * z_est
    return int(e_est)
