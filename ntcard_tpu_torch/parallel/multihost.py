"""Multi-host runs over torch.distributed (the port of
ntcard_tpu/parallel/multihost.py).

Every process counts its own deterministic slice of the input files
(pipeline.host_file_assignment) into a private sketch on its host's first
device; the sketches merge once, at the end. Sums and maxes commute, so the
merged histograms and registers equal a single-process run over the union
of the inputs bit for bit.

The process group uses gloo for CPU tensors and, when the sketch is on a
card, NCCL for CUDA tensors ("cpu:gloo,cuda:nccl"): NCCL's communicator is
created only at the first CUDA collective, which only the device route of
:func:`merged_finalize` makes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ntcard_tpu_torch.ops.scatter import counter_hist


def launch_config(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[Tuple[str, int, int]]:
    """(coordinator "host:port", process count, this process's id) from the
    arguments, each missing one from NTCARD_COORDINATOR /
    NTCARD_NUM_PROCESSES / NTCARD_PROCESS_ID; None without a coordinator,
    which is a single-process run whatever else is set."""
    coordinator = coordinator or os.environ.get("NTCARD_COORDINATOR")
    if not coordinator:
        return None
    n = num_processes if num_processes is not None else int(os.environ["NTCARD_NUM_PROCESSES"])
    pid = process_id if process_id is not None else int(os.environ["NTCARD_PROCESS_ID"])
    return coordinator, n, pid


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> Tuple[int, int]:
    """Join the process group of a multi-host run (see :func:`launch_config`)
    and return (process id, process count); (0, 1) without a coordinator.
    ``device_type`` is where the sketch lives: "cuda" adds NCCL beside gloo."""
    cfg = launch_config(coordinator, num_processes, process_id)
    if cfg is None:
        return 0, 1
    coordinator, n, pid = cfg
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=n,
        rank=pid,
    )
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[P, *t.shape]: every process's ``t`` (same shape, device and type)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out)


def _finalize_reduce_scatter(sketch, nbins: int) -> torch.Tensor:
    """Device route of the cross-process merge: every sample row of every
    table is reduce-scattered along its buckets, so each process ends with
    its 1/P slice of the summed row ((P - 1)/P of a table crosses each link,
    and hist-of-sum != sum-of-hists rules out merging histograms alone);
    K4 histograms the owned [2, r_buck / P] rows per k, and the KB-scale
    histograms are summed. Nothing of table size reaches the host. Returns
    int32 [nK, 2, nbins] on the sketch's device."""
    procs = dist.get_world_size()
    r_buck, dev = sketch.r_buck, sketch.device
    hists = []
    for table in sketch.tables:
        owned = torch.empty((2, r_buck // procs), dtype=torch.int32, device=dev)
        for s in range(2):
            # the int32 sum is exact mod 2^32, and K4 reads it mod 2^16
            dist.reduce_scatter_tensor(owned[s], table[s * r_buck : (s + 1) * r_buck])
        hists.append(counter_hist(owned, nbins))
        del owned
    hist = torch.stack(hists)
    dist.all_reduce(hist)
    return hist


def merged_finalize(sketch, cov_max: int = 65535):
    """Cross-process finalize of a models.sketch.CountTableSketch: merge
    every process's private tables and F1s and return what
    CountTableSketch.finalize returns, identical on every process. A
    single-process call is the sketch's own finalize.

    Routing, as the JAX package's: the device route
    (:func:`_finalize_reduce_scatter`) for tables too large to gather (more
    than NTCARD_MULTIHOST_HOST_MAX bytes, 256 MB, over all processes); else
    the host route, which gathers the tables through gloo, sums them in
    int64, wraps them mod 2^16 and runs K4 on the sum. NTCARD_MULTIHOST_FINALIZE=host
    forces the host route, and so do a bucket count that the process count
    does not divide and nbins = 65536."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return sketch.finalize(cov_max=cov_max)
    procs = dist.get_world_size()
    f1_all = _all_gather(torch.tensor(sketch._f1_totals(), dtype=torch.int64)).sum(0)
    nbins = min(cov_max + 1, 65536)

    table_bytes = len(sketch.ks) * (2 * sketch.r_buck + 1) * 4
    small = table_bytes * procs <= int(os.environ.get("NTCARD_MULTIHOST_HOST_MAX", 256 << 20))
    use_host = (
        os.environ.get("NTCARD_MULTIHOST_FINALIZE", "host" if small else "") == "host"
        or sketch.r_buck % procs != 0
        or nbins >= 65536
    )
    if not use_host:
        hists = _finalize_reduce_scatter(sketch, nbins)
    else:
        local = torch.stack([t.cpu() for t in sketch.tables])
        merged = (_all_gather(local).sum(0, dtype=torch.int64) & 0xFFFF).to(torch.int32)
        rows = merged[:, : 2 * sketch.r_buck].reshape(len(sketch.ks), 2, sketch.r_buck)
        hists = torch.stack([counter_hist(r.to(sketch.device), nbins) for r in rows])
    hists = hists.cpu().numpy()
    return {
        k: {"hist": hists[i].astype(np.int64), "f1": int(f1_all[i])}
        for i, k in enumerate(sketch.ks)
    }


def merged_hll_registers(sketch) -> np.ndarray:
    """Cross-process HLL merge: the elementwise max of every process's
    uint8 registers (the lift of nthll's critical-section merge,
    nthll.cpp:238-244); a single process's own registers."""
    local = sketch.registers()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    regs = _all_gather(torch.from_numpy(local.astype(np.int32)))
    return regs.max(0).values.numpy().astype(np.uint8)
