"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
on its own into ``_kernels_build/<digest>/lib<name>.so``; all sources are
compiled in parallel, one nvcc process each. ``<digest>`` hashes every
source and the flags, so an edited source can never load a stale library.
Nothing here includes PyTorch's headers: a plain C interface builds in
seconds, where a torch extension takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_kernels_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("ntcard_tpu_torch: nvcc not found (set CUDA_HOME)")


def build_all() -> Dict[str, Path]:
    """Compile every missing kernel library, all nvcc processes at once.
    Returns {name: path of lib<name>.so}; raises with nvcc's output when a
    source does not compile."""
    out_dir = _OUT / _digest()
    want = {p.stem: (p, out_dir / f"lib{p.stem}.so") for p in _sources()}
    missing = {n: sp for n, sp in want.items() if not sp[1].exists()}
    if missing:
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, (src, so) in missing.items():
            tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp,
                so,
            )
        errors = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                # ptxas' registers, shared memory and spills of each kernel
                so.with_suffix(".log").write_bytes(log)
                os.replace(tmp, so)  # atomic: concurrent builds race benignly
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: sp[1] for n, sp in want.items()}


def ptxas_report(name: str) -> str:
    """What ptxas said of ``csrc/<name>.cu`` when it was built: each
    kernel's registers, shared memory and spill bytes."""
    log = _OUT / _digest() / f"lib{name}.log"
    lines = log.read_text(errors="replace").splitlines() if log.exists() else []
    keep = ("registers", "spill", "smem")
    return "\n".join(line.split(": ")[-1].strip() for line in lines if any(w in line for w in keep))


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, building all at first use."""
    with _LOCK:
        if name not in _LIBS:
            for n, path in build_all().items():
                if n not in _LIBS:
                    _LIBS[n] = ctypes.CDLL(str(path))
        return _LIBS[name]


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong  # argtype shorthands


def fn(name: str, symbol: str, argtypes):
    """C function ``symbol`` of ``lib<name>.so`` with its argtypes declared
    (pointers and the stream as c_void_p, so ctypes never cuts them to 32
    bits) and an int (cudaError_t) result."""
    f = getattr(lib(name), symbol)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"ntcard_tpu_torch: {what} launch failed (cudaError {rc})")
