"""Native host layer (the port's copy of ntcard_tpu/native): C++ decode and
pack, the host engine and compEst's f_i recursion, built on demand with g++
and driven via ctypes. The port has no other decode path: when the library
does not build, get_lib() raises with the compiler's message
(tests/test_torch_host.py holds this copy's batches against the JAX
package's)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB = None
_LIB_ERROR: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The native decode library did not build or load."""


def _build_lib() -> ctypes.CDLL:
    # Build beside the kernels, in the package's gitignored _kernels_build/,
    # keyed on the source hash: a fresh checkout always compiles for the
    # local CPU and stale binaries can never be loaded. Portable codegen
    # (-mtune=generic, no -march=native). -ffp-contract=off keeps
    # ntcard_f_recursion's float64 evaluation bit-identical to the reference.
    src = _HERE / "packer.cpp"
    source = src.read_bytes()
    digest = hashlib.sha256(source).hexdigest()[:16]
    cache_dir = _HERE.parent / "_kernels_build" / "native"
    so = cache_dir / f"_packer_{digest}.so"
    if not so.exists():
        cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-mtune=generic", "-ffp-contract=off",
            "-shared", "-fPIC", "-std=c++17",
            "-o", str(tmp), str(src),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)  # atomic: concurrent builders race benignly
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"g++ failed on {src}:\n{e.stderr.decode(errors='replace')}")
        except (subprocess.SubprocessError, OSError) as e:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"could not build {src} with g++: {e}")
    lib = ctypes.CDLL(str(so))
    lib.packer_create.restype = ctypes.c_void_p
    lib.packer_create.argtypes = [ctypes.c_int] * 4
    lib.packer_destroy.argtypes = [ctypes.c_void_p]
    lib.packer_stride.restype = ctypes.c_int
    lib.packer_stride.argtypes = [ctypes.c_void_p]
    lib.packer_feed.restype = ctypes.c_long
    lib.packer_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.packer_end_file.restype = ctypes.c_long
    lib.packer_end_file.argtypes = [ctypes.c_void_p]
    lib.packer_flush.restype = ctypes.c_long
    lib.packer_flush.argtypes = [ctypes.c_void_p]
    lib.packer_pop.restype = ctypes.c_int
    lib.packer_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.packer_pop_packed.restype = ctypes.c_int
    lib.packer_pop_packed.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.packer_pop_quad.restype = ctypes.c_int
    lib.packer_pop_quad.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.packer_pop_quad2.restype = ctypes.c_int
    lib.packer_pop_quad2.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.packer_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ntcard_f_recursion.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ntcard_hist_u16_direct.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ntcard_host_update.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # codes
        ctypes.c_longlong,                # rows
        ctypes.c_longlong,                # row_len
        ctypes.c_longlong,                # stride
        ctypes.POINTER(ctypes.c_int32),   # ks
        ctypes.c_int,                     # nk
        ctypes.c_int,                     # s_bits
        ctypes.c_int,                     # r_bits
        ctypes.POINTER(ctypes.c_int32),   # mask_pos
        ctypes.c_int,                     # n_mask
        ctypes.POINTER(ctypes.c_uint16),  # table
        ctypes.POINTER(ctypes.c_longlong),  # f1
        ctypes.c_int,                     # nthreads
    ]
    lib.ntcard_host_hll_update.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    return lib


def hist_u16_direct(table: "np.ndarray"):
    """Threaded C histogram over a contiguous uint16 array (host-engine
    tables). Returns int64[65536]."""
    lib = get_lib()
    t = np.ascontiguousarray(table, dtype=np.uint16)
    out = np.zeros(65536, dtype=np.int64)
    lib.ntcard_hist_u16_direct(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        t.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    return out


def host_update(codes, stride, ks, s_bits, r_bits, table, f1, mask_positions=None,
                n_threads=0):
    """One host-engine batch step: hash+sample+count a [B, L] uint8 code batch
    into the uint16 [nk, 2*r_buck] table (relaxed-atomic, wraps mod 2^16) and
    int64 [nk] F1 accumulators."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    ks_arr = np.asarray(ks, dtype=np.int32)
    mask_arr = np.asarray(mask_positions or [], dtype=np.int32)
    lib.ntcard_host_update(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codes.shape[0],
        codes.shape[1],
        stride,
        ks_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ks_arr),
        s_bits,
        r_bits,
        mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(mask_arr),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        f1.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n_threads,
    )


def host_hll_update(codes, stride, k, n_bits, regs, n_threads=0):
    """One host-engine nthll batch step: max-merge clz runs of a [B, L] uint8
    code batch into the uint8 [2^n_bits] register array."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib.ntcard_host_hll_update(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codes.shape[0],
        codes.shape[1],
        stride,
        k,
        n_bits,
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )


def f_recursion(p_mean, cov_max: int, denom: float, p0: float):
    """C++ compEst f_i recursion; returns float64 fm[0..cov_max]."""
    lib = get_lib()
    p = np.ascontiguousarray(p_mean, dtype=np.float64)
    fm = np.zeros(cov_max + 1, dtype=np.float64)
    lib.ntcard_f_recursion(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cov_max,
        denom,
        p0,
        fm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return fm


def get_lib() -> ctypes.CDLL:
    """The native library, built at first use; raises NativeBuildError (every
    time) when it did not build."""
    global _LIB, _LIB_ERROR
    with _LOCK:
        if _LIB is None and _LIB_ERROR is None:
            try:
                _LIB = _build_lib()
            except (NativeBuildError, OSError) as e:
                _LIB_ERROR = str(e)
        if _LIB_ERROR is not None:
            raise NativeBuildError(
                f"the native decode library of ntcard_tpu_torch is required and did not "
                f"build (it needs g++): {_LIB_ERROR}")
        return _LIB


class NativePacker:
    """C++ decode+pack over raw decompressed byte streams."""

    def __init__(
        self,
        chunk_len: int,
        batch_rows: int,
        kmax: int,
        lenient: bool = False,
        wire_packed: bool = False,
    ):
        lib = get_lib()
        self._lib = lib
        self._h = lib.packer_create(chunk_len, batch_rows, kmax, int(lenient))
        self.chunk_len = chunk_len
        self.batch_rows = batch_rows
        self.stride = lib.packer_stride(self._h)
        # wire_packed: False = raw [B, L] codes; True/"nibble" = [B/2, L]
        # nibble wire; "quad" = [B/4 + B/64, L] 2-bit wire with delta-coded
        # N positions (io/packing.py's quad wire), falling back to nibble
        # per batch when the N count overflows the delta slots. All fused
        # in C — no numpy pass over the bases on the hot path.
        self.wire_packed = wire_packed

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.packer_destroy(h)
            self._h = None

    def _pop_all(self) -> Iterator[np.ndarray]:
        from ntcard_tpu_torch.io.packing import (
            quad2_ok,
            quad2_wire_rows,
            quad_ok,
            quad_wire_rows,
        )

        if self.wire_packed == "quad2" and quad2_ok(self.batch_rows, self.stride):
            q2rows = quad2_wire_rows(self.batch_rows)
            nrows = self.batch_rows // 2
            while True:
                out = np.empty((q2rows, self.stride), np.uint8)
                r = self._lib.packer_pop_quad2(self._h, out.ctypes.data_as(ctypes.c_void_p))
                if r == 0:
                    return
                if r < 0:  # sidecar overflow: same batch, nibble wire
                    out = np.empty((nrows, self.chunk_len), np.uint8)
                    if not self._lib.packer_pop_packed(
                        self._h, out.ctypes.data_as(ctypes.c_void_p)
                    ):
                        return
                yield out
            return
        quad = self.wire_packed == "quad" and quad_ok(self.batch_rows, self.chunk_len)
        if quad:
            qrows = quad_wire_rows(self.batch_rows)
            nrows = self.batch_rows // 2
            while True:
                out = np.empty((qrows, self.chunk_len), np.uint8)
                r = self._lib.packer_pop_quad(self._h, out.ctypes.data_as(ctypes.c_void_p))
                if r == 0:
                    return
                if r < 0:  # N overflow: same batch, nibble wire
                    out = np.empty((nrows, self.chunk_len), np.uint8)
                    if not self._lib.packer_pop_packed(
                        self._h, out.ctypes.data_as(ctypes.c_void_p)
                    ):
                        return
                yield out
            return
        if self.wire_packed:
            pop, rows = self._lib.packer_pop_packed, self.batch_rows // 2
        else:
            pop, rows = self._lib.packer_pop, self.batch_rows
        while True:
            out = np.empty((rows, self.chunk_len), np.uint8)
            if not pop(self._h, out.ctypes.data_as(ctypes.c_void_p)):
                return
            yield out

    def feed_bytes(self, data: bytes) -> Iterator[np.ndarray]:
        r = self._lib.packer_feed(self._h, data, len(data))
        if r < 0:
            raise ValueError("unrecognized input format")
        yield from self._pop_all()

    def end_file(self) -> Iterator[np.ndarray]:
        r = self._lib.packer_end_file(self._h)
        if r < 0:
            raise ValueError("unrecognized input format")
        yield from self._pop_all()

    def abort_file(self) -> None:
        """Reset per-file parser state after an error (skip-mode recovery);
        already-packed batches remain valid."""
        self._lib.packer_end_file(self._h)

    def flush(self) -> Iterator[np.ndarray]:
        self._lib.packer_flush(self._h)
        yield from self._pop_all()

    def stats(self):
        rec = ctypes.c_longlong()
        bases = ctypes.c_longlong()
        self._lib.packer_stats(self._h, ctypes.byref(rec), ctypes.byref(bases))
        return rec.value, bases.value
