#!/usr/bin/env python3
"""A/B of the port's redesigned hand kernels on one CUDA card.

    python3 tools/kernel_ab.py --parent DIR [--seed N]

DIR holds the earlier `compact.cu`, `sketch_idx.cu`, `hll_update.cu` and
`nthash.cuh` of `ntcard_tpu_torch/csrc`, as they were before K3 and K5 were
redesigned (for example `git archive <commit> ntcard_tpu_torch/csrc`
unpacked into a directory that .gitignore lists). The script builds them
with nvcc beside this checkout's kernels, checks both against the plain
versions on chip_smoke.py's phase-2 batch, and times them in turns
(earlier, this checkout, this checkout, earlier) by device time
(chip_smoke.device_ms), with the device events of each call by name:

* K1, 3 k at r27; K3 on the k64 r27 stream; the whole r > 16 table update
  of one k (earlier: K3, its -1 fill and zeroed count, the index_add_ into
  the dump row and the gated K2; now: K3 and the two gated K2 launches);
* K5 at k64, b16 and b10, repeated on one register array and from zeros,
  with two variants of this checkout's hll_update.cu made by text edits:
  "no floor" (no register-minima launch, every window reads its register)
  and "hash only" (no register read or atomic at all), which split its
  time into hash and register work.

The earlier sources' C interfaces are those of the kernels before the
redesign (ntc_compact without the scratch pair, ntc_hll_update without L
and the minima). Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "ntcard_tpu_torch" / "csrc"
OUT = ROOT / "ntcard_tpu_torch" / "_kernels_build" / "ab"
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def k5_variants(out: Path) -> dict:
    """This checkout's hll_update.cu without the floor, and without any
    register work, written into ``out`` beside a copy of nthash.cuh."""
    src = (CSRC / "hll_update.cu").read_text()
    launch = ("reg_min_kernel<<<n_partial, MIN_THREADS, 0, (cudaStream_t)stream>>>(\n"
              "        (const int*)regs, 1LL << n_bits, (int*)partial);")
    regstep = ("        int* reg = regs + (h & mask);\n"
               "        if (run0 > *(volatile int*)reg) atomicMax(reg, run0);\n    }\n}")
    first = "    u64 F, R;\n    int nn;\n    first_window"
    for piece in (launch, regstep, first, "const int floor = floor_s;"):
        if piece not in src:
            raise SystemExit(f"kernel_ab: hll_update.cu no longer holds {piece!r}")
    nofloor = src.replace("const int floor = floor_s;", "const int floor = -1;").replace(launch, "")
    hashonly = nofloor.replace(regstep, "        acc += run0 ^ (int)h;\n    }\n"
                               "    if (acc == 0x7fffffff) regs[0] = acc;  // keeps it live\n}")
    hashonly = hashonly.replace(first, "    int acc = 0;\n" + first)
    out.mkdir(parents=True, exist_ok=True)
    (out / "nthash.cuh").write_text((CSRC / "nthash.cuh").read_text())
    (out / "k5_nofloor.cu").write_text(nofloor)
    (out / "k5_hashonly.cu").write_text(hashonly)
    return {"k5_nofloor": out / "k5_nofloor.cu", "k5_hashonly": out / "k5_hashonly.cu"}


def build(srcs: dict) -> dict:
    """{name: loaded library}, one nvcc each, all at once; prints ptxas'
    registers and spills."""
    from ntcard_tpu_torch import _build

    nvcc = _build._nvcc()

    def one(item):
        name, src = item
        so = OUT / f"lib{name}.so"
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
        regs = [ln.split(": ")[-1].strip() for ln in (r.stdout + r.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  ptxas {name}: {'; '.join(regs)}")
        return name, ctypes.CDLL(str(so))

    with ThreadPoolExecutor(len(srcs)) as ex:
        return dict(ex.map(one, srcs.items()))


def by_kernel(fn, iters: int = 10) -> dict:
    """{device event name: ms per call of fn}, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            name = e.name.split("(")[0][:48]
            out[name] = out.get(name, 0.0) + t / 1e3 / iters
    return {k: round(v, 5) for k, v in out.items()}


def turns(label: str, earlier, now, iters: int = 20) -> None:
    """earlier, now, now, earlier, by device time."""
    import chip_smoke as cs

    a = [cs.device_ms(earlier, iters)]
    b = [cs.device_ms(now, iters), cs.device_ms(now, iters)]
    a.append(cs.device_ms(earlier, iters))
    print(f"  {label}: earlier {a[0]:.4f} / {a[1]:.4f} ms, now {b[0]:.4f} / {b[1]:.4f} ms")
    print(f"    earlier by kernel {by_kernel(earlier)}")
    print(f"    now by kernel {by_kernel(now)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier compact.cu, sketch_idx.cu, hll_update.cu, "
                         "nthash.cuh")
    ap.add_argument("--seed", type=int, default=0, help="seed of the code batch")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ntcard_tpu_torch import _build
    from ntcard_tpu_torch.io.packing import aligned_stride
    from ntcard_tpu_torch.models.sketch import emit_cap
    from ntcard_tpu_torch.ops import scatter as S
    from ntcard_tpu_torch.ops.hll import hll_update_, hll_update_plain
    from ntcard_tpu_torch.ops.rotations import device_seeds
    from ntcard_tpu_torch.ops.sketch_idx import _params, sketch_idx

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    for name in ("compact", "hll_update", "sketch_idx"):
        print(f"  ptxas {name} (now): " + "; ".join(_build.ptxas_report(name).splitlines()))
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = {f"earlier_{n}": args.parent / f"{n}.cu"
            for n in ("compact", "sketch_idx", "hll_update")}
    libs = build({**srcs, **k5_variants(OUT / "variants")})

    def stream(t):
        return _build.stream_ptr(t)

    rng = np.random.default_rng(args.seed)
    B, L, KS = cs.B, cs.L, cs.KS
    stride = aligned_stride(L, max(KS))
    codes = torch.from_numpy(np.ascontiguousarray(cs.random_codes(rng, B, L).T)).to(dev).T
    seeds = device_seeds(dev)

    # K1, 3 k at r27
    k1 = libs["earlier_sketch_idx"].ntc_sketch_idx
    k1.argtypes = [P, LL, LL, I, I, P, I, I, P, P, P, P, I, I, I, I, P, P]
    ks_t, _ = _params(dev, KS, ())
    out = torch.empty((len(KS), B, L), dtype=torch.int32, device=dev)

    def k1_earlier():
        if k1(codes.data_ptr(), codes.stride(0), codes.stride(1), B, L, ks_t.data_ptr(), len(KS),
              max(KS), seeds.data_ptr(), None, None, None, 0, stride, cs.S_BITS, 27,
              out.data_ptr(), stream(codes)):
            raise RuntimeError("earlier K1 launch failed")
        return out

    if not torch.equal(k1_earlier(), sketch_idx(codes, KS, stride, cs.S_BITS, 27)):
        raise AssertionError("K1: earlier and now disagree")
    turns("K1 3-k r27", k1_earlier, lambda: sketch_idx(codes, KS, stride, cs.S_BITS, 27))

    # K3 on the k64 r27 stream, and the whole r > 16 update of one k
    sent = 2 << 27
    flat = sketch_idx(codes, (64,), stride, cs.S_BITS, 27)[0].reshape(-1)
    cap = emit_cap(flat.numel())
    k3 = libs["earlier_compact"].ntc_compact
    k3.argtypes = [P, LL, I, P, I, P, P]

    def k3_earlier():
        vals = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        if k3(flat.data_ptr(), flat.numel(), sent, vals.data_ptr(), cap, count.data_ptr(),
              stream(flat)):
            raise RuntimeError("earlier K3 launch failed")
        return vals, count[0]

    (v, c), (ev, ec) = S.compact(flat, sent, cap), k3_earlier()
    if int(c) != int(ec) or not torch.equal(torch.sort(v).values, torch.sort(ev).values):
        raise AssertionError("K3: earlier and now disagree")
    print(f"  K3: {int(c)} survivors of {flat.numel()}, cap {cap}")
    turns("K3 k64 r27", k3_earlier, lambda: S.compact(flat, sent, cap))
    table = torch.zeros(sent + 1, dtype=torch.int32, device=dev)

    def update_earlier():
        vals, cnt = k3_earlier()
        over = cnt > cap
        slots = torch.where(over | (vals < 0), sent, vals).long()
        table.index_add_(0, slots, torch.ones_like(vals))
        S.table_add_(table, flat, sent, gate=over.to(torch.int32).reshape(1))

    def update_now():
        vals, cnt = S.compact(flat, sent, cap)
        over = (cnt > cap).to(torch.int32).reshape(1)
        S.table_add_(table, vals, sent, gate=1 - over)
        S.table_add_(table, flat, sent, gate=over)

    turns("r27 table update of one k", update_earlier, update_now)
    del table

    # K5 at k64: earlier, now, and now's two variants
    k5 = libs["earlier_hll_update"].ntc_hll_update
    k5.argtypes = [P, LL, LL, I, I, P, I, I, P, P]
    variants = {}
    for name in ("k5_nofloor", "k5_hashonly"):
        f = libs[name].ntc_hll_update
        f.argtypes = [P, LL, LL, I, I, I, P, I, I, P, P, P]
        variants[name] = f
    hstride = aligned_stride(L, 64)
    for n_bits in (16, 10):
        partial = torch.empty(256, dtype=torch.int32, device=dev)

        def k5_earlier(regs):
            if k5(codes.data_ptr(), codes.stride(0), codes.stride(1), B, 64, seeds.data_ptr(),
                  hstride, n_bits, regs.data_ptr(), stream(codes)):
                raise RuntimeError("earlier K5 launch failed")
            return regs

        def k5_variant(name, regs):
            if variants[name](codes.data_ptr(), codes.stride(0), codes.stride(1), B, L, 64,
                              seeds.data_ptr(), hstride, n_bits, regs.data_ptr(),
                              partial.data_ptr(), stream(codes)):
                raise RuntimeError(f"{name} launch failed")
            return regs

        def k5_now(regs):
            return hll_update_(regs, codes, 64, hstride, n_bits)

        zeros = torch.zeros(1 << n_bits, dtype=torch.int32, device=dev)
        want = hll_update_plain(zeros.clone(), codes, 64, hstride, n_bits)
        for name, got in (("earlier", k5_earlier(zeros.clone())), ("now", k5_now(zeros.clone())),
                          ("no floor", k5_variant("k5_nofloor", zeros.clone()))):
            if not torch.equal(got, want):
                raise AssertionError(f"K5 b{n_bits} ({name}) disagrees with the plain version")
        regs = want.clone()
        print(f"  K5 b{n_bits}: settled registers min {int(regs.min())}, max {int(regs.max())}")
        fill = cs.device_ms(lambda: regs.zero_(), 20)
        for label, base, less in (("repeated", lambda: regs, 0.0),
                                  ("from zeros", lambda: regs.zero_(), fill)):
            t = {
                "earlier": cs.device_ms(lambda: k5_earlier(base()), 20),
                "now": cs.device_ms(lambda: k5_now(base()), 20),
                "no floor": cs.device_ms(lambda: k5_variant("k5_nofloor", base()), 20),
                "hash only": cs.device_ms(lambda: k5_variant("k5_hashonly", base()), 20),
                "now again": cs.device_ms(lambda: k5_now(base()), 20),
                "earlier again": cs.device_ms(lambda: k5_earlier(base()), 20),
            }
            print(f"  K5 k64 b{n_bits} {label}: "
                  + ", ".join(f"{k} {v - less:.4f}" for k, v in t.items()) + " ms")
            print(f"    now by kernel {by_kernel(lambda: k5_now(base()))}")
        print(f"    (from zeros: less the {fill:.4f} ms zero fill before each call)")
    print("kernel_ab: every earlier and current kernel agreed with the plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
