"""The hand CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device: a CUDA kernel has no CPU mode, so without one
every test here skips with that reason (the plain versions are held
against the JAX package by tests/test_torch_{hash,scatter,sketch}.py). On a
machine with the card, which has no JAX, run them without the suite's
JAX-importing conftest:

    python -m pytest --noconftest -rs tests/test_torch_kernels_cuda.py

Imports nothing of JAX and nothing of ntcard_tpu. Tolerance 0: every
output is an integer.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

from ntcard_tpu_torch.io.packing import aligned_stride, pack_records  # noqa: E402
from ntcard_tpu_torch.models.hll import HllSketch  # noqa: E402
from ntcard_tpu_torch.models.sketch import CountTableSketch  # noqa: E402
from ntcard_tpu_torch.ops import scatter as S  # noqa: E402
from ntcard_tpu_torch.ops.hll import hll_update_, hll_update_plain  # noqa: E402
from ntcard_tpu_torch.ops.sketch_idx import sketch_idx, sketch_idx_plain  # noqa: E402


@pytest.fixture
def dev():
    # decided when the test runs, never at import (xdist workers must all
    # collect the same tests)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode (run on the H100)")
    return torch.device("cuda")


def _eq(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.cpu(), b.cpu())


def _codes(seed, B, L):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    c[rng.random((B, L)) < 0.01] = 4
    c[:, rng.integers(0, L, 3)] = 4
    return torch.from_numpy(c)


@pytest.mark.parametrize("ks,r_bits", [((12, 32), 10), ((64, 96, 128), 27), ((5,), 16)])
def test_sketch_idx(dev, ks, r_bits):
    B, L = 300, 256
    stride = ((L - max(ks) + 1) // 8) * 8
    codes = _codes(sum(ks), B, L).to(dev)
    want = sketch_idx_plain(codes, ks, stride, 7, r_bits)
    _eq(sketch_idx(codes, ks, stride, 7, r_bits), want)
    # the main path's position-major stream, passed as its transposed view
    _eq(sketch_idx(codes.T.contiguous().T, ks, stride, 7, r_bits), want)


@pytest.mark.parametrize(
    "B,L,ks,stride",
    [
        (70, 301, (64, 96), 301 - 95),  # L not a multiple of 4, 32 or the 256 tile
        (33, 300, (1,), 300),  # k = 1, every start owned
        (64, 1000, (12, 33, 128), 1000 - 127),  # stride + kmax - 1 = L
        (40, 520, (9, 100), 300),  # a short k beside one past three sub-blocks
        (40, 520, (221,), 300),  # k = L - stride + 1, remainder 29 past 6 sub-blocks
        (257, 1024, (64, 96, 128), 896),  # the main path's geometry, a partial row block
    ],
)
def test_sketch_idx_edges(dev, B, L, ks, stride):
    codes = _codes(L + B, B, L).to(dev)
    for r_bits in (27, 16):
        want = sketch_idx_plain(codes, ks, stride, 7, r_bits)
        _eq(sketch_idx(codes, ks, stride, 7, r_bits), want)
        _eq(sketch_idx(codes.T.contiguous().T, ks, stride, 7, r_bits), want)
        # a strided view with neither stride 1
        wide = torch.zeros((B, 2 * L), dtype=torch.uint8, device=dev)
        wide[:, ::2] = codes
        _eq(sketch_idx(wide[:, ::2], ks, stride, 7, r_bits), want)


def test_sketch_idx_codes_above_n(dev):
    """Codes above 4 hash as N (seed 0) but do not invalidate a window, as
    the plain version's lookup has it."""
    B, L, ks = 64, 400, (20, 64)
    codes = _codes(7, B, L)
    codes[torch.rand(B, L, generator=torch.Generator().manual_seed(0)) < 0.02] = 7
    codes = codes.to(dev)
    want = sketch_idx_plain(codes, ks, 320, 3, 16)
    _eq(sketch_idx(codes, ks, 320, 3, 16), want)


@pytest.mark.parametrize(
    "k,mask,r_bits",
    [(12, (5, 6), 10), (13, (4, 5, 6), 16), (64, (31, 32), 27), (64, tuple(range(26, 38)), 16)],
)
def test_sketch_idx_masked(dev, k, mask, r_bits):
    B, L = 300, 256
    stride = ((L - k + 1) // 8) * 8
    codes = _codes(k + len(mask), B, L).to(dev)
    want = sketch_idx_plain(codes, (k,), stride, 3, r_bits, mask)
    _eq(sketch_idx(codes, (k,), stride, 3, r_bits, mask), want)
    _eq(sketch_idx(codes.T.contiguous().T, (k,), stride, 3, r_bits, mask), want)
    # the unmasked launch after a masked one is unchanged
    plain = sketch_idx_plain(codes, (k,), stride, 3, r_bits)
    _eq(sketch_idx(codes, (k,), stride, 3, r_bits), plain)
    with pytest.raises(ValueError, match="single k"):
        sketch_idx(codes, (k, k + 1), stride, 3, r_bits, mask)


@pytest.mark.parametrize("k,n_bits", [(5, 10), (25, 16), (64, 16), (64, 10), (31, 20)])
def test_hll_update(dev, k, n_bits):
    B, L = 300, 256
    stride = ((L - k + 1) // 8) * 8
    codes = _codes(k + n_bits, B, L).to(dev)
    for view in (codes, codes.T.contiguous().T):
        base = torch.randint(0, 4, (1 << n_bits,), dtype=torch.int32, device=dev)
        before = hll_update_.launches
        got = hll_update_(base.clone(), view, k, stride, n_bits)
        assert hll_update_.launches == before + 1
        _eq(got, hll_update_plain(base.clone(), view, k, stride, n_bits))


@pytest.mark.parametrize("k", [1, 25, 33, 64])
@pytest.mark.parametrize("n_bits", [1, 10, 16, 20])
def test_hll_update_from_a_high_floor(dev, k, n_bits):
    """K5 skips every window whose run0 does not beat the least register;
    from a base whose least register is high, the windows that do beat
    theirs must still land, and a repeated launch must change nothing."""
    B, L = 300, 300
    stride = ((L - k + 1) // 8) * 8
    codes = _codes(k * n_bits, B, L).to(dev)
    gen = torch.Generator(device=dev).manual_seed(k + n_bits)
    for lo in (0, 3, 7):
        base = torch.randint(lo, lo + 3, (1 << n_bits,), generator=gen, device=dev,
                             dtype=torch.int32)
        want = hll_update_plain(base.clone(), codes, k, stride, n_bits)
        got = hll_update_(base.clone(), codes, k, stride, n_bits)
        _eq(got, want)
        _eq(hll_update_(got, codes, k, stride, n_bits), want)


@pytest.mark.parametrize("ks", [(31,), (32,), (33,), (63, 65), (1, 2, 3), (97, 128, 160)])
def test_sketch_idx_on_the_shared_tile(dev, ks):
    """K1 after its tile, sub-block hashes, first windows and roll tables
    moved into nthash.cuh beside K5: k just under, at and past multiples of
    the 32-base sub-block, at the main path's row length."""
    B, L = 100, 1024
    stride = ((L - max(ks) + 1) // 8) * 8
    codes = _codes(sum(ks), B, L).to(dev)
    for r_bits in (27, 16):
        _eq(sketch_idx(codes.T.contiguous().T, ks, stride, 7, r_bits),
            sketch_idx_plain(codes, ks, stride, 7, r_bits))


def test_hll_sketch_on_the_card_equals_cpu(dev):
    rng = np.random.default_rng(6)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=300)) for _ in range(200)]
    stride = aligned_stride(160, 25)
    regs = []
    for d in (dev, torch.device("cpu")):
        sk = HllSketch(25, 12, stride, device=d)
        for b in pack_records(recs, 160, 128, 25):
            sk.update(torch.from_numpy(b).to(d))
        regs.append(sk.registers())
    np.testing.assert_array_equal(regs[0], regs[1])


def test_hist_add(dev):
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(-2, 2 * 1024 + 2, 100_000).astype(np.int32)).to(dev)
    zeros = torch.zeros(2049, dtype=torch.int32, device=dev)
    _eq(S.hist_add(idx, 10), S.table_add_plain(zeros, idx, 2048))
    table = torch.arange(2049, dtype=torch.int32, device=dev)
    want = S.table_add_plain(table.clone(), idx, 2048)
    _eq(S.hist_add(idx, 10, out=table), want)
    with pytest.raises(ValueError):
        S.hist_add(idx, 17)


@pytest.mark.parametrize("cap,density", [(1024, 0.01), (256, 0.5)])
def test_compact(dev, cap, density):
    rng = np.random.default_rng(2)
    sent = 1 << 27
    idx = np.full(50_000, sent, np.int32)
    m = rng.random(idx.size) < density
    idx[m] = rng.integers(0, sent, m.sum())
    idx[:3] = [sent + 1, -1, sent - 1]
    t = torch.from_numpy(idx).to(dev)
    (v, c), (pv, pc) = S.compact(t, sent, cap), S.compact_plain(t, sent, cap)
    assert int(c) == int(pc) == m.sum() - (m[:3].sum()) + 1
    if int(c) <= cap:
        _eq(torch.sort(v).values, torch.sort(pv).values)
    else:  # overflow: the cap is filled, never overrun
        assert int((v >= 0).sum()) == cap


def _stream(rng, length, n_surv, sent):
    """S0/S1 sentinels with n_surv distinct survivors at random places."""
    x = np.full(length, sent, np.int32)
    x[rng.random(length) < 0.05] = sent + 1
    x[rng.choice(length, n_surv, replace=False)] = rng.choice(sent, n_surv, replace=False)
    return x


@pytest.mark.parametrize(
    "case", ["4m + 1", "offset 1", "offset 3, 4m + 2", "three at an offset", "empty", "none",
             "cap", "cap + 1", "all, cap of them", "all, past cap"]
)
def test_compact_edges(dev, case):
    """K3 at the edges of its contract, each launched twice (its scratch
    counter must be back at 0): unaligned starts and lengths, no survivor,
    exactly cap, cap + 1, all survivors. An overflowed buffer holds cap
    distinct survivors and no -1."""
    rng = np.random.default_rng(len(case))
    sent, cap, n = 1 << 20, 1024, 200_003
    x = torch.from_numpy(_stream(rng, n, 900, sent)).to(dev)
    every = torch.arange(n, dtype=torch.int32, device=dev)
    views = {
        "4m + 1": x[: n - 2],
        "offset 1": x[1:],
        "offset 3, 4m + 2": x[3: n - 2],
        "three at an offset": x[1:4],
        "empty": x[:0],
        "none": torch.from_numpy(_stream(rng, n, 0, sent)).to(dev),
        "cap": torch.from_numpy(_stream(rng, n, cap, sent)).to(dev),
        "cap + 1": torch.from_numpy(_stream(rng, n, cap + 1, sent)).to(dev),
        "all, cap of them": every[:cap],
        "all, past cap": every,
    }
    t = views[case]
    pv, pc = S.compact_plain(t, sent, cap)
    for _ in range(2):
        v, c = S.compact(t, sent, cap)
        assert int(c) == int(pc)
        if int(c) <= cap:
            _eq(torch.sort(v).values, torch.sort(pv).values)
        else:
            kept = t[(t >= 0) & (t < sent)]
            assert bool(torch.isin(v, kept).all()) and torch.unique(v).numel() == cap


@pytest.mark.parametrize("nbins", [1, 65, 1001, 58112, 65536])
def test_counter_hist(dev, nbins):
    rng = np.random.default_rng(nbins)
    rows = rng.integers(0, 1 << 18, (2, 200_000)).astype(np.int32)
    rows[:, ::3] = 0
    rows[:, 1::7] = 65536 * 2
    t = torch.from_numpy(rows).to(dev)
    _eq(S.counter_hist(t, nbins), S.counter_hist_plain(t, nbins))


@pytest.mark.parametrize("nbins", [1, 65, 1001, 58112, 65536])
@pytest.mark.parametrize("row_len,offset", [(200_003, 0), (200_000, 1), (7, 3), (1, 0)])
def test_counter_hist_unaligned(dev, nbins, row_len, offset):
    """A row length that is not a multiple of 4, and rows whose start is not
    16-byte aligned (a contiguous view at an offset of 1 or 3 elements)."""
    rng = np.random.default_rng(row_len + offset)
    flat = rng.integers(0, 1 << 17, 3 * row_len + offset).astype(np.int32)
    flat[::5] = 0
    base = torch.from_numpy(flat).to(dev)
    rows = base[offset:offset + 3 * row_len].view(3, row_len)
    assert rows.is_contiguous()
    _eq(S.counter_hist(rows, nbins), S.counter_hist_plain(rows, nbins))


def test_overflow_add(dev):
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(-3, 515, 100_000).astype(np.int32)).to(dev)
    base = torch.from_numpy(rng.integers(0, 9, 513).astype(np.int32)).to(dev)
    for f in (0, 1):
        flag = torch.full((1,), f, dtype=torch.int32, device=dev)
        _eq(S.table_add_(base.clone(), idx, 512, gate=flag),
            S.table_add_plain(base.clone(), idx, 512, gate=flag))


@pytest.mark.parametrize("r_bits", [16, 18])
def test_sketch_on_the_card_equals_cpu(dev, r_bits):
    """The whole update and finalize on the card equals the CPU sketch,
    including a batch that overflows the compaction cap at r18."""
    rng = np.random.default_rng(5)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=300)) for _ in range(200)]
    recs.append(b"ACGTTGCA" * 3000)  # periodic: repeat-heavy windows
    ks, stride = (8, 12), aligned_stride(128, 12)
    out = []
    for d in (dev, torch.device("cpu")):
        sk = CountTableSketch(ks, 1, r_bits, stride, device=d)  # s_bits=1: dense sampling
        for b in pack_records(recs, 128, 128, 12):
            sk.update(torch.from_numpy(b).to(d))
        out.append((sk.finalize(return_table=True, cov_max=300), sk.replays))
    (gpu, g_over), (cpu, c_over) = out
    assert g_over == c_over
    if r_bits > 16:
        assert g_over >= 1
    for k in ks:
        assert gpu[k]["f1"] == cpu[k]["f1"]
        np.testing.assert_array_equal(gpu[k]["table"], cpu[k]["table"])
        np.testing.assert_array_equal(gpu[k]["hist"], cpu[k]["hist"])


@pytest.mark.parametrize("r_bits", [17, 18])
@pytest.mark.parametrize("overflow", [False, True])
def test_cap_buffer_sketch_on_the_card_equals_cpu(dev, r_bits, overflow):
    """r > 16 on the card (K3, K2 over the cap buffer, K2 gated over the
    stream) equals the CPU sketch at the default sampling, with and without
    a batch that overflows the cap, on everything finalize reads."""
    rng = np.random.default_rng(r_bits)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=400)) for _ in range(300)]
    if overflow:  # one 8-mer repeated: every window of the record is sampled at s_bits 1
        recs.insert(0, b"ACGTTGCA" * 3000)
    ks, stride = (8, 12), aligned_stride(128, 12)
    s_bits = 1 if overflow else 7
    out = []
    for d in (dev, torch.device("cpu")):
        sk = CountTableSketch(ks, s_bits, r_bits, stride, device=d)
        for b in pack_records(recs, 128, 128, 12):
            sk.update(torch.from_numpy(b).to(d))
        out.append((sk.finalize(return_table=True, cov_max=300), sk.replays))
    (gpu, g_over), (cpu, c_over) = out
    assert g_over == c_over and (g_over >= 1) == overflow
    for k in ks:
        assert gpu[k]["f1"] == cpu[k]["f1"]
        np.testing.assert_array_equal(gpu[k]["table"], cpu[k]["table"])
        np.testing.assert_array_equal(gpu[k]["hist"], cpu[k]["hist"])


@pytest.mark.parametrize("r_bits", [16, 18])
def test_two_private_sketches_on_one_card_equal_one(dev, r_bits):
    """Two private sketches on the one card (the batches in turn through
    device_feed's pinned rings, each on its slot's stream), folded, and a
    host-engine share merged in (the hybrid merge) equal the CPU sketch of
    every batch."""
    from ntcard_tpu_torch.models.host_engine import HostCountTableSketch
    from ntcard_tpu_torch.parallel.data_parallel import PerDeviceCountTableSketch
    from ntcard_tpu_torch.pipeline import device_feed

    rng = np.random.default_rng(r_bits + 1)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=400)) for _ in range(300)]
    ks, stride = (8, 12), aligned_stride(128, 12)
    batches = list(pack_records(recs, 128, 128, 12))
    cpu = CountTableSketch(ks, 7, r_bits, stride, device="cpu")
    for b in batches:
        cpu.update(torch.from_numpy(b))
    two = PerDeviceCountTableSketch(ks, 7, r_bits, stride, devices=["cuda:0", "cuda:0"])
    for slot, b in device_feed(iter(batches[1:]), two.devices):
        assert b.is_cuda
        two.update(slot, b)
    host = HostCountTableSketch(ks, 7, r_bits, stride)
    host.update(batches[0])
    head = two.merged()
    head.merge_host_(host)
    gpu, want = head.finalize(return_table=True, cov_max=300), cpu.finalize(return_table=True, cov_max=300)
    for k in ks:
        assert gpu[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(gpu[k]["table"], want[k]["table"])
        np.testing.assert_array_equal(gpu[k]["hist"], want[k]["hist"])


def test_two_private_hll_sketches_on_one_card_equal_one(dev):
    from ntcard_tpu_torch.parallel.data_parallel import PerDeviceHllSketch
    from ntcard_tpu_torch.pipeline import device_feed

    stride = aligned_stride(128, 25)
    rng = np.random.default_rng(9)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=400)) for _ in range(300)]
    batches = list(pack_records(recs, 128, 128, 25))
    cpu = HllSketch(25, 12, stride, device="cpu")
    for b in batches:
        cpu.update(torch.from_numpy(b))
    two = PerDeviceHllSketch(25, 12, stride, devices=["cuda:0", "cuda:0"])
    for slot, b in device_feed(iter(batches), two.devices):
        two.update(slot, b)
    np.testing.assert_array_equal(two.registers(), cpu.registers())
