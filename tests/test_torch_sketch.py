"""The port's CountTableSketch (ntcard_tpu_torch.models.sketch) on the CPU
against the JAX CountTableSketch: tables, counter histograms and F1, bit for
bit, on both sides of the hist/compact boundary (r16 | r17), through the
compaction overflow, and across save/load in both directions."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

from ntcard_tpu.io.packing import aligned_stride, pack_records, pack_wire, wire_mode_of  # noqa: E402
from ntcard_tpu.models.sketch import CountTableSketch as JaxSketch  # noqa: E402
from ntcard_tpu.ops import nthash_ref as R  # noqa: E402
from ntcard_tpu_torch.models.sketch import CountTableSketch  # noqa: E402

KS, S_BITS = (8, 12), 7
ROWS, CHUNK = 256, 139  # quad2-admissible: stride 128, halo 11
STRIDE = aligned_stride(CHUNK, max(KS))


def _records(seed, n=120):
    """Random records with a sparse N run in some (short records too)."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(5, 900)))]
        if len(r) > 20 and rng.random() < 0.1:
            s = int(rng.integers(0, len(r) - 10))
            r[s : s + int(rng.integers(1, 10))] = ord("N")
        recs.append(r.tobytes())
    return recs


def _jax_state(monkeypatch, batches, r_bits, ks=KS, stride=STRIDE, cov_max=200, scatter=True):
    if scatter:
        monkeypatch.setenv("NTCARD_SCATTER", "pallas-interpret")
    else:
        monkeypatch.delenv("NTCARD_SCATTER", raising=False)
    jax.clear_caches()  # the update trace bakes the scatter mode in
    try:
        sk = JaxSketch(ks, S_BITS, r_bits, stride)
        for b in batches:
            sk.update(b)
        return sk.finalize(return_table=True, cov_max=cov_max)
    finally:
        monkeypatch.delenv("NTCARD_SCATTER", raising=False)
        jax.clear_caches()


def _assert_same(got, want, ks=KS):
    for k in ks:
        assert got[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(got[k]["table"], want[k]["table"])
        np.testing.assert_array_equal(got[k]["hist"], want[k]["hist"])
        assert got[k]["hist"].dtype == np.int64


@pytest.mark.parametrize("r_bits", [10, 16, 17, 18])
def test_sketch_matches_jax(monkeypatch, r_bits):
    """K2 updates r10/r16, K3 + scatter r17/r18. The port is fed the quad2
    wire the CLI sends (nibble where a batch's sidecar overflows), JAX the
    raw code batches."""
    batches = list(pack_records(_records(r_bits), CHUNK, ROWS, max(KS)))
    want = _jax_state(monkeypatch, batches, r_bits)
    sk = CountTableSketch(KS, S_BITS, r_bits, STRIDE, device="cpu")
    modes = []
    for b in batches:
        w = pack_wire(b, "quad2", STRIDE)
        modes.append(wire_mode_of(w, ROWS, CHUNK - STRIDE))
        sk.update(torch.from_numpy(w), packed=modes[-1])
    assert modes[0].startswith("quad2")
    _assert_same(sk.finalize(return_table=True, cov_max=200), want)
    assert sk.replays == 0


# the overflow-forcing input of tests/test_overflow_replay.py
K8, R18 = 8, 18
OCHUNK, OROWS = 128, 128
OSTRIDE = aligned_stride(OCHUNK, K8)  # cap 256 at this geometry


def _overflow_records():
    rng = np.random.default_rng(99)
    smask = (1 << (S_BITS - 1)) - 1
    while True:
        s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=K8))
        hi = R.ntc64(R.seq_to_codes(s), K8) >> 32
        if (hi >> (31 - S_BITS)) == 1 or (hi >> (32 - S_BITS)) == smask:
            break
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    return [s * 600] + [bytes(rng.choice(alphabet, size=200)) for _ in range(20)]


def test_overflow_forcing_input_is_exact(monkeypatch):
    """A periodic sampled k-mer overflows the compaction cap; the gated
    full-stream add must make the tables equal to the plain XLA scatter."""
    batches = list(pack_records(_overflow_records(), OCHUNK, OROWS, K8))
    want = _jax_state(monkeypatch, batches, R18, ks=(K8,), stride=OSTRIDE, scatter=False)
    sk = CountTableSketch((K8,), S_BITS, R18, OSTRIDE, device="cpu")
    for b in batches:
        sk.update(torch.from_numpy(b))
    assert sk.replays >= 1  # the overflow path actually ran
    _assert_same(sk.finalize(return_table=True, cov_max=200), want, ks=(K8,))


def _survivors(batch, ks, stride, r_bits):
    """K3's true count of each k's emit stream of one code batch."""
    from ntcard_tpu_torch.models.sketch import emit_cap
    from ntcard_tpu_torch.ops.scatter import compact_plain
    from ntcard_tpu_torch.ops.sketch_idx import sketch_idx_plain

    idx = sketch_idx_plain(torch.from_numpy(batch), ks, stride, S_BITS, r_bits)
    sent = 2 << r_bits
    return [int(compact_plain(i, sent, emit_cap(i.numel()))[1]) for i in idx]


@pytest.mark.parametrize("r_bits", [17, 18])
def test_cap_buffer_update_with_no_survivors_matches_jax(monkeypatch, r_bits):
    """r > 16 adds K3's cap buffer through the gated K2. A first batch whose
    windows all hold an N leaves no survivor (a buffer of -1 slots only);
    normal batches follow. Everything finalize reads equals JAX's."""
    empty = list(pack_records([b"N" * 700] * 40, CHUNK, ROWS, max(KS)))
    assert _survivors(empty[0], KS, STRIDE, r_bits) == [0, 0]
    batches = empty + list(pack_records(_records(r_bits + 40), CHUNK, ROWS, max(KS)))
    want = _jax_state(monkeypatch, batches, r_bits)
    sk = CountTableSketch(KS, S_BITS, r_bits, STRIDE, device="cpu")
    for b in batches:
        sk.update(torch.from_numpy(b))
    assert sk.replays == 0
    _assert_same(sk.finalize(return_table=True, cov_max=200), want)


@pytest.mark.parametrize("r_bits", [17, 18])
def test_overflow_then_cap_buffer_matches_jax(monkeypatch, r_bits):
    """An overflowing batch (the gated full-stream add) and then batches that
    fit the cap (the gated buffer add), against JAX's Pallas compaction with
    its drop-mode scatter and host replay."""
    over = list(pack_records(_overflow_records(), OCHUNK, OROWS, K8))
    assert _survivors(over[0], (K8,), OSTRIDE, r_bits)[0] > 256  # the cap here
    rest = list(pack_records(_records(r_bits), OCHUNK, OROWS, K8))
    batches = over + rest
    want = _jax_state(monkeypatch, batches, r_bits, ks=(K8,), stride=OSTRIDE)
    sk = CountTableSketch((K8,), S_BITS, r_bits, OSTRIDE, device="cpu")
    for b in batches:
        sk.update(torch.from_numpy(b))
    assert 1 <= sk.replays < len(batches)
    _assert_same(sk.finalize(return_table=True, cov_max=200), want, ks=(K8,))


def test_save_load_both_ways(monkeypatch, tmp_path):
    """The .npz checkpoint is the JAX package's format: a port sketch loads
    in ntcard_tpu and a ntcard_tpu sketch loads in the port."""
    batches = list(pack_records(_records(3), CHUNK, ROWS, max(KS)))
    port = CountTableSketch(KS, S_BITS, 16, STRIDE, device="cpu")
    for b in batches:
        port.update(torch.from_numpy(b))
    port_state = port.finalize(return_table=True, cov_max=200)

    port.save(str(tmp_path / "port.npz"))
    _assert_same(JaxSketch.load(str(tmp_path / "port.npz")).finalize(True, 200), port_state)
    _assert_same(CountTableSketch.load(str(tmp_path / "port.npz"), device="cpu").finalize(True, 200), port_state)

    monkeypatch.delenv("NTCARD_SCATTER", raising=False)
    js = JaxSketch(KS, S_BITS, 16, STRIDE)
    for b in batches:
        js.update(b)
    js.save(str(tmp_path / "jax.npz"))
    _assert_same(CountTableSketch.load(str(tmp_path / "jax.npz"), device="cpu").finalize(True, 200), port_state)


def test_merge_equals_one_pass():
    recs = _records(5)
    whole = CountTableSketch(KS, S_BITS, 12, STRIDE, device="cpu")
    a = CountTableSketch(KS, S_BITS, 12, STRIDE, device="cpu")
    b = CountTableSketch(KS, S_BITS, 12, STRIDE, device="cpu")
    for batch in pack_records(recs, CHUNK, ROWS, max(KS)):
        whole.update(torch.from_numpy(batch))
    for part, sk in ((recs[:60], a), (recs[60:], b)):
        for batch in pack_records(part, CHUNK, ROWS, max(KS)):
            sk.update(torch.from_numpy(batch))
    a.merge_(b)
    _assert_same(a.finalize(True, 200), whole.finalize(True, 200))
    with pytest.raises(ValueError):
        a.merge_(CountTableSketch(KS, S_BITS, 12, STRIDE + 8, device="cpu"))


@pytest.mark.parametrize("make", ["CountTableSketch", "CountTableSketch.load", "HllSketch"])
def test_default_device_without_cuda_raises(monkeypatch, tmp_path, make):
    """The sketches are library entry points: without ``device`` they run on
    CUDA, and without CUDA they raise rather than carry on on the CPU."""
    from ntcard_tpu_torch.models.hll import HllSketch

    path = str(tmp_path / "s.npz")
    CountTableSketch(KS, S_BITS, 12, STRIDE, device="cpu").save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "CountTableSketch": lambda: CountTableSketch(KS, S_BITS, 12, STRIDE),
        "CountTableSketch.load": lambda: CountTableSketch.load(path),
        "HllSketch": lambda: HllSketch(25, 10, STRIDE),
    }[make]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
