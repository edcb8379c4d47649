"""Spaced seeds (ntcard -g) in the port on the CPU, against the JAX package
and the scalar oracle (tolerance 0: every output is an integer).

The masked window hashes, K1's plain version with a mask (what
ntcard_tpu_torch.ops.sketch_idx.sketch_idx runs on a CPU tensor), the gap
sketch, the port CLI's -g2 golden, and gap checkpoints across the two
packages.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import jax.numpy as jnp  # noqa: E402

from ntcard_tpu.io.packing import aligned_stride, pack_records, pack_wire, wire_mode_of  # noqa: E402
from ntcard_tpu.models.sketch import CountTableSketch as JaxSketch  # noqa: E402
from ntcard_tpu.ops import nthash as jnt  # noqa: E402
from ntcard_tpu.ops import nthash_ref as R  # noqa: E402
from ntcard_tpu_torch import cli  # noqa: E402
from ntcard_tpu_torch.models.sketch import CountTableSketch  # noqa: E402
from ntcard_tpu_torch.ops import nthash as tnt  # noqa: E402
from ntcard_tpu_torch.ops.sketch_idx import sketch_idx, sketch_idx_plain  # noqa: E402
from ntcard_tpu_torch.ops.u64 import to_u64  # noqa: E402

DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"

# (k, masked positions): odd and even k, the -g2 seed of k12 and k64, and
# the 12-position gap of k64 (ntcard_tpu.cli._gap_positions)
MASKS = [(12, (5, 6)), (13, (4, 5, 6)), (64, (31, 32)), (64, tuple(range(26, 38)))]


def _codes(seed, B, L):
    """[B, L] codes: random ACGT with scattered Ns and a short N run per row."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    c[rng.random((B, L)) < 0.004] = 4
    runs = rng.integers(0, L - 4, B)
    c[np.arange(B)[:, None], runs[:, None] + np.arange(3)] = 4
    return c


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


@pytest.mark.parametrize("k,mask", MASKS)
def test_masked_hashes_match_jax_and_oracle(k, mask):
    B, L = 24, 160
    stride = L - k + 1
    codes = _codes(k + len(mask), B, L)
    h, valid = tnt.window_hashes_doubling(torch.from_numpy(codes.T.copy()), (k,), stride, mask)[k]
    ch, cl, jvalid = jnt.window_hashes_doubling(jnp.asarray(codes), (k,), stride, mask)[k]
    got = to_u64(h)
    np.testing.assert_array_equal(got, _u64(ch, cl))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # sampled windows against the scalar oracle; validity is the full-window
    # N test, masked positions included
    rng = np.random.default_rng(k)
    for b, p in zip(rng.integers(0, B, 60), rng.integers(0, stride, 60)):
        win = [int(c) for c in codes[b, p : p + k]]
        assert bool(valid[p, b]) == (4 not in win)
        if 4 not in win:
            assert int(got[p, b]) == R.masked_hash(win, k, mask)


def test_mask_needs_a_single_k():
    cT = torch.zeros((64, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="single k"):
        tnt.window_hashes_doubling(cT, (12, 13), 8, (5, 6))
    with pytest.raises(ValueError, match="single k"):
        sketch_idx(cT.T, (12, 13), 8, 7, 10, mask_positions=(5, 6))


@pytest.mark.parametrize("k,mask", MASKS)
@pytest.mark.parametrize("r_bits", [10, 27])
def test_masked_sketch_idx_matches_xla(k, mask, r_bits):
    B, L, s_bits = 32, 192, 3  # s_bits 3: dense sampling, so many windows emit
    stride = ((L - k + 1) // 8) * 8
    codes = _codes(r_bits + k, B, L)
    sent0 = 2 * (1 << r_bits)
    got = sketch_idx(torch.from_numpy(codes), (k,), stride, s_bits, r_bits, mask).numpy()
    plain = sketch_idx_plain(torch.from_numpy(codes), (k,), stride, s_bits, r_bits, mask)
    np.testing.assert_array_equal(got, plain.numpy())

    idx_x, f1_x = jnt.sketch_scan(jnp.asarray(codes), (k,), stride, s_bits, r_bits, mask)
    idx_t, f1_t = tnt.sketch_scan(torch.from_numpy(codes), (k,), stride, s_bits, r_bits, mask)
    xla = np.asarray(idx_x[k])
    np.testing.assert_array_equal(idx_t[k].numpy(), xla)
    assert int(f1_t[k]) == int(f1_x[k])
    np.testing.assert_array_equal(np.minimum(got[0][:, :stride], sent0), xla.reshape(stride, B).T)
    assert int((got[0] != sent0 + 1).sum()) == int(f1_x[k])
    assert (xla < sent0).sum() > 0  # some windows are sampled
    # the mask matters: the unmasked stream differs
    unmasked = sketch_idx_plain(torch.from_numpy(codes), (k,), stride, s_bits, r_bits)
    assert not np.array_equal(got, unmasked.numpy())


K, GAP = 12, (5, 6)
ROWS, CHUNK = 256, 139  # quad2-admissible: stride 128, halo 11
STRIDE = aligned_stride(CHUNK, K)


def _records(seed, n=120):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(5, 900)))]
        if len(r) > 20 and rng.random() < 0.1:
            s = int(rng.integers(0, len(r) - 10))
            r[s : s + int(rng.integers(1, 10))] = ord("N")
        recs.append(r.tobytes())
    return recs


def _assert_same(got, want):
    assert got[K]["f1"] == want[K]["f1"]
    np.testing.assert_array_equal(got[K]["table"], want[K]["table"])
    np.testing.assert_array_equal(got[K]["hist"], want[K]["hist"])


@pytest.mark.parametrize("r_bits", [12, 20])
def test_gap_sketch_matches_jax(monkeypatch, r_bits):
    """K2 at r12, K3 + scatter at r20; the port is fed the quad2 wire the CLI
    sends, JAX the raw code batches."""
    monkeypatch.delenv("NTCARD_SCATTER", raising=False)
    batches = list(pack_records(_records(r_bits), CHUNK, ROWS, K))
    js = JaxSketch((K,), 7, r_bits, STRIDE, gap_positions=GAP)
    sk = CountTableSketch((K,), 7, r_bits, STRIDE, gap_positions=GAP, device="cpu")
    for b in batches:
        js.update(b)
        w = pack_wire(b, "quad2", STRIDE)
        sk.update(torch.from_numpy(w), packed=wire_mode_of(w, ROWS, CHUNK - STRIDE))
    _assert_same(sk.finalize(return_table=True, cov_max=200), js.finalize(True, 200))
    # and the gap changes the tables: a sketch without it differs
    plain = CountTableSketch((K,), 7, r_bits, STRIDE, device="cpu")
    for b in batches:
        plain.update(torch.from_numpy(b))
    assert not np.array_equal(
        plain.finalize(True, 200)[K]["table"], sk.finalize(True, 200)[K]["table"]
    )


@pytest.mark.parametrize("src", ["reads.fq", "reads-rna.fq", "reads.fa"])
def test_k12_gap_golden(tmp_path, src):
    """The reference's gap goldens over DNA FASTQ, RNA FASTQ and FASTA, as
    tests/test_e2e_golden.py::test_k12_gap runs them for the JAX package."""
    rc = cli.main(
        ["-k12", "-c1000", "-r16", "-g2", "-p", str(tmp_path / "t"), str(DATA / src)], device="cpu"
    )
    assert rc == 0
    got = (tmp_path / "t_k12.hist").read_bytes()
    assert got == (GOLD / "reads-gap_k12.hist.good").read_bytes()


def test_gap_checkpoints_cross_load_and_merge_checks_the_gap(monkeypatch, tmp_path):
    monkeypatch.delenv("NTCARD_SCATTER", raising=False)
    batches = list(pack_records(_records(3), CHUNK, ROWS, K))
    port = CountTableSketch((K,), 7, 16, STRIDE, gap_positions=GAP, device="cpu")
    js = JaxSketch((K,), 7, 16, STRIDE, gap_positions=GAP)
    for b in batches:
        port.update(torch.from_numpy(b))
        js.update(b)
    want = port.finalize(return_table=True, cov_max=200)

    port.save(str(tmp_path / "port.npz"))
    js.save(str(tmp_path / "jax.npz"))
    from_port = JaxSketch.load(str(tmp_path / "port.npz"))
    assert from_port.gap_positions == GAP
    _assert_same(from_port.finalize(True, 200), want)
    from_jax = CountTableSketch.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_jax.gap_positions == GAP
    _assert_same(from_jax.finalize(True, 200), want)

    # a merge across a different gap, or no gap, is refused
    for other in ((4, 5, 6, 7), None):
        with pytest.raises(ValueError, match="configs differ"):
            from_jax.merge_(CountTableSketch((K,), 7, 16, STRIDE, gap_positions=other, device="cpu"))
    from_jax.merge_(CountTableSketch.load(str(tmp_path / "port.npz"), device="cpu"))
    assert from_jax.finalize()[K]["f1"] == 2 * want[K]["f1"]
