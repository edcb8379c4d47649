"""K2, K3 and K4 (ntcard_tpu_torch.ops.scatter) on CPU tensors, which run
their plain versions, against the Pallas kernels in interpret mode and the
XLA references (tolerance 0: all integer)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import jax.numpy as jnp  # noqa: E402

from ntcard_tpu.models.sketch import (  # noqa: E402
    _HIST_CAP,
    _hist_row_fallback,
    _hist_row_sparse_parts,
)
from ntcard_tpu.ops.scatter_pallas import compact_pallas, hist_add_pallas  # noqa: E402
from ntcard_tpu_torch.ops import scatter as S  # noqa: E402


def _sparse_idx(seed, shape, sent, hi):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    idx = np.full(n, sent, np.int32)
    m = rng.random(n) < 0.01
    idx[m] = rng.integers(0, hi, m.sum())
    return idx.reshape(shape), m.sum()


@pytest.mark.parametrize("shape", [(16, 1024), (8, 640), (40, 96)])
def test_hist_add_matches_pallas_and_bincount(shape):
    r_bits = 10
    sent = 2 << r_bits
    idx, _ = _sparse_idx(1, shape, sent, sent)
    got = S.hist_add(torch.from_numpy(idx), r_bits).numpy()
    pal = np.asarray(hist_add_pallas(jnp.asarray(idx), r_bits, interpret=True, block_rows=16))
    want = np.bincount(idx.ravel()[idx.ravel() != sent], minlength=sent + 1)
    assert got.shape == (sent + 1,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the sentinel bin: 0 here; not maintained by the Pallas kernel (never read)
    np.testing.assert_array_equal(got[:sent], pal[:sent])
    # in place into an existing table, as the sketch calls it
    table = torch.arange(sent + 1, dtype=torch.int32)
    out = S.hist_add(torch.from_numpy(idx), r_bits, out=table)
    assert out is table
    np.testing.assert_array_equal(table.numpy(), np.arange(sent + 1) + want)


def test_hist_add_skips_both_k1_sentinels():
    """K1's S0 (= the sentinel) and S1 (= sentinel + 1) are never counted,
    so K1's output feeds K2 without a clamp."""
    r_bits = 4
    sent = 2 << r_bits
    idx = torch.tensor([0, 3, sent, sent + 1, sent - 1, 3], dtype=torch.int32)
    got = S.hist_add(idx, r_bits).numpy()
    assert got.sum() == 4 and got[3] == 2 and got[sent] == 0 and got[sent - 1] == 1


@pytest.mark.parametrize("r_bits", [0, 17])
def test_hist_add_keeps_the_r_contract(r_bits):
    """hist_add_pallas accepts r in [1, 16] only (r17's packed encoding
    collides with its exhaustion sentinel); the port keeps the contract."""
    idx = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        S.hist_add(idx, r_bits)


def _multiset(vals):
    v = np.asarray(vals)
    return np.sort(v[v >= 0])


@pytest.mark.parametrize("shape", [(16, 1024), (8, 640), (40, 96)])
def test_compact_matches_pallas(shape):
    sent = 1 << 28
    idx, n_kept = _sparse_idx(2, shape, sent, sent)
    vals, cnt = S.compact(torch.from_numpy(idx), sent, 256)
    pv, pc = compact_pallas(jnp.asarray(idx), sent, 256, interpret=True, block_rows=16)
    assert vals.shape == (256,) and vals.dtype == torch.int32
    assert int(cnt) == int(pc) == n_kept
    np.testing.assert_array_equal(_multiset(vals), _multiset(pv))
    assert int((vals < 0).sum()) == 256 - n_kept  # unused slots are -1


def test_compact_full_range_edge():
    """The packed2 edge of the Pallas extractor (tests/test_scatter_pallas.py):
    a value at the last window position with its low 18 bits all ones."""
    sent = (1 << 31) - 2
    idx = np.full((16, 1024), sent, np.int32)
    edge = 0x3FFFF | (7 << 18)
    idx.ravel()[8191] = edge
    idx.ravel()[0] = 5
    vals, cnt = S.compact(torch.from_numpy(idx), sent, 256)
    pv, pc = compact_pallas(jnp.asarray(idx), sent, 256, interpret=True, block_rows=16, packed2=True)
    assert int(cnt) == int(pc) == 2
    np.testing.assert_array_equal(_multiset(vals), [5, edge])
    np.testing.assert_array_equal(_multiset(vals), _multiset(pv))


def test_compact_overflow_reports_true_count():
    rng = np.random.default_rng(3)
    sent = 1 << 20
    idx = rng.integers(0, sent, (16, 64)).astype(np.int32)  # 1024 > cap
    vals, cnt = S.compact(torch.from_numpy(idx), sent, 256)
    _, pc = compact_pallas(jnp.asarray(idx), sent, 256, interpret=True, block_rows=16)
    assert int(cnt) == int(pc) == 1024
    assert int((vals >= 0).sum()) == 256  # the cap is never written past


def test_compact_cap_contract():
    idx = torch.zeros(16, dtype=torch.int32)
    for cap in (0, 100):
        with pytest.raises(ValueError):
            S.compact(idx, 5, cap)


def test_overflow_add_is_gated_by_the_flag():
    sent = 64
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(-3, sent + 3, 500).astype(np.int32))
    kept = idx[(idx >= 0) & (idx < sent)].numpy()
    base = torch.from_numpy(rng.integers(0, 9, sent + 1).astype(np.int32))
    off = S.table_add_(base.clone(), idx, sent, gate=torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(off.numpy(), base.numpy())
    on = S.table_add_(base.clone(), idx, sent, gate=torch.ones(1, dtype=torch.int32))
    want = base.numpy() + np.bincount(kept, minlength=sent + 1)
    np.testing.assert_array_equal(on.numpy(), want)


def _wrapped_rows(seed, n=1024):
    """Two table rows of counters: untouched zeros, small counts, counts
    past the uint16 wrap (some wrapping to exactly 0 and to small values)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((2, n), np.int32)
    kind = rng.integers(0, 4, rows.shape)
    rows[kind == 1] = rng.integers(1, 80, (kind == 1).sum())
    rows[kind == 2] = rng.integers(1, 1 << 18, (kind == 2).sum())
    rows[kind == 3] = 65536 * rng.integers(1, 4, (kind == 3).sum()) + rng.integers(
        0, 3, (kind == 3).sum()
    )
    return rows


@pytest.mark.parametrize("cov_max", [64, 1000, 65535])
def test_counter_hist_matches_jax(cov_max):
    nbins = min(cov_max + 1, 65536)
    rows = _wrapped_rows(cov_max)
    got = S.counter_hist(torch.from_numpy(rows), nbins).numpy()
    assert got.shape == (2, nbins) and got.dtype == np.int32
    for s in range(2):
        h, cnt = _hist_row_sparse_parts(jnp.asarray(rows[s]), nbins, True)
        assert int(cnt) <= _HIST_CAP  # the sparse parts are valid here
        np.testing.assert_array_equal(got[s], np.asarray(h))
        np.testing.assert_array_equal(got[s], np.asarray(_hist_row_fallback(rows[s], nbins)))


def test_counter_hist_nbins_contract():
    rows = torch.zeros((2, 8), dtype=torch.int32)
    for nbins in (0, 65537):
        with pytest.raises(ValueError):
            S.counter_hist(rows, nbins)
