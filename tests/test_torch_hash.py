"""The port's hash layer against the JAX package (tolerance 0: all integer).

Rotations, the reference's fixed 20-mer hash, the three wire decoders, and
K1's plain version (what ntcard_tpu_torch.ops.sketch_idx.sketch_idx runs on
a CPU tensor) against the Pallas kernel in interpret mode and the XLA
sketch_scan.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import jax.numpy as jnp  # noqa: E402

from ntcard_tpu import constants as C  # noqa: E402
from ntcard_tpu.io.packing import (  # noqa: E402
    StreamPacker,
    pack_records,
    pack_rows,
    pack_rows_quad,
    pack_rows_quad2,
)
from ntcard_tpu.ops import nthash as jnt  # noqa: E402
from ntcard_tpu.ops import nthash_ref as R  # noqa: E402
from ntcard_tpu.ops.nthash_pallas import sketch_idx_pallas  # noqa: E402
from ntcard_tpu_torch.ops import nthash as tnt  # noqa: E402
from ntcard_tpu_torch.ops.rotations import srol_n  # noqa: E402
from ntcard_tpu_torch.ops.sketch_idx import sketch_idx, sketch_idx_plain  # noqa: E402
from ntcard_tpu_torch.ops.u64 import as_i64, to_u64  # noqa: E402


def _vals():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 1 << 64, size=64, dtype=np.uint64)
    v[:6] = [0, (1 << 64) - 1, 1, 1 << 32, 1 << 33, (1 << 33) - 1]  # ring edges
    return v


def test_srol_n_per_element_amounts_full_period():
    """P^n with a tensor of amounts (the srol_var_iota role) over the whole
    1023-step permutation period, against the scalar constants.srol_n."""
    v = _vals()
    n = np.arange(1023)
    x = torch.from_numpy(v.view(np.int64))[None, :].expand(len(n), -1)
    got = to_u64(srol_n(x, torch.from_numpy(n)[:, None]))
    want = np.array([[C.srol_n(int(a), int(m)) for a in v] for m in n], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_srol_n_constant_amount():
    v = _vals()
    for n in list(range(0, 80)) + [128, 144, 1000, 1023]:
        got = to_u64(srol_n(torch.from_numpy(v.view(np.int64)), n))
        np.testing.assert_array_equal(got, [C.srol_n(int(a), n) for a in v], err_msg=f"n={n}")


def test_fixed_20mer_hash():
    """The reference's regression value (BASELINE.md:16,
    UnitTests.cpp:48): the canonical hash of the fixed 20-mer, equal for
    its reverse complement."""
    for seq in ("ACGTACACTGGACTGAGTCT", "AGACTCAGTCCAGTGTACGT"):
        cT = torch.tensor(R.seq_to_codes(seq), dtype=torch.uint8)[:, None]
        h, valid = tnt.window_hashes_doubling(cT, (20,), 1)[20]
        assert bool(valid[0, 0])
        assert int(to_u64(h)[0, 0]) == 10434435546371013747


def _stream_batches(seed, n_records=800):
    """Packer batches (consecutive stream spans, as the CLI feeds them) of
    random records with N runs and short records."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n_records):
        r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(0, 600)))]
        if len(r) > 20 and rng.random() < 0.1:  # an N run, sparse enough for the sidecars
            s = int(rng.integers(0, len(r) - 10))
            r[s : s + int(rng.integers(1, 10))] = ord("N")
        recs.append(r.tobytes())
    packer = StreamPacker(chunk_len=160, batch_rows=512, kmax=32)
    return [b for r in recs for b in packer.feed(r)] + list(packer.finish()), packer.stride


@pytest.mark.parametrize("wire", ["quad2", "quad", "nibble"])
def test_unpack_wires_match_jax(wire):
    batches, stride = _stream_batches(11)
    halo = 160 - stride
    seen = 0
    for b in batches:
        if wire == "quad2":
            w, mode = pack_rows_quad2(b, stride), f"quad2:{halo}"
        elif wire == "quad":
            w, mode = pack_rows_quad(b), "quad"
        else:
            w, mode = pack_rows(b), "nibble"
        if w is None:
            continue  # sidecar overflow: the CLI sends this batch as nibble
        seen += 1
        got = tnt.codes_T(torch.from_numpy(w), mode).numpy()
        want = np.asarray(jnt._codes_T(jnp.asarray(w), mode))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, b.T)
    assert seen >= 2


def _codes(seed, B, L, kmax):
    """[B, L] packer codes of random records: N runs, short records."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTN", np.uint8)
    recs = [bytes(rng.choice(alphabet, size=int(rng.integers(0, 3 * L)))) for _ in range(80)]
    return next(iter(pack_records(recs, L, B, kmax)))


@pytest.mark.parametrize(
    "ks,r_bits", [((12,), 10), ((12, 32), 10), ((64,), 27), ((64, 96, 128), 16)]
)
def test_sketch_idx_matches_pallas_and_xla(ks, r_bits):
    B, L, s_bits = 128, 256, 7
    stride = ((L - max(ks) + 1) // 8) * 8
    codes = _codes(sum(ks), B, L, max(ks))
    sent0 = 2 * (1 << r_bits)

    got = sketch_idx(torch.from_numpy(codes), ks, stride, s_bits, r_bits).numpy()
    plain = sketch_idx_plain(torch.from_numpy(codes), ks, stride, s_bits, r_bits).numpy()
    np.testing.assert_array_equal(got, plain)
    pal = np.asarray(
        sketch_idx_pallas(jnp.asarray(codes), ks, stride, s_bits, r_bits, interpret=True)
    )
    np.testing.assert_array_equal(got, pal)

    idx_x, f1_x = jnt.sketch_scan(jnp.asarray(codes), ks, stride, s_bits, r_bits)
    idx_t, f1_t = tnt.sketch_scan(torch.from_numpy(codes), ks, stride, s_bits, r_bits)
    for t, k in enumerate(ks):
        xla = np.asarray(idx_x[k])
        np.testing.assert_array_equal(idx_t[k].numpy(), xla)
        assert int(f1_t[k]) == int(f1_x[k])
        # S0/S1 map onto the single XLA sentinel
        mapped = np.minimum(got[t][:, :stride], sent0)
        np.testing.assert_array_equal(mapped, xla.reshape(stride, B).T)
        # F1 reconstruction: every non-S1 position is a valid window
        assert int((got[t] != sent0 + 1).sum()) == int(f1_x[k])
        # every out-of-stride position is S1
        assert (got[t][:, stride:] == sent0 + 1).all()


def test_sketch_idx_rejects_windows_past_the_row():
    codes = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sketch_idx(codes, (32,), 40, 7, 10)
    with pytest.raises(ValueError):
        sketch_idx(codes, (12,), 8, 0, 10)


def test_as_i64_round_trip():
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, C.SEED_A):
        assert int(to_u64(torch.tensor([as_i64(v)]))[0]) == v
