"""nthll in the port on the CPU (tolerance 0: every output is an integer).

The HLL emit and scan against the JAX package's, K5's plain version (what
ntcard_tpu_torch.ops.hll.hll_update_ runs on a CPU tensor) through the
HllSketch registers against the JAX HllSketch, and the port's nthll CLI:
the reference goldens, the flag handling of ntcard_tpu.cli_hll, a launch
environment without a coordinator, the explicit device rule and no jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import jax.numpy as jnp  # noqa: E402

from ntcard_tpu import cli_hll as jax_cli_hll  # noqa: E402
from ntcard_tpu.io.packing import aligned_stride, pack_records, pack_wire, wire_mode_of  # noqa: E402
from ntcard_tpu.models.hll import HllSketch as JaxHll  # noqa: E402
from ntcard_tpu.ops import nthash as jnt  # noqa: E402
from ntcard_tpu_torch import cli_hll  # noqa: E402
from ntcard_tpu_torch.models.hll import HllSketch  # noqa: E402
from ntcard_tpu_torch.ops import nthash as tnt  # noqa: E402
from ntcard_tpu_torch.ops.hll import hll_update_, hll_update_plain  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"


def _codes(seed, B, L):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    c[rng.random((B, L)) < 0.01] = 4
    return c


@pytest.mark.parametrize("n_bits", [1, 10, 16, 31])
def test_hll_emit_matches_jax_on_edge_hashes(n_bits):
    """Hashes chosen to hit every branch: a masked value of 0 (h below
    2^n_bits, h = 0), a zero high word with a nonzero masked low word, the
    top bit set, all ones, and random values; some windows invalid."""
    rng = np.random.default_rng(n_bits)
    special = [0, 1, (1 << n_bits) - 1, 1 << n_bits, (1 << n_bits) | 5, 1 << 31, (1 << 32) - 1,
               1 << 32, (1 << 33) + 7, 1 << 63, (1 << 64) - 1, 0xFFFFFFFF00000000]
    h = np.concatenate([np.array(special, np.uint64),
                        rng.integers(0, 1 << 64, 500, dtype=np.uint64),
                        rng.integers(0, 1 << 40, 100, dtype=np.uint64)])
    valid = rng.random(h.size) < 0.9
    valid[: len(special)] = True
    reg_t, run_t = tnt.make_hll_emit(n_bits)(torch.from_numpy(h.view(np.int64)),
                                             torch.from_numpy(valid))
    hi = (h >> np.uint64(32)).astype(np.uint32)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    reg_j, run_j = jnt.make_hll_emit(n_bits)(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    np.testing.assert_array_equal(reg_t.numpy(), np.asarray(reg_j))
    np.testing.assert_array_equal(run_t.numpy(), np.asarray(run_j))
    # the zero cases give run0 0, and a set top bit gives 0 leading zeros
    assert int(run_t[0]) == 0 and int(run_t[2]) == 0
    assert int(run_t[9]) == 0 and int(run_t[7]) == 31


def test_hll_emit_rejects_bad_bits():
    for n in (0, 32):
        with pytest.raises(ValueError, match="n_bits"):
            tnt.make_hll_emit(n)


@pytest.mark.parametrize("k", [5, 25, 64])
@pytest.mark.parametrize("n_bits", [10, 16])
def test_hll_scan_and_plain_update_match_jax(k, n_bits):
    B, L = 48, 200
    stride = ((L - k + 1) // 8) * 8
    codes = _codes(k * n_bits, B, L)
    reg_t, run_t = tnt.hll_scan(torch.from_numpy(codes), k, stride, n_bits)
    reg_j, run_j = jnt.hll_scan(jnp.asarray(codes), k, stride, n_bits)
    np.testing.assert_array_equal(reg_t.numpy(), np.asarray(reg_j))
    np.testing.assert_array_equal(run_t.numpy(), np.asarray(run_j))
    want = np.zeros(1 << n_bits, np.int32)
    np.maximum.at(want, np.asarray(reg_j), np.asarray(run_j))
    regs = torch.zeros(1 << n_bits, dtype=torch.int32)
    hll_update_(regs, torch.from_numpy(codes), k, stride, n_bits)  # CPU: the plain version
    np.testing.assert_array_equal(regs.numpy(), want)
    # any strides: the position-major stream as its transposed view
    regs2 = torch.zeros(1 << n_bits, dtype=torch.int32)
    hll_update_plain(regs2, torch.from_numpy(codes.T.copy()).T, k, stride, n_bits)
    np.testing.assert_array_equal(regs2.numpy(), want)


def test_hll_update_rejects_bad_arguments():
    codes = torch.zeros((8, 64), dtype=torch.uint8)
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        hll_update_(regs, codes, 32, 40, 10)  # windows past the row
    with pytest.raises(ValueError):
        hll_update_(regs, codes, 12, 8, 11)  # regs of the wrong size
    with pytest.raises(ValueError):
        hll_update_(regs.to(torch.int64), codes, 12, 8, 10)


@pytest.mark.parametrize("k,n_bits", [(25, 16), (25, 10), (64, 12)])
def test_hll_sketch_matches_jax(k, n_bits):
    """The port is fed the quad2 wire the CLI sends, JAX the raw batches."""
    rows, chunk = 256, 128 + k - 1 + 7
    stride = aligned_stride(chunk, k)
    rng = np.random.default_rng(k + n_bits)
    recs = []
    for _ in range(150):
        r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(5, 700)))]
        if len(r) > 20 and rng.random() < 0.1:
            s = int(rng.integers(0, len(r) - 10))
            r[s : s + int(rng.integers(1, 10))] = ord("N")
        recs.append(r.tobytes())
    batches = list(pack_records(recs, chunk, rows, k))
    js, sk = JaxHll(k, n_bits, stride), HllSketch(k, n_bits, stride, device="cpu")
    modes = []
    for b in batches:
        js.update(b)
        w = pack_wire(b, "quad2", stride)
        modes.append(wire_mode_of(w, rows, chunk - stride))
        sk.update(torch.from_numpy(w), packed=modes[-1])
    assert modes[0].startswith("quad2")
    got = sk.registers()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, js.registers())
    assert got.max() > 0
    with pytest.raises(ValueError, match="multiple of 8"):
        HllSketch(k, n_bits, stride + 1, device="cpu")


@pytest.mark.parametrize(
    "argv,good", [(["-k25"], "nthll_k25.out.good"), (["-k25", "-b10"], "nthll_k25_b10.out.good")]
)
def test_nthll_golden(capsys, argv, good):
    rc = cli_hll.main([*argv, str(DATA / "reads.fq")], device="cpu")
    assert rc == 0
    assert capsys.readouterr().out == (GOLD / good).read_text()


@pytest.mark.parametrize(
    "argv",
    [["--help"], ["--version"], [], ["-k", "x", "f.fq"], ["--bogus", "f.fq"], ["-h", "-c"]],
)
def test_flags_and_messages_match_jax(capsys, argv):
    """The flag loop written again here against ntcard_tpu.cli_hll's (none
    of these cases reaches its device path)."""
    out = []
    for fn in (cli_hll.main, jax_cli_hll.main):
        try:
            rc = fn(list(argv))
        except SystemExit as e:
            rc = ("exit", e.code)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[0] == out[1]
    assert out[0][0] != 0 or argv[0].startswith("--")


@pytest.mark.parametrize("env", [{"NTCARD_NUM_PROCESSES": "2"}, {"NTCARD_PROCESS_ID": "1"}])
def test_launch_env_without_a_coordinator_is_one_process(monkeypatch, capsys, env):
    """Without NTCARD_COORDINATOR nthll is one process whatever the other
    two variables say: it counts every file and prints."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cli_hll.main(["-k25", str(DATA / "reads.fq")], device="cpu") == 0
    assert capsys.readouterr().out == (GOLD / "nthll_k25.out.good").read_text()


def test_default_device_without_cuda_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_hll.main(["-k25", str(DATA / "reads.fq")])
    assert capsys.readouterr().out == ""


def test_nthll_never_imports_jax():
    """A run in a process where importing jax fails: the port must not need it."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises\n"
        "from ntcard_tpu_torch.cli_hll import main\n"
        f"rc = main(['-k25', {str(DATA / 'reads.fq')!r}], device='cpu')\n"
        "assert rc == 0\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and sys.modules[m]]\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"),
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout == (GOLD / "nthll_k25.out.good").read_text()
