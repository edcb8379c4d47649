"""The port's multi-host layer (ntcard_tpu_torch.parallel.multihost) on the
CPU, mirroring tests/test_multihost.py: two processes joined by gloo
(torch.distributed, a coordinator on localhost), each counting its own
slice of the files, against the reference goldens and a single-process run;
both finalize routes; and the launch rules (tolerance 0: every output is an
integer or a byte)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import torch.distributed as dist  # noqa: E402

from ntcard_tpu_torch import cli_hll  # noqa: E402
from ntcard_tpu_torch.parallel import multihost  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"
INPUTS = [str(DATA / "reads.fq"), str(DATA / "contig.fa")]
ENV = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(code: str, args_of, env_of=lambda pid: {}):
    """Run ``code`` in two processes (process id pid gets ``args_of(pid)``
    and ``env_of(pid)``), each with its own time limit; (stdout, stderr) of
    both, after both exited 0."""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, *args_of(pid)], cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env={**ENV, **env_of(pid)},
        )
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


NTCARD = """
import sys
from ntcard_tpu_torch.cli import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


def test_two_process_run_matches_golden(tmp_path):
    """The port CLI as two processes (--coordinator/--num-hosts/--host-id):
    process 0's output byte-matches the combined golden, and process 1
    writes nothing."""
    port = _free_port()
    _run_two(NTCARD, lambda pid: [
        "-k12", "-c1000", "-r16", "-p", str(tmp_path / f"h{pid}"),
        "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id", str(pid), *INPUTS])
    assert (tmp_path / "h0_k12.hist").read_bytes() == (GOLD / "both_k12.hist.good").read_bytes()
    assert not (tmp_path / "h1_k12.hist").exists()


NTHLL = """
import sys
from ntcard_tpu_torch.cli_hll import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


def test_two_process_nthll_env_launch(capsys):
    """nthll as two processes launched by NTCARD_COORDINATOR /
    NTCARD_NUM_PROCESSES / NTCARD_PROCESS_ID: process 0 prints the F0 line
    of the single-process run over both files, process 1 prints nothing."""
    assert cli_hll.main(["-k25", *INPUTS], device="cpu") == 0
    single = capsys.readouterr().out
    port = _free_port()
    outs = _run_two(NTHLL, lambda pid: ["-k25", *INPUTS], lambda pid: {
        "NTCARD_COORDINATOR": f"127.0.0.1:{port}", "NTCARD_NUM_PROCESSES": "2",
        "NTCARD_PROCESS_ID": str(pid)})
    assert [line for line in outs[0][0].splitlines(True) if line.startswith("F0,")] == [single]
    assert not any(line.startswith("F0,") for line in outs[1][0].splitlines())


ROUTES = """
import json, os, sys
import torch
from ntcard_tpu_torch.cli import geometry, parse_args
from ntcard_tpu_torch.models.sketch import CountTableSketch
from ntcard_tpu_torch.parallel import multihost
from ntcard_tpu_torch.pipeline import batches_from_files

pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
opt, _ = parse_args(["-k12,25", "-r16", "-p", "x", path])
chunk_len, stride = geometry(opt)
sk = CountTableSketch(opt.k_list, 7, 16, stride, device="cpu")
for b in batches_from_files([path], chunk_len, 1024, 25):
    sk.update(torch.from_numpy(b))
assert multihost.initialize_distributed(f"127.0.0.1:{port}", 2, pid, "cpu") == (pid, 2)
calls = []
device_route = multihost._finalize_reduce_scatter
multihost._finalize_reduce_scatter = lambda s, n: calls.append(n) or device_route(s, n)
out = {}
for route, env in (("host", {"NTCARD_MULTIHOST_FINALIZE": "host"}),
                   ("device", {"NTCARD_MULTIHOST_HOST_MAX": "0"}), ("default", {})):
    os.environ.update(env)
    state = multihost.merged_finalize(sk, cov_max=300)
    for k in env:
        del os.environ[k]
    out[route] = {"calls": len(calls), **{str(k): [v["f1"], v["hist"].tolist()] for k, v in state.items()}}
    calls.clear()
multihost.shutdown_distributed()
print(json.dumps(out))
"""


def test_merged_finalize_routes_agree(tmp_path):
    """Each process sketches one file at r16; the host route (forced by
    NTCARD_MULTIHOST_FINALIZE=host), the device route (reduce-scatter, K4 on
    the owned bucket slice, all-reduce: NTCARD_MULTIHOST_HOST_MAX=0) and the
    default (512 KB of tables: host) give both processes the finalize of
    one sketch over both files."""
    from ntcard_tpu_torch.cli import geometry, parse_args
    from ntcard_tpu_torch.models.sketch import CountTableSketch
    from ntcard_tpu_torch.pipeline import batches_from_files

    opt, _ = parse_args(["-k12,25", "-r16", "-p", "x", *INPUTS])
    chunk_len, stride = geometry(opt)
    one = CountTableSketch(opt.k_list, 7, 16, stride, device="cpu")
    for b in batches_from_files(INPUTS, chunk_len, 1024, 25):
        one.update(torch.from_numpy(b))
    want = {str(k): [v["f1"], v["hist"].tolist()] for k, v in one.finalize(cov_max=300).items()}
    port = _free_port()
    outs = _run_two(ROUTES, lambda pid: [str(pid), str(port), INPUTS[pid]])
    for so, _ in outs:
        got = json.loads(so.strip().splitlines()[-1])
        assert [got[r].pop("calls") for r in ("host", "device", "default")] == [0, 1, 0]
        for route in ("host", "device", "default"):
            assert got[route] == want, route


def test_no_coordinator_is_one_process(monkeypatch):
    """Without a coordinator, flag or env, a run is one process whatever
    NTCARD_NUM_PROCESSES and NTCARD_PROCESS_ID say: no group is joined, and
    the merges are the sketch's own."""
    monkeypatch.delenv("NTCARD_COORDINATOR", raising=False)
    monkeypatch.setenv("NTCARD_NUM_PROCESSES", "2")
    monkeypatch.setenv("NTCARD_PROCESS_ID", "1")
    assert multihost.launch_config() is None
    assert multihost.initialize_distributed(device_type="cpu") == (0, 1)
    assert not dist.is_initialized()
    monkeypatch.setenv("NTCARD_COORDINATOR", "h:1")
    assert multihost.launch_config() == ("h:1", 2, 1)
    assert multihost.launch_config(None, 3, 0) == ("h:1", 3, 0)

    class Regs:
        def registers(self):
            return np.arange(8, dtype=np.uint8)

    np.testing.assert_array_equal(multihost.merged_hll_registers(Regs()), np.arange(8))


@pytest.mark.parametrize("write_ok", [True, False])
def test_estimate_and_write_matches_jax(tmp_path, capsys, write_ok):
    """The epilogue's copy writes the same files as ntcard_tpu's, and with
    write_ok False (processes other than 0) none."""
    from ntcard_tpu import cli as jax_cli
    from ntcard_tpu.utils.metrics import Metrics as JaxMetrics
    from ntcard_tpu_torch import cli
    from ntcard_tpu_torch.utils.metrics import Metrics

    rng = np.random.default_rng(7)
    hist = rng.integers(0, 1000, (2, 101)).astype(np.int64)
    hist[:, 0] = 1 << 16
    state = {12: {"hist": hist, "f1": 123456}, 25: {"hist": hist[::-1].copy(), "f1": 99}}
    for name, fn, metrics in (("port", cli.estimate_and_write, Metrics()),
                              ("jax", jax_cli._estimate_and_write, JaxMetrics())):
        opt, _ = cli.parse_args(["-k12,25", "-c100", "-r16", "-p", str(tmp_path / name), "f"])
        opt.s_bits = 7
        assert fn(opt, state, metrics, {}, None, 0.0, write_ok=write_ok) == 0
    capsys.readouterr()
    for k in (12, 25):
        mine, theirs = tmp_path / f"port_k{k}.hist", tmp_path / f"jax_k{k}.hist"
        assert mine.exists() == theirs.exists() == write_ok
        if write_ok:
            assert mine.read_bytes() == theirs.read_bytes()
