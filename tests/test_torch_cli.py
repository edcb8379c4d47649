"""The port's CLI (ntcard_tpu_torch.cli) and offline merge tool
(ntcard_tpu_torch.tools.merge_sketches) on the CPU: byte parity with the
reference goldens, no jax import, the explicit device rule, and the refusal
of what stays refused."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

from ntcard_tpu_torch import cli  # noqa: E402
from ntcard_tpu_torch.tools import merge_sketches as port_merge  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"

# (flags, inputs, {output suffix: golden}) — the device path's goldens
GOLDENS = {
    "reads_k12_r16": (["-k12", "-c1000", "-r16"], ["reads.fq"], {"_k12.hist": "reads_k12.hist.good"}),
    "reads_k12_r27": (["-k12", "-c1000"], ["reads.fq"], {"_k12.hist": "reads_r27_k12.hist.good"}),
    "reads_multi_k": (
        ["-k32,64,96", "-c64", "-r16"],
        ["reads.fq"],
        {f"_k{k}.hist": f"reads_k{k}.hist.good" for k in (32, 64, 96)},
    ),
    "contig_k25_k96": (
        ["-k25,96", "-c64", "-r16"],
        ["contig.fa"],
        {"_k25.hist": "contig_k25.hist.good", "_k96.hist": "contig_k96.hist.good"},
    ),
    "both_k12": (["-k12", "-c1000", "-r16"], ["reads.fq", "contig.fa"], {"_k12.hist": "both_k12.hist.good"}),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_golden(tmp_path, case):
    flags, inputs, outs = GOLDENS[case]
    rc = cli.main([*flags, "-p", str(tmp_path / "o"), *[str(DATA / f) for f in inputs]], device="cpu")
    assert rc == 0
    for suffix, good in outs.items():
        assert (tmp_path / f"o{suffix}").read_bytes() == (GOLD / good).read_bytes(), suffix


def test_compact_tsv_and_stderr(tmp_path, capsys):
    out = tmp_path / "out.tsv"
    rc = cli.main(["-k12,32", "-c64", "-r16", "-o", str(out), str(DATA / "reads.fq")], device="cpu")
    assert rc == 0
    assert out.read_bytes() == (GOLD / "reads_compact.tsv.good").read_bytes()
    err = capsys.readouterr().err
    klines = "".join(line + "\n" for line in err.splitlines() if line.startswith("k="))
    assert klines == (GOLD / "reads_compact.stderr.good").read_text()


def test_save_sketch_merges_in_the_jax_tool(tmp_path):
    """--save-sketch writes ntcard_tpu's checkpoint format: two partial port
    runs merged offline by ntcard_tpu's merge tool give the combined golden."""
    from ntcard_tpu.tools import merge_sketches

    for name, f in (("s1", "reads.fq"), ("s2", "contig.fa")):
        rc = cli.main(
            ["-k12", "-c1000", "-r16", "-p", str(tmp_path / name),
             "--save-sketch", str(tmp_path / f"{name}.npz"), str(DATA / f)],
            device="cpu",
        )
        assert rc == 0
    rc = merge_sketches.main(
        ["-p", str(tmp_path / "m"), "-c", "1000", str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")]
    )
    assert rc == 0
    assert (tmp_path / "m_k12.hist").read_bytes() == (GOLD / "both_k12.hist.good").read_bytes()


def test_port_never_imports_jax(tmp_path):
    """A run in a process where importing jax fails: the port must not need it."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises\n"
        "from ntcard_tpu_torch.cli import main\n"
        f"rc = main(['-k12', '-c1000', '-r16', '-p', {str(tmp_path / 'o')!r}, "
        f"{str(DATA / 'reads.fq')!r}], device='cpu')\n"
        "assert rc == 0\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and sys.modules[m]]\n"
        "print('NO_JAX_OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"),
    )
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
    assert (tmp_path / "o_k12.hist").read_bytes() == (GOLD / "reads_k12.hist.good").read_bytes()


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-k12", "-r16", "-p", str(tmp_path / "o"), str(DATA / "reads.fq")])
    assert not (tmp_path / "o_k12.hist").exists()


@pytest.mark.parametrize(
    "flags,env,message",
    [
        (["-k12", "--devices", "3"], {}, "--devices 3 asks for more than the 1 local CUDA device"),
        (["-k12", "--save-sketch", "s.npz", "--coordinator", "localhost:1234", "--num-hosts", "2",
          "--host-id", "0"], {}, "--save-sketch in a multi-host run is not ported yet"),
        (["-k12", "--save-sketch", "s.npz"],
         {"NTCARD_COORDINATOR": "localhost:1234", "NTCARD_NUM_PROCESSES": "2", "NTCARD_PROCESS_ID": "1"},
         "--save-sketch in a multi-host run is not ported yet"),
    ],
    ids=["more devices than cards", "save-sketch, multi-host flags", "save-sketch, multi-host env"],
)
def test_refused_runs(monkeypatch, tmp_path, flags, env, message):
    """What stays refused exits 1 before any work: more cards than the
    machine has (on a one-card machine; the JAX package would drop the work
    of the missing ones), and --save-sketch in a multi-host run (every
    process would save its partial sketch to the one path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        cli.main([*flags, "-r16", "-p", str(tmp_path / "o"), str(DATA / "reads.fq")])
    assert str(e.value.code).startswith(f"ntCard: {message}")
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize(
    "env", [{"NTCARD_NUM_PROCESSES": "2"}, {"NTCARD_NUM_PROCESSES": "2", "NTCARD_PROCESS_ID": "1"}]
)
def test_launch_env_without_a_coordinator_is_one_process(monkeypatch, tmp_path, env):
    """Without NTCARD_COORDINATOR a run is one process whatever the other
    two variables say (ntcard_tpu.parallel.multihost.initialize_distributed):
    it counts every file and writes."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = cli.main(["-k12", "-c1000", "-r16", "-p", str(tmp_path / "o"), str(DATA / "reads.fq"),
                   str(DATA / "contig.fa")], device="cpu")
    assert rc == 0
    assert (tmp_path / "o_k12.hist").read_bytes() == (GOLD / "both_k12.hist.good").read_bytes()


def _port_sketch(tmp_path, name, src):
    rc = cli.main(
        ["-k12", "-c1000", "-r16", "-p", str(tmp_path / name),
         "--save-sketch", str(tmp_path / f"{name}.npz"), str(DATA / src)],
        device="cpu",
    )
    assert rc == 0
    return str(tmp_path / f"{name}.npz")


def _jax_sketch(monkeypatch, tmp_path, name, src):
    """A sketch saved by the JAX package's own device path."""
    from ntcard_tpu.cli import main as jax_main

    monkeypatch.setenv("NTCARD_ENGINE", "device")
    rc = jax_main(
        ["-k12", "-c1000", "-r16", "-p", str(tmp_path / name),
         "--save-sketch", str(tmp_path / f"{name}.npz"), str(DATA / src)]
    )
    monkeypatch.delenv("NTCARD_ENGINE")
    assert rc == 0
    return str(tmp_path / f"{name}.npz")


@pytest.mark.parametrize("saved_by", ["port+port", "jax+port", "port+jax"])
def test_merge_tool_golden(monkeypatch, tmp_path, saved_by):
    """The port's merge tool over partial sketches of reads.fq and contig.fa
    gives the combined golden, whichever package saved each sketch."""
    first, second = saved_by.split("+")
    paths = []
    for who, name, src in ((first, "s1", "reads.fq"), (second, "s2", "contig.fa")):
        if who == "jax":
            paths.append(_jax_sketch(monkeypatch, tmp_path, name, src))
        else:
            paths.append(_port_sketch(tmp_path, name, src))
    rc = port_merge.main(["-p", str(tmp_path / "m"), "-c", "1000", *paths], device="cpu")
    assert rc == 0
    assert (tmp_path / "m_k12.hist").read_bytes() == (GOLD / "both_k12.hist.good").read_bytes()
    rc = port_merge.main(["-o", str(tmp_path / "m.tsv"), *paths], device="cpu")
    assert rc == 0
    assert (tmp_path / "m.tsv").stat().st_size > 0


def test_merge_tool_refuses_bad_usage_and_mixed_configs(tmp_path, capsys):
    assert port_merge.main(["s.npz"], device="cpu") == 1
    assert "usage: merge_sketches" in capsys.readouterr().err
    assert port_merge.main(["--bogus", "-p", "x", "s.npz"], device="cpu") == 1
    a = _port_sketch(tmp_path, "a", "reads.fq")
    rc = cli.main(
        ["-k12", "-c1000", "-r16", "-g2", "-p", str(tmp_path / "g"),
         "--save-sketch", str(tmp_path / "g.npz"), str(DATA / "reads.fq")],
        device="cpu",
    )
    assert rc == 0
    with pytest.raises(ValueError, match="configs differ"):
        port_merge.main(["-p", str(tmp_path / "m"), a, str(tmp_path / "g.npz")], device="cpu")
    assert not (tmp_path / "m_k12.hist").exists()


@pytest.mark.parametrize(
    "argv",
    [[], ["s.npz"], ["-p", "x"], ["--bogus", "-p", "x", "s.npz"], ["-c"], ["-q", "s.npz"],
     ["-c", "x", "-p", "x", "s.npz"]],
)
def test_merge_tool_flags_and_messages_match_jax(capsys, argv):
    """The flag loop written again here against ntcard_tpu.tools.merge_sketches'
    (none of these cases loads a sketch)."""
    from ntcard_tpu.tools import merge_sketches as jax_merge

    out = []
    for fn in (port_merge.main, jax_merge.main):
        try:
            rc = fn(list(argv))
        except ValueError as e:
            rc = ("ValueError", str(e))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[0] == out[1]
    assert out[0][0] != 0


def test_merge_tool_default_device_without_cuda_raises(monkeypatch, tmp_path):
    path = _port_sketch(tmp_path, "a", "reads.fq")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_merge.main(["-p", str(tmp_path / "m"), path])
    assert not (tmp_path / "m_k12.hist").exists()
