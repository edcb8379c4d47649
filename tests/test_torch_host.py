"""The port's copies of the host layer against the JAX package's originals, on
the CPU (tolerance 0: every output is an integer, a byte or a float64
computed in the same order): the ntcard flag parser, the decode + pack batch
stream in every wire format, the estimator, and the native host engines."""

from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

from ntcard_tpu import cli as jax_cli  # noqa: E402
from ntcard_tpu import pipeline as jax_pipeline  # noqa: E402
from ntcard_tpu.models import estimate as jax_estimate  # noqa: E402
from ntcard_tpu.models import host_engine as jax_host  # noqa: E402
from ntcard_tpu_torch import cli, pipeline  # noqa: E402
from ntcard_tpu_torch.io.packing import aligned_stride  # noqa: E402
from ntcard_tpu_torch.models import estimate, host_engine  # noqa: E402

DATA = Path(__file__).parent / "data"
INPUTS = sorted(str(p) for p in DATA.iterdir() if p.suffix in (".fa", ".fq", ".sam"))

ARGV = [
    # valid
    ["-k12", "-p", "o", "f.fq"],
    ["-k64,96,128", "-c1000", "-o", "x.tsv", "a.fq", "b.fa"],
    ["-t4", "-s9", "-r16", "-g2", "-k12", "-p", "o", "f"],
    ["--kmer=32", "--cov=70000", "--pref=o", "--threads=3", "--rbit=20", "--sbit=8", "f"],
    ["-l", "5", "-f", "x", "-k5", "-po", "f"],
    ["--chunk-len", "512", "--batch-rows", "256", "--metrics", "--save-sketch", "s.npz",
     "-k12", "--output", "t.tsv", "f"],
    ["--devices", "2", "--coordinator", "h:1", "--num-hosts", "2", "--host-id", "1", "-k9",
     "-p", "o", "f", "g"],
    ["f", "-k7", "--gap=3", "-p", "o"],
    # invalid
    [],
    ["-k12", "f"],
    ["-p", "o", "f"],
    ["-k12", "-p", "o"],
    ["-kx", "-p", "o", "f"],
    ["-k12", "-g3", "-p", "o", "f"],
    ["-k12,14", "-g2", "-p", "o", "f"],
    ["--bogus", "-k12", "-p", "o", "f"],
    ["-t"],
    ["-k12", "-c", "abc", "-p", "o", "f"],
    ["--batch-rows=x", "-k12", "-p", "o", "f"],
    ["--help"],
    ["--version", "-k12"],
]


def _parse(fn, argv, capsys):
    try:
        opt, args = fn(list(argv))
        result = (0, vars(opt), args)
    except SystemExit as e:
        result = (e.code, None, None)
    out = capsys.readouterr()
    return result, out.out, out.err


def _reference_help(text):
    """The --help text without the parts that describe the engine, which
    differ on purpose: the notes under -t and the engine paragraph."""
    lines = text.splitlines()
    t = next(i for i, line in enumerate(lines) if "-t, --threads" in line)
    k = next(i for i, line in enumerate(lines) if "-k, --kmer" in line)
    e = next(i for i, line in enumerate(lines) if line.startswith(" Engine"))
    r = next(i for i, line in enumerate(lines) if line.startswith("Report bugs"))
    return lines[: t + 1] + lines[k:e] + lines[r:]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a) or "<none>")
def test_parse_args_matches_jax(capsys, argv):
    """Same option fields, arguments, stdout, stderr and exit status; for
    --help, the same text outside the engine notes, and the port's own
    notes say that it runs on one CUDA device and does not route."""
    mine = _parse(cli.parse_args, argv, capsys)
    theirs = _parse(jax_cli.parse_args, argv, capsys)
    if "--help" in argv:
        assert mine[:2] == theirs[:2] == ((0, None, None), "")
        assert _reference_help(mine[2]) == _reference_help(theirs[2])
        assert "one CUDA device" in mine[2] and "auto" not in mine[2]
    else:
        assert mine == theirs


def test_gap_and_wire_selection_match_jax(monkeypatch):
    for argv in (["-k12", "-g2", "-p", "o", "f"], ["-k64", "-g12", "-p", "o", "f"], ["-k9", "-po", "f"]):
        opt, _ = cli.parse_args(argv)
        assert cli.gap_positions(opt) == jax_cli._gap_positions(opt)
    for env in ("quad2", "quad", "nibble"):
        monkeypatch.setenv("NTCARD_WIRE", env)
        for rows, chunk_len, kmax in ((8192, 1024, 128), (256, 1024, 64), (256, 256, 25), (100, 90, 9)):
            stride = aligned_stride(chunk_len, kmax)
            assert cli.select_wire(rows, chunk_len, stride) == jax_cli._select_wire(
                rows, chunk_len, stride)[:3]


def _batches(mod, paths, wire, threads, **kw):
    return [np.array(b) for b in mod.parallel_batches_from_files(
        paths, 1024, 256, 64, threads, wire_packed=wire, **kw)]


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("wire", ["nibble", "quad", "quad2"])
def test_batch_stream_matches_jax(wire, threads):
    """The native decode + pack stream of every file of tests/data, byte for
    byte (as a multiset over two decode threads, whose order is free)."""
    runs = [[p] for p in INPUTS] + [INPUTS] if threads == 1 else [INPUTS]
    for paths in runs:
        stats, jstats = {}, {}
        mine = _batches(pipeline, paths, wire, threads, stats_out=stats)
        theirs = _batches(jax_pipeline, paths, wire, threads, stats_out=jstats)
        assert stats == jstats and stats["records"] > 0
        if threads == 2:
            mine, theirs = (sorted(x, key=lambda b: (b.shape, b.tobytes())) for x in (mine, theirs))
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape and np.array_equal(a, b)


def _stream_outcome(mod, paths, capsys, **kw):
    """(exit status, batches, stderr) of one batch stream."""
    try:
        batches = [np.array(b) for b in mod.batches_from_files(paths, 1024, 256, 64, **kw)]
        code = 0
    except SystemExit as e:
        batches, code = None, e.code
    return code, batches, capsys.readouterr().err


STREAM_CASES = {
    "missing file": (["missing.fq"], {}),
    "missing file skipped": (["missing.fq", "reads.fq"], {"lenient": True, "on_error": "skip"}),
    "unknown format": (["bad.txt"], {}),
    "unknown format skipped": (["bad.txt", "reads.fq"], {"on_error": "skip"}),
    "empty file, lenient": (["empty.fq", "contig.fa"], {"lenient": True, "on_error": "skip"}),
    "gzip": (["reads.fq.gz", "contig.fa"], {"wire_packed": "quad2"}),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_batch_stream_error_contract_matches_jax(tmp_path, capsys, case):
    """The native stream's per-file error contract (exit 1 with the
    reference's message, or skip) and its decompression, against the JAX
    package's stream."""
    import gzip

    (tmp_path / "bad.txt").write_bytes(b"hello world\n")
    (tmp_path / "empty.fq").write_bytes(b"")
    (tmp_path / "reads.fq.gz").write_bytes(gzip.compress((DATA / "reads.fq").read_bytes()))
    names, kw = STREAM_CASES[case]
    paths = [str(tmp_path / n) if not (DATA / n).exists() else str(DATA / n) for n in names]
    mine = _stream_outcome(pipeline, paths, capsys, **kw)
    theirs = _stream_outcome(jax_pipeline, paths, capsys, **kw)
    assert mine[0] == theirs[0] and mine[2] == theirs[2]
    if mine[1] is None:
        assert theirs[1] is None and mine[0] == 1 and mine[2]
    else:
        assert len(mine[1]) == len(theirs[1]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(mine[1], theirs[1]))


def test_corrupt_gz_exits_1_every_time(tmp_path, capsys):
    """A truncated .fq.gz makes gunzip fail after it has written what it
    could; the port's stream must exit 1 every time, never pass it silently
    (the reference's SIGCHLD fail-fast contract, as in
    tests/test_decompress.py). The loop gives the race between the reader's
    EOF and the child's exit the chance to show: a close that found the
    child still running after EOF used to kill it and lose its status."""
    import gzip

    fq = b"@r1\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n@r2\nTTTTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n"
    bad = tmp_path / "corrupt.fq.gz"
    payload = gzip.compress(fq * 500)
    bad.write_bytes(payload[: len(payload) // 2])
    for _ in range(60):
        with pytest.raises(SystemExit) as e:
            list(pipeline.batches_from_files([str(bad)], 256, 128, 16))
        assert e.value.code == 1
        assert "exited with status" in capsys.readouterr().err


def test_filter_that_fails_after_closing_its_output_exits_1(tmp_path, monkeypatch, capsys):
    """The race made certain: the filter writes a whole valid file, closes
    its stdout (the reader sees EOF) and only then exits 1. Its status must
    still abort the run."""
    from ntcard_tpu_torch.io import decompress

    slow = tmp_path / "reads.fq.slowfail"
    slow.write_bytes((DATA / "reads.fq").read_bytes())
    entry = (".slowfail", ["sh", "-c", 'cat "$0"; exec 1>&-; sleep 0.2; exit 3'])
    monkeypatch.setattr(decompress, "_ZCAT_TABLE", [entry, *decompress._ZCAT_TABLE])
    with pytest.raises(SystemExit) as e:
        list(pipeline.batches_from_files([str(slow)], 256, 128, 16))
    assert e.value.code == 1
    assert "exited with status 3" in capsys.readouterr().err


def test_expand_file_args_matches_jax(tmp_path):
    from ntcard_tpu.io.readers import expand_file_args as jax_expand
    from ntcard_tpu_torch.io.readers import expand_file_args

    lst = tmp_path / "list.txt"
    lst.write_text("a.fq\n\nb.fa\n")
    args = ["x.fq", f"@{lst}", "y.sam"]
    assert expand_file_args(args) == jax_expand(args) == ["x.fq", "a.fq", "", "b.fa", "y.sam"]


def test_file_assignment_matches_jax():
    from ntcard_tpu.parallel.multihost import host_file_assignment

    rng = np.random.default_rng(3)
    files = [f"f{i}" for i in range(11)]
    sizes = list(rng.integers(0, 100, len(files)))
    for n in (1, 2, 3, 5):
        for h in range(n):
            assert pipeline.host_file_assignment(files, sizes, n, h) == host_file_assignment(
                files, sizes, n, h)


@pytest.mark.parametrize("s_bits,r_bits,cov_max", [(7, 27, 1000), (11, 16, 64), (3, 10, 300)])
def test_comp_est_hist_matches_jax(s_bits, r_bits, cov_max):
    rng = np.random.default_rng(r_bits)
    n = 1 << r_bits
    p = np.zeros((2, cov_max + 1), np.int64)
    for s in range(2):
        p[s, 1:] = rng.geometric(0.05, cov_max) * rng.integers(0, 50, cov_max)
        p[s, 0] = n - p[s, 1:].sum() % n
    f0, f = estimate.comp_est_hist(p, s_bits, r_bits, cov_max)
    jf0, jf = jax_estimate.comp_est_hist(p, s_bits, r_bits, cov_max)
    assert f0 == jf0
    np.testing.assert_array_equal(f, jf)


def test_comp_est_hist_edge_cases_match_jax():
    empty = np.zeros((2, 11), np.int64)  # p[0] = 0: the overflow path
    full = np.zeros((2, 11), np.int64)
    full[:, 0] = 1 << 10  # every counter zero: F0 = 0, every f_i 0
    for p in (empty, full):
        assert str(estimate.comp_est_hist(p, 7, 10, 10)) == str(
            jax_estimate.comp_est_hist(p, 7, 10, 10))


@pytest.mark.parametrize("n_bits", [4, 10, 16])
def test_estimate_f0_matches_jax(n_bits):
    regs = np.random.default_rng(n_bits).integers(0, 40, 1 << n_bits).astype(np.uint8)
    for canon in (True, False):
        assert estimate.estimate_f0(regs, canon) == jax_estimate.estimate_f0(regs, canon)


def _raw_batches(kmax, **kw):
    return list(pipeline.batches_from_files([str(DATA / "reads.fq")], 256, 128, kmax, **kw))


@pytest.mark.parametrize("ks,r_bits,gap", [((12,), 16, None), ((12, 32), 10, None), ((12,), 14, (5, 6))])
def test_host_count_engine_matches_jax(ks, r_bits, gap):
    stride = aligned_stride(256, max(ks))
    mine = host_engine.HostCountTableSketch(ks, 7, r_bits, stride, gap_positions=gap, n_threads=2)
    theirs = jax_host.HostCountTableSketch(ks, 7, r_bits, stride, gap_positions=gap, n_threads=2)
    for b in _raw_batches(max(ks)):
        mine.update(b)
        theirs.update(b)
    np.testing.assert_array_equal(mine.tables, theirs.tables)
    np.testing.assert_array_equal(mine.f1s, theirs.f1s)
    a, b = mine.finalize(cov_max=300), theirs.finalize(cov_max=300)
    for k in ks:
        assert a[k]["f1"] == b[k]["f1"]
        np.testing.assert_array_equal(a[k]["hist"], b[k]["hist"])


@pytest.mark.parametrize("k,n_bits", [(25, 16), (64, 10)])
def test_host_hll_engine_matches_jax(k, n_bits):
    stride = aligned_stride(256, k)
    mine = host_engine.HostHllSketch(k, n_bits, stride, n_threads=2)
    theirs = jax_host.HostHllSketch(k, n_bits, stride, n_threads=2)
    for b in _raw_batches(k, lenient=True, on_error="skip"):
        mine.update(b)
        theirs.update(b)
    np.testing.assert_array_equal(mine.registers(), theirs.registers())
    assert mine.registers().max() > 0
