"""The port's hybrid engine (NTCARD_ENGINE=hybrid) on the CPU, the cases of
tests/test_hybrid.py run against the port: one batch stream shared between
the native host engine and the device by work stealing
(ntcard_tpu_torch.pipeline.hybrid_feed), merged at the end
(CountTableSketch.merge_host_, or a max of registers). The fold commutes and
uint16-wrapped counts sum mod 2^16, so any split equals the JAX package's
single-engine run bit for bit (tolerance 0)."""

import time
from contextlib import closing
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

from ntcard_tpu import cli as jax_cli  # noqa: E402
from ntcard_tpu import cli_hll as jax_cli_hll  # noqa: E402
from ntcard_tpu import pipeline as jax_pipeline  # noqa: E402
from ntcard_tpu.models.sketch import CountTableSketch as JaxSketch  # noqa: E402
from ntcard_tpu_torch import cli, cli_hll  # noqa: E402
from ntcard_tpu_torch.models.host_engine import HostCountTableSketch  # noqa: E402
from ntcard_tpu_torch.models.sketch import CountTableSketch  # noqa: E402
from ntcard_tpu_torch.pipeline import _tail_guard_should_stop, device_feed, hybrid_feed  # noqa: E402

DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"
KS, STRIDE = (12, 17), 112


def _codes(rng, B, L, n_density=0.004):
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    c[rng.random((B, L)) < n_density] = 4
    return c


def _batches(n, seed=23):
    rng = np.random.default_rng(seed)
    return [_codes(rng, 128, 128) for _ in range(n)]


def _jax_state(batches, ks=KS):
    ref = JaxSketch(ks, 7, 10, STRIDE)
    for x in batches:
        ref.update(x)
    return ref.finalize(cov_max=1000)


def _final_eq(got, want, ks=KS):
    for k in ks:
        assert got[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(got[k]["hist"], want[k]["hist"])


@pytest.mark.parametrize("split", [0, 2, 5])
def test_merge_host_any_split(split):
    """All-device, mixed and all-host splits equal JAX's device-only run."""
    batches = _batches(5)
    dev = CountTableSketch(KS, 7, 10, STRIDE, device="cpu")
    host = HostCountTableSketch(KS, 7, 10, STRIDE)
    for x in batches[:split]:
        host.update(x)
    for x in batches[split:]:
        dev.update(torch.from_numpy(x))
    dev.merge_host_(host)
    _final_eq(dev.finalize(cov_max=1000), _jax_state(batches))


def test_hybrid_feed_work_stealing():
    """The split hybrid_feed happens to make is exact, and the host worker
    has finished before the iterator ends."""
    batches = _batches(12)
    dev = CountTableSketch((12,), 7, 10, STRIDE, device="cpu")
    host = HostCountTableSketch((12,), 7, 10, STRIDE, n_threads=1)
    n_dev = 0
    for b in hybrid_feed(iter(batches), host.update):
        dev.update(torch.from_numpy(b))
        n_dev += 1
    assert 0 <= n_dev <= len(batches)
    dev.merge_host_(host)
    _final_eq(dev.finalize(cov_max=1000), _jax_state(batches, (12,)), (12,))


def test_hybrid_feed_worker_error_propagates():
    def boom(_):
        raise RuntimeError("host engine exploded")

    with pytest.raises(RuntimeError, match="exploded"):
        for _ in hybrid_feed(iter(_batches(4)), boom):
            time.sleep(0.01)


def test_hybrid_feed_close_stops_the_workers():
    """A consumer that stops early (its loop raised) closes the iterator:
    the host worker stops claiming and is joined, so nothing keeps draining
    the input underneath the failure."""
    host_items = []

    def host_update(b):
        time.sleep(0.005)
        host_items.append(b)

    feed = hybrid_feed(iter(range(1000)), host_update)
    next(feed)
    feed.close()
    seen = len(host_items)
    time.sleep(0.05)
    assert len(host_items) == seen < 999


def test_device_feed_of_hybrid_feed_stops_the_host_when_the_device_raises():
    """The CLIs' path: the device-side consumer of device_feed(hybrid_feed(...))
    raises (a kernel failed). The feed closes down the chain: the host
    worker stops claiming batches and nothing goes on reading the input."""
    claimed, host_items = [], []

    def raw():
        for i in range(1000):
            claimed.append(i)
            yield np.full((2, 2), i % 256, np.uint8)

    def host_update(b):
        time.sleep(0.005)
        host_items.append(b)

    def consume():  # as ntcard_tpu_torch.cli._main_device consumes its feed
        batches = hybrid_feed(raw(), host_update)
        with closing(device_feed(batches, [torch.device("cpu")])) as feed:
            for i, _ in enumerate(feed):
                if i == 2:
                    raise RuntimeError("kernel failed")

    # the kept traceback holds consume's frame: only the explicit close stops it
    with pytest.raises(RuntimeError, match="kernel failed") as failure:
        consume()
    assert failure.traceback
    seen, pulled = len(host_items), len(claimed)
    time.sleep(0.1)
    assert len(host_items) == seen and len(claimed) == pulled < 1000


def test_merge_host_config_mismatch():
    dev = CountTableSketch((12,), 7, 10, 120, device="cpu")
    with pytest.raises(ValueError, match="configs differ"):
        dev.merge_host_(HostCountTableSketch((13,), 7, 10, 120))


def test_merge_host_uint16_wrap():
    """A host count at the uint16 wrap sums with the device's mod 2^16 (the
    reference's uint16 table, ntcard.cpp:437-439), as in the JAX package."""
    dev = CountTableSketch((12,), 7, 4, 120, device="cpu")
    jdev = JaxSketch((12,), 7, 4, 120)
    host = HostCountTableSketch((12,), 7, 4, 120)
    host.tables[0, 3] = 65535
    host.f1s[0] = 7
    dev.tables[0][3] += 2
    jdev.tables = (jdev.tables[0].at[3].add(2),) + jdev.tables[1:]
    dev.merge_host_(host)
    jdev.merge_host_(host)
    got, want = dev.finalize(cov_max=1000, return_table=True), jdev.finalize(cov_max=1000, return_table=True)
    assert got[12]["table"][0, 3] == 1  # (65535 + 2) % 65536
    assert got[12]["f1"] == want[12]["f1"] == 7
    np.testing.assert_array_equal(got[12]["table"], want[12]["table"])
    np.testing.assert_array_equal(got[12]["hist"], want[12]["hist"])


def test_tail_guard_predicate_matches_jax():
    """The guard's decision over a grid of inputs, including the JAX
    package's unit cases, equals ntcard_tpu.pipeline's."""
    assert _tail_guard_should_stop(40, 35, 10, 1.0, 1.0)
    assert not _tail_guard_should_stop(40, 20, 10, 1.0, 1.0)
    assert not _tail_guard_should_stop(40, 40, 10, 1.0, 100.0)  # hint exhausted
    for hint in (None, 0, 10, 40, 40.5):
        for pulled in (0, 2, 35, 40, 55):
            for host_done in (0, 1, 10):
                for elapsed in (0.0, 0.1, 1.0):
                    for dev_sec in (0.0, 0.01, 1.0, 100.0):
                        args = (hint, pulled, host_done, elapsed, dev_sec)
                        assert _tail_guard_should_stop(*args) == jax_pipeline._tail_guard_should_stop(*args), args


def test_tail_guard_diverts_tail_from_slow_device():
    """With total_hint, a device 10x slower than the host stops claiming
    while a tail remains; every batch is still processed exactly once."""
    n = 40
    host_items, dev_items = [], []

    def host_update(b):
        time.sleep(0.004)
        host_items.append(b)

    for b in hybrid_feed(iter(range(n)), host_update, total_hint=n):
        dev_items.append(b)
        time.sleep(0.04)
    assert sorted(host_items + dev_items) == list(range(n))
    assert max(dev_items) < n - 1, dev_items
    assert len(dev_items) < n // 2


def test_tail_guard_leaves_a_fast_device_the_bulk():
    n = 30
    host_items, dev_items = [], []

    def host_update(b):
        time.sleep(0.02)
        host_items.append(b)

    for b in hybrid_feed(iter(range(n)), host_update, total_hint=n):
        dev_items.append(b)
    assert sorted(host_items + dev_items) == list(range(n))
    assert len(dev_items) > n // 2


def test_cli_hybrid_matches_golden(monkeypatch, tmp_path, capsys):
    """The hybrid CLI run byte-matches the golden, and --metrics says the
    hybrid engine ran (so this test never covers the device path alone)."""
    monkeypatch.setenv("NTCARD_ENGINE", "hybrid")
    monkeypatch.setenv("NTCARD_HYBRID_HOST_THREADS", "2")
    rc = cli.main(["-k12", "-c1000", "-r16", "--batch-rows", "256", "--metrics",
                   "-p", str(tmp_path / "hyb"), str(DATA / "reads.fq")], device="cpu")
    assert rc == 0
    err = capsys.readouterr().err
    assert '"engine": "hybrid"' in err and "hybrid ignored" not in err, err
    assert (tmp_path / "hyb_k12.hist").read_bytes() == (GOLD / "reads_k12.hist.good").read_bytes()


def test_nthll_hybrid_matches_golden(monkeypatch, capsys):
    monkeypatch.setenv("NTCARD_ENGINE", "hybrid")
    assert cli_hll.main(["-k25", str(DATA / "reads.fq")], device="cpu") == 0
    out = capsys.readouterr()
    assert "hybrid ignored" not in out.err
    assert out.out == (GOLD / "nthll_k25.out.good").read_text()


def _note(capsys):
    return [line for line in capsys.readouterr().err.splitlines() if "hybrid ignored" in line]


@pytest.mark.parametrize("case", ["table over the limit", "two devices", "nthll, two devices"])
def test_ignored_note_matches_jax(monkeypatch, tmp_path, capsys, case):
    """Where hybrid does not apply the run is device-only, with the JAX
    package's note on stderr byte for byte: a host table above
    NTCARD_HYBRID_MAX_TABLE, and a sketch per device (the JAX package on the
    conftest's 8 virtual devices)."""
    monkeypatch.setenv("NTCARD_ENGINE", "hybrid")
    inputs = [str(DATA / "contig.fa")]
    if case.startswith("nthll"):
        assert cli_hll.main(["-k25", *inputs], device=["cpu", "cpu"]) == 0
        mine = _note(capsys)
        assert jax_cli_hll.main(["-k25", *inputs]) == 0
    else:
        if case == "two devices":
            port_dev, flags = ["cpu", "cpu"], ["--devices", "2"]
        else:
            monkeypatch.setenv("NTCARD_HYBRID_MAX_TABLE", "1000")
            port_dev, flags = "cpu", ["--devices", "1"]
        argv = ["-k12", "-c1000", "-r16", *flags, "-p", str(tmp_path / "o"), *inputs]
        assert cli.main(argv, device=port_dev) == 0
        mine = _note(capsys)
        assert jax_cli.main(argv) == 0
    theirs = _note(capsys)
    assert len(mine) == 1 and mine == theirs
