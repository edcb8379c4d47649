"""The port's multi-device layer (ntcard_tpu_torch.parallel.data_parallel and
pipeline.device_feed's round-robin slots) on the CPU, with the CPU named
once per device: N private sketches fed whole batches in turn, folded at the
end, against one port sketch, the JAX package's CountTableSketch and
HllSketch, and its ShardedCountTableSketch and ShardedHllSketch on the
conftest's 8 virtual devices (tolerance 0: every output is an integer); the
port CLIs with a device list against the reference goldens; and the device
resolution rule."""

from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # tier-1 runs six xdist workers

import jax  # noqa: E402

from ntcard_tpu.io.packing import aligned_stride, pack_records, pack_wire, wire_mode_of  # noqa: E402
from ntcard_tpu.models.hll import HllSketch as JaxHll  # noqa: E402
from ntcard_tpu.models.sketch import CountTableSketch as JaxSketch  # noqa: E402
from ntcard_tpu.parallel.data_parallel import ShardedCountTableSketch, ShardedHllSketch  # noqa: E402
from ntcard_tpu_torch import cli, cli_hll  # noqa: E402
from ntcard_tpu_torch.device import DeviceCountError, resolve_devices  # noqa: E402
from ntcard_tpu_torch.models.sketch import CountTableSketch  # noqa: E402
from ntcard_tpu_torch.parallel.data_parallel import (  # noqa: E402
    PerDeviceCountTableSketch,
    PerDeviceHllSketch,
)
from ntcard_tpu_torch.pipeline import device_feed  # noqa: E402

DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"

S_BITS, ROWS, CHUNK = 7, 128, 139  # quad2-admissible: stride 128, halo 11
STRIDE = aligned_stride(CHUNK, 12)
HALO = CHUNK - STRIDE

# (ks, r_bits, gap): K2 (r <= 16), K3 + K2 (r > 16), a spaced seed
CONFIGS = {"k8,12 r12": ((8, 12), 12, None), "k8,12 r18": ((8, 12), 18, None),
           "k12 -g2 r12": ((12,), 12, (5, 6))}


def _records(seed, n=200, maxlen=900):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(5, maxlen)))]
        if len(r) > 20 and rng.random() < 0.1:
            s = int(rng.integers(0, len(r) - 10))
            r[s : s + int(rng.integers(1, 10))] = ord("N")
        recs.append(r.tobytes())
    return recs


_JAX_STATE: dict = {}


def _jax_state(case, recs_seed, **kw):
    """The JAX CountTableSketch's finalize over the batches of
    _records(recs_seed, **kw) (cached: one run per configuration)."""
    key = (case, recs_seed, tuple(kw.items()))
    if key not in _JAX_STATE:
        ks, r_bits, gap = CONFIGS[case]
        sk = JaxSketch(ks, S_BITS, r_bits, STRIDE, gap_positions=gap)
        for b in pack_records(_records(recs_seed, **kw), CHUNK, ROWS, 12):
            sk.update(b)
        _JAX_STATE[key] = sk.finalize(return_table=True, cov_max=200)
    return _JAX_STATE[key]


def _assert_same(got, want, ks):
    for k in ks:
        assert got[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(got[k]["table"], want[k]["table"])
        np.testing.assert_array_equal(got[k]["hist"], want[k]["hist"])


def _port_state(case, recs, n_dev):
    """N private CPU sketches fed the quad2 wire through device_feed."""
    ks, r_bits, gap = CONFIGS[case]
    sk = PerDeviceCountTableSketch(ks, S_BITS, r_bits, STRIDE, gap_positions=gap,
                                   devices=[torch.device("cpu")] * n_dev)
    wires = [pack_wire(b, "quad2", STRIDE) for b in pack_records(recs, CHUNK, ROWS, 12)]
    slots = []
    for slot, w in device_feed(iter(wires), sk.devices):
        slots.append(slot)
        sk.update(slot, w, packed=wire_mode_of(w, ROWS, HALO))
    assert slots == [i % n_dev for i in range(len(wires))]
    return sk.finalize(return_table=True, cov_max=200), len(wires)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_per_device_sketch_matches_one_sketch_and_jax(case, n_dev):
    ks, r_bits, gap = CONFIGS[case]
    recs = _records(1)
    got, n_batches = _port_state(case, recs, n_dev)
    assert n_batches > 3
    _assert_same(got, _jax_state(case, 1), ks)
    one = CountTableSketch(ks, S_BITS, r_bits, STRIDE, gap_positions=gap, device="cpu")
    for b in pack_records(recs, CHUNK, ROWS, 12):
        one.update(torch.from_numpy(b))
    _assert_same(got, one.finalize(return_table=True, cov_max=200), ks)


def test_fewer_batches_than_devices():
    """Three devices, one batch: two sketches stay empty and the fold is
    still exact."""
    case = "k8,12 r12"
    got, n_batches = _port_state(case, _records(2, n=10, maxlen=300), 3)
    assert n_batches == 1
    _assert_same(got, _jax_state(case, 2, n=10, maxlen=300), CONFIGS[case][0])


def test_per_device_sketch_matches_jax_sharded():
    """Eight private sketches against the JAX shard_map engine on the
    conftest's 8 virtual devices (which splits each batch's rows instead)."""
    assert len(jax.devices()) == 8
    ks, r_bits = (12, 32), 12
    stride = aligned_stride(128, 32)
    recs = _records(3, n=600, maxlen=600)
    sh = ShardedCountTableSketch(ks, S_BITS, r_bits, stride)
    for b in pack_records(recs, 128, 128 * sh.n_dev, 32):
        sh.update(b)
    want = sh.finalize(return_table=True)
    port = PerDeviceCountTableSketch(ks, S_BITS, r_bits, stride, devices=["cpu"] * 8)
    batches = list(pack_records(recs, 128, 128, 32))
    assert len(batches) > 8
    for slot, b in device_feed(iter(batches), port.devices):
        port.update(slot, b)
    _assert_same(port.finalize(return_table=True), want, ks)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_per_device_hll_matches_jax(n_dev):
    k, n_bits = 25, 12
    stride = aligned_stride(CHUNK, k)
    batches = list(pack_records(_records(4), CHUNK, ROWS, k))
    js = JaxHll(k, n_bits, stride)
    for b in batches:
        js.update(b)
    sk = PerDeviceHllSketch(k, n_bits, stride, devices=["cpu"] * n_dev)
    for slot, b in device_feed(iter(batches), sk.devices):
        sk.update(slot, b)
    got = sk.registers()
    assert got.dtype == np.uint8 and got.max() > 0
    np.testing.assert_array_equal(got, js.registers())


def test_per_device_hll_matches_jax_sharded():
    k, n_bits = 25, 10
    stride = aligned_stride(128, 32)
    recs = _records(5, n=600, maxlen=600)
    sh = ShardedHllSketch(k, n_bits, stride)
    for b in pack_records(recs, 128, 128 * sh.n_dev, 32):
        sh.update(b)
    sk = PerDeviceHllSketch(k, n_bits, stride, devices=["cpu"] * 8)
    for slot, b in device_feed(iter(list(pack_records(recs, 128, 128, 32))), sk.devices):
        sk.update(slot, b)
    np.testing.assert_array_equal(sk.registers(), sh.registers())


@pytest.mark.parametrize(
    "flags,inputs,good",
    [
        (["-k12", "-c1000", "-r16"], ["reads.fq"], "reads_k12.hist.good"),
        (["-k12", "-c1000", "-r16"], ["reads.fq", "contig.fa"], "both_k12.hist.good"),
        (["-k12", "-c1000", "-r16", "-g2"], ["reads.fq"], "reads-gap_k12.hist.good"),
    ],
    ids=["reads_k12", "both_k12", "reads-gap_k12"],
)
def test_cli_two_devices_matches_golden(tmp_path, flags, inputs, good):
    rc = cli.main([*flags, "--devices", "2", "--batch-rows", "1024", "-p", str(tmp_path / "o"),
                   *[str(DATA / f) for f in inputs]], device=["cpu", "cpu"])
    assert rc == 0
    assert (tmp_path / "o_k12.hist").read_bytes() == (GOLD / good).read_bytes()


def test_nthll_two_devices_matches_golden(capsys):
    assert cli_hll.main(["-k25", str(DATA / "reads.fq")], device=["cpu", "cpu"]) == 0
    assert capsys.readouterr().out == (GOLD / "nthll_k25.out.good").read_text()


def test_resolve_devices(monkeypatch):
    """A list is taken as it is; None and "cuda" mean the first --devices
    local cards (every card for 0) and refuse more than the machine has;
    any other one device is that device alone."""
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert resolve_devices("cpu", 3) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert resolve_devices() == resolve_devices("cuda") == cards
    assert resolve_devices(None, 1) == cards[:1]
    assert resolve_devices("cuda:1", 2) == [cards[1]]
    with pytest.raises(DeviceCountError, match="--devices 3 asks for more than the 2 local"):
        resolve_devices(None, 3)
