"""The reader of kernel B8's roofline share and its byte count: a hand
count at both cells' sizes; the forward and backward kernels' own device
time over the traced window (no operation before them counted with them,
no other kernel), the calls their launches make times a call's least time;
at most 100% on a trace whose launches take exactly their bytes' time; no
reading without the kernels or without a trace."""
import json
import os
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.counts import hash_encode, peaks
from benchmark.harness import manifest, trace
from benchmark.tests.test_bench_harness import _Ev

FWD = "void (anonymous namespace)::hash_encode_kernel<2>(EncodeArgs)"
BWD = "void (anonymous namespace)::hash_encode_grad_kernel<2>(EncodeArgs)"


def _cfg(name):
    with open(os.path.join(manifest.BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _run(events, config, prefix):
    red = trace.reduce_events(events, (f"{prefix}.", "bench."))
    return SimpleNamespace(trace=red, prefix=prefix, config=config)


@pytest.mark.parametrize("name, points, refresh, launches", [
    # 4096 rays x K 32; 128^3 cells in 8 chunks of 2^18
    ("field_hash", 131072, (2 ** 21, 8), 40),
    # 32 scenes x 1024 rays x K 16; 32 x 64^3 / 4 cells in one chunk of 2^21
    ("fleet_hash", 524288, (2 ** 21, 1), 33),
])
def test_count_by_hand(name, points, refresh, launches):
    cfg = _cfg(name)
    # 16 levels x 2 features: 12 + 128 + 1024 bytes forward, 12 + 128 +
    # 16 x 8 x 12 backward
    assert hash_encode.forward_bytes(cfg) == 1164
    assert hash_encode.backward_bytes(cfg) == 1676
    assert hash_encode.step_points(cfg) == points
    assert hash_encode.refresh(cfg) == refresh
    assert hash_encode.launches_per_call(cfg) == launches
    want = (16 * points * (1164 + 1676) + refresh[0] * 1164) / peaks.HBM_BYTES
    assert hash_encode.bound_s(cfg) == pytest.approx(want)


@pytest.mark.parametrize("name, prefix", [("hash_encode_roofline", "field"),
                                          ("hash_encode_roofline.fleet", "fleet")])
def test_reader_counts_the_kernels_alone(name, prefix):
    cfg = _cfg("field_hash" if prefix == "field" else "fleet_hash")
    per_call = hash_encode.launches_per_call(cfg)
    evs = [_Ev("bench.window", 0, 10 ** 7), _Ev(f"{prefix}.adam", 100, 50),
           # a memset just before a launch on its stream: not the kernel's
           _Ev("Memset (Device)", 900, 100, dev=True),
           _Ev("vectorized_elementwise_kernel", 950, 40, dev=True)]
    t = 1000
    for k in range(2 * per_call):  # two calls' launches, 1 us apart, 2 us each
        evs.append(_Ev(BWD if k % 3 == 2 else FWD, t, 2000, dev=True))
        t += 3000
    got = run.load_reader(name)(_run(evs, cfg, prefix))
    seconds = 2 * per_call * 2000e-9
    assert got == pytest.approx(100.0 * 2 * hash_encode.bound_s(cfg) / seconds)


@pytest.mark.parametrize("name", ["field_hash", "fleet_hash"])
def test_share_is_at_most_100_when_each_launch_takes_its_bytes_time(name):
    """A trace whose launches each take exactly the time their own bytes
    take at the peak reads 100%: the count holds no byte that a launch
    does not move."""
    cfg = _cfg(name)
    prefix = "field" if name == "field_hash" else "fleet"
    fwd, bwd = hash_encode.forward_bytes(cfg), hash_encode.backward_bytes(cfg)
    steps = cfg["occ_update_every"]
    points, chunks = hash_encode.refresh(cfg)
    step_ns = hash_encode.step_points(cfg) / peaks.HBM_BYTES * 1e9
    times = [step_ns * fwd] * steps + [step_ns * bwd] * steps + [
        points / chunks * fwd / peaks.HBM_BYTES * 1e9] * chunks
    names = [FWD] * steps + [BWD] * steps + [FWD] * chunks
    evs, t = [_Ev("bench.window", 0, 10 ** 9), _Ev(f"{prefix}.adam", 10, 5)], 100
    for n, d in zip(names, times):
        evs.append(_Ev(n, t, d, dev=True))
        t += d + 10
    got = run.load_reader("hash_encode_roofline")(_run(evs, cfg, prefix))
    assert got == pytest.approx(100.0, rel=1e-9)


def test_reader_is_silent_without_the_kernels_or_a_trace():
    cfg = _cfg("field_hash")
    evs = [_Ev("bench.window", 0, 1000), _Ev("field.adam", 100, 50),
           _Ev("elementwise_kernel", 200, 500, dev=True)]
    read = run.load_reader("hash_encode_roofline")
    assert read(_run(evs, cfg, "field")) is None
    assert read(SimpleNamespace(trace=None, prefix="field", config=cfg)) is None
