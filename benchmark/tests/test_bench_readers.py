"""The readers of the program's ``wait``, ``draw``, ``occupancy`` and
``occ_update`` spans on a hand-made reduced trace of two steps: each reads
its span's host milliseconds (or, ``waits_per_step``, its count) over the
steps the trace holds, whether its spans nest inside others or not, and
returns None where the trace lacks its span or where there is no trace."""
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.harness import manifest, trace
from benchmark.tests.test_bench_harness import _Ev

NS = 1e-6  # ms a nanosecond

# two steps of 1000 ns: ``rays`` and ``encode`` each hold ``wait`` spans,
# one ``wait`` (the metrics read back) sits outside every stage, the
# ``draw`` span opens once before the steps, the refresh once after them
EVENTS = [
    _Ev("bench.window", 0, 5000), _Ev("bench.call", 0, 5000),
    _Ev("field.draw", 10, 90),
    _Ev("field.rays", 100, 100), _Ev("field.wait", 110, 20), _Ev("field.wait", 140, 30),
    _Ev("field.occupancy", 200, 50),
    _Ev("field.encode", 250, 200), _Ev("field.wait", 260, 150),
    _Ev("field.adam", 500, 100),
    _Ev("field.rays", 1100, 100), _Ev("field.wait", 1110, 10),
    _Ev("field.occupancy", 1200, 70),
    _Ev("field.encode", 1300, 200), _Ev("field.wait", 1310, 40),
    _Ev("field.adam", 1500, 100),
    _Ev("field.occ_update", 2000, 600), _Ev("field.wait", 2100, 300),
    _Ev("field.wait", 2700, 500),
    _Ev("k1", 120, 2000, dev=True),
]
WAITS = [20, 30, 150, 10, 40, 300, 500]


def _run(events=EVENTS, prefix="field"):
    red = trace.reduce_events(events, (f"{prefix}.", "bench."))
    return SimpleNamespace(trace=red, prefix=prefix, step_span="adam")


@pytest.mark.parametrize("name, want", [
    ("wait_ms", sum(WAITS) * NS / 2),
    ("wait_ms.fleet", sum(WAITS) * NS / 2),
    ("waits_per_step", len(WAITS) / 2),
    ("waits_per_step.fleet", len(WAITS) / 2),
    ("draw_ms", 90 * NS / 2),
    ("occupancy_ms", (50 + 70) * NS / 2),
    ("occupancy_ms.fleet", (50 + 70) * NS / 2),
    ("occ_update_ms", 600 * NS / 2),
    ("occ_update_ms.fleet", 600 * NS / 2),
])
def test_reader_on_a_reduced_trace(name, want):
    assert run.load_reader(name)(_run()) == pytest.approx(want)


def test_readers_take_the_cell_prefix():
    fleet = [_Ev(e.name().replace("field.", "fleet."), e.start_ns(), e.duration_ns())
             for e in EVENTS]
    for name in ("wait_ms.fleet", "waits_per_step.fleet", "occupancy_ms.fleet",
                 "occ_update_ms.fleet"):
        assert run.load_reader(name)(_run(fleet, "fleet")) == \
            pytest.approx(run.load_reader(name)(_run()))
        # a fleet cell reads no field span
        assert run.load_reader(name)(_run(EVENTS, "fleet")) is None


SPAN = {"wait_ms": "wait", "waits_per_step": "wait", "draw_ms": "draw",
        "occupancy_ms": "occupancy", "occ_update_ms": "occ_update"}


@pytest.mark.parametrize("name", sorted(SPAN))
def test_reader_without_its_span(name):
    """The parent of a change that adds a span: the reader finds nothing
    and returns None, and the harness leaves the metric out."""
    left = [e for e in EVENTS if e.name() != f"field.{SPAN[name]}"]
    assert run.load_reader(name)(_run(left)) is None
    assert run.load_reader(name)(SimpleNamespace(trace=None, prefix="field",
                                                 step_span="adam")) is None


def test_every_new_metric_has_its_reader():
    names = {m["name"] for m in manifest.load_manifest()["per_layer"]}
    for family in SPAN:
        assert family in names
        assert manifest.metric_path(family).endswith(f"metrics/{family}.py")
