"""The harness on the CPU at a tiny size: each cell's set-up, a window of
one call, the comparison and the result line; the refusal without a card;
the trace's reduction; the import hygiene."""
import io
import json
import os
import subprocess
import sys
from argparse import Namespace
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import compare, trace
from benchmark.harness.manifest import ROOT
from benchmark.tests.conftest import TINY

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 12345  # past 32 signed bits: seeds may be that large


def _dry_run(cell, traced=0):
    import torch

    args = Namespace(workload=cell.name, seed=SEED, seconds=0.001, trace=traced)
    return run.run(args, cell, device_override=torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("traced", [0, 1])
def test_dry_run_line(tiny_cell, name, traced):
    cell = tiny_cell(name)
    result = _dry_run(cell, traced)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run.emit(result) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert all(k in line for k in KEYS) and list(line)[-1] == "compared"
    assert set(line) <= set(KEYS) | {"breakdown", "trace", "window", "compared"}
    assert line["window"]["work"] > 0 and line["window"]["seconds"] > 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == cell.traffic["steps_per_call"]  # one call
    specs = cell.per_layer if traced else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in specs}
    if traced:
        assert line["trace"]["steps_run"] == line["trace"]["step_spans_seen"]
        assert any(k.startswith("encode_ms") for k in line["metrics"])
    else:  # every end-to-end metric a CPU run can read
        assert set(line["metrics"]) == {m["name"] for m in specs
                                        if m["source"] == "host_clock"}
    # no number under a device metric's name from a CPU run
    assert line["device"]["platform"] == "cpu"
    for m in specs:
        if m["source"] in ("device_trace", "program_counter"):
            assert m["name"] not in line["metrics"]
    assert set(line["compared"]) == set(compare.NUMBERS)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    assert run.main(["--workload", "field_hash_rgb", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""
    from benchmark import control

    assert control.main(["--workload", "field_hash_rgb", "--seeds", "1"]) == 3


def test_unknown_cell_refused(capsys):
    assert run.main(["--workload", "no_such_cell", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "instance_nerf_tpu_torch_fake", SimpleNamespace())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", SimpleNamespace())
    assert run.forbidden_modules() == ["jax"]


_HYGIENE = """
import sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(body):
    out = subprocess.run([sys.executable, "-c", _HYGIENE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_import_hygiene_after_dry_run():
    body = """
from benchmark.harness import manifest
from benchmark.tests.conftest import TINY
from benchmark import run
from argparse import Namespace
for name, (cfg, traffic) in TINY.items():
    cell = manifest.load_cell(name)
    cell.config.update(cfg)
    cell.traffic.update(traffic)
    run.run(Namespace(workload=name, seed=3, seconds=0.001, trace=1), cell,
            device_override=torch.device("cpu"))
"""
    mods = _top_level(body)
    assert "instance_nerf_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "optax", "instance_nerf_tpu"}


def test_reference_imports_no_program():
    body = "\n".join(f"import benchmark.reference.{m}" for m in
                     ("plain_field", "fields", "field_hash", "fleet_hash"))
    mods = _top_level(body + "\nimport benchmark.traffic.draws\nimport benchmark.counts.flops")
    assert not mods & {"jax", "jaxlib", "flax", "optax", "instance_nerf_tpu",
                       "instance_nerf_tpu_torch"}


_RANKED = """
import sys, json, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from argparse import Namespace
from benchmark import run
from benchmark.harness import manifest
from benchmark.tests.conftest import TINY
cell = manifest.load_cell("field_hash_rgb")
cfg, traffic = TINY["field_hash_rgb"]
cell.config.update(cfg)
cell.traffic.update(traffic)
out = run.run(Namespace(workload=cell.name, seed=7, seconds=0.001, trace=1), cell,
              device_override=torch.device("cpu"))
if out is not None:
    print(json.dumps(out))
"""


def test_two_ranks_on_the_cpu(capfd):
    """A cell's ranks as ``launch`` starts them (here over gloo): one result
    line, from rank 0, with the ranks' work summed."""
    assert run.launch([sys.executable, "-c", _RANKED.format(root=ROOT)], 2) == 0
    lines = [x for x in capfd.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["failed"] == 0
    assert line["trace"]["steps_run"] == line["trace"]["step_spans_seen"]


def test_launch_stops_the_ranks_when_one_fails():
    ok = "import os; assert os.environ['WORLD_SIZE'] == '3' and os.environ['MASTER_PORT']"
    assert run.launch([sys.executable, "-c", ok], 3) == 0
    bad = ("import os, sys, time; r = int(os.environ['RANK']); "
           "time.sleep(60 if r == 0 else 0); sys.exit(5 if r == 1 else 0)")
    import time

    t0 = time.perf_counter()
    assert run.launch([sys.executable, "-c", bad], 2) == 5
    assert time.perf_counter() - t0 < 30


class _Ev:
    """A kineto event's face as ``trace.reduce_events`` reads it."""

    def __init__(self, name, start, dur, dev=False, stream=7, annotation=False):
        self._n, self._s, self._d, self._dev, self._st, self._a = (name, start, dur, dev,
                                                                   stream, annotation)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a

    def device_resource_id(self):
        return self._st


def test_trace_reduction():
    evs = [_Ev("bench.window", 0, 1000), _Ev("field.adam", 100, 200), _Ev("field.adam", 600, 100),
           _Ev("field.rays", 350, 100), _Ev("aten::add", 110, 10),
           _Ev("k1", 100, 100, dev=True), _Ev("k2", 150, 100, dev=True, stream=8),
           _Ev("Memset (Device)", 500, 20, dev=True), _Ev("scatter_add_kernel", 520, 30, dev=True),
           _Ev("field.adam", 100, 300, dev=True, annotation=True), _Ev("k3", 990, 50, dev=True)]
    red = trace.reduce_events(evs, ("field.", "bench."))
    assert red["spans"]["field.adam"] == (pytest.approx(300e-9), 2)
    assert red["window_s"] == pytest.approx(1e-6)
    # union: [100, 250) + [500, 550) + [990, 1000) inside the window
    assert red["busy_s"] == pytest.approx(210e-9)
    assert "field.adam" not in red["kernels"]
    gaps = dict(red["idle_gaps"])
    assert gaps["field.rays"] == pytest.approx(250e-9)  # [250, 500): mid 375
    assert gaps["bench.window"] == pytest.approx(100e-9 + 440e-9)
    from benchmark.harness import readers

    rec = SimpleNamespace(trace=red, prefix="field")
    assert readers.steps_seen(rec) == 2
    assert readers.span_ms_per_step(rec, "rays") == pytest.approx(100e-9 * 1e3 / 2)
    assert readers.launch_time(rec, ["scatter_add"]) == (pytest.approx(50e-9), 1)


def test_compare_numbers():
    ref = {"loss": [2.0, 1.0, 0.5], "grad": {"a": [1.0, 3.0], "b": [2.0, 0.0]},
           "change": {"a": [0.1, 0.1], "b": [0.2, 0.0]}, "grid": [[950.0, 0.5, 2.0]],
           "ray_gap": 3e-7}
    same = compare.gaps(ref, ref)
    assert same == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0, "occ_gap": 0.0,
                    "ray_gap": 3e-7}
    prog = {"loss": [2.0, 1.1, 0.5], "grad": {"a": [1.0, 3.0], "b": [2.0, 1e-9]},
            "change": {"a": [0.1, 0.1], "b": [0.2, 5.0]}, "grid": [[950.0, 0.5, 2.0 * 1.01]]}
    g = compare.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_gap"] == pytest.approx(1e-9 / 1.5)  # against the median leaf
    assert g["change_gap"] == pytest.approx(0.0)  # b's quiet scene left out
    assert g["occ_gap"] == pytest.approx(np.log(1.01) / 3)  # the mean over the cells
    limits = {"loss_gap": 0.2, "grad_gap": 1e-6, "change_gap": 1e-6, "occ_gap": 0.1,
              "ray_gap": 1e-6}
    ok, rows = compare.verdict(g, limits)
    assert ok and [r[0] for r in rows] == list(compare.NUMBERS)
    assert not compare.verdict({**g, "loss_gap": float("nan")}, limits)[0]
    assert not compare.verdict({k: v for k, v in g.items() if k != "ray_gap"}, limits)[0]
    # a cell without a density (0, or below it) is no density: it fails
    assert compare.gaps({**prog, "grid": [[950.0, 0.0, 2.0]]}, ref)["occ_gap"] == np.inf


def test_ray_gap_recovers_views_and_pixels():
    import torch

    from benchmark.reference import plain_field
    from benchmark.traffic import draws

    cfg = {"n_scenes": 2, "n_rays": 64, "n_samples": 4, "occ_res": 8, "device_data": True}
    traffic = {"n_views": 3, "hw": [16, 16], "n_blobs": 2, "steps_per_call": 2}
    inp = draws.make(cfg, traffic, SEED, torch.device("cpu"))
    o, d, rgb, _ = draws.batch(inp, 1)
    gap = plain_field.ray_gap(inp.poses, inp.intrinsics, inp.images, inp.hw, [(o, d, rgb)])
    assert gap < 1e-5
    for bad in ((o, d, rgb.roll(1, dims=1)), (o.flip(1), d, rgb), (o, -d, rgb)):
        assert plain_field.ray_gap(inp.poses, inp.intrinsics, inp.images, inp.hw, [bad]) > 1e-2


def test_setup_is_outside_the_repo_state(tmp_path):
    # the cache directories are relative: inside the checkout
    assert run.CACHES and all(not os.path.isabs(v) for v in run.CACHES.values())
