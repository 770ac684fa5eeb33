"""``BENCHMARK.json`` against the rules its format must keep, and
the files it names: every configuration, traffic mix, cell and metric has
its own file, found by name."""
import json
import os
import re

import pytest

from benchmark.harness import compare, manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}

MAN = manifest.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(MAN) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + CELLS + [m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    for kind in (MAN["configs"], MAN["workloads"], METRICS):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["control_precision"] in ("tf32", "fp8")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                           f"{c['name']}.py"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = {x["name"]: x for x in MAN["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    c = manifest.load_cell(cell)
    assert os.path.exists(os.path.join(ROOT, "benchmark", "entries",
                                       f"{c.workload['entry']}.py"))
    assert set(c.workload["limits"]) == set(compare.NUMBERS)
    assert all(0 < float(v) < 1 for v in c.workload["limits"].values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert os.path.exists(manifest.metric_path(m["name"]))


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and manifest.applies(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_chips_and_check_length():
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90
    # seconds a cell to compile, 1200 spare
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
