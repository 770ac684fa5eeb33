"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix; the harness finds:

* ``benchmark/configs/<config>.json`` (the manifest's ``file``): the
  configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
* ``benchmark/workloads/<cell>.json``: the entry the window drives
  (``benchmark/entries/<entry>.py``) and the limits of the numbers that
  decide ``correct``;
* ``benchmark/metrics/<metric>.py``: the metric's reader; where there is
  no such file, the reader of its family, ``<family>.py``, the family being
  the name up to its first dot. Metrics of one quantity that differ only in
  the end-to-end metric they move (``encode_ms`` for the field's
  ``memory_peak_gib``, ``encode_ms.fleet`` for ``rays_per_s.fleet``) share
  one reader.

Adding a configuration, a cell or a metric adds files and entries; no file
that is there changes.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the manifest with its files; ``KeyError`` if the
    manifest has no such cell."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
                workload=_json(os.path.join(bench, "workloads", f"{name}.json")),
                end_to_end=[m for m in man["end_to_end"] if applies(m, name)],
                per_layer=[m for m in man["per_layer"] if applies(m, name)])


def metric_path(name: str, root: str = ROOT) -> str:
    """The reader of the metric ``name``: its own file, else its family's."""
    d = os.path.join(root, "benchmark", "metrics")
    own = os.path.join(d, f"{name}.py")
    return own if os.path.exists(own) else os.path.join(d, f"{name.split('.')[0]}.py")
