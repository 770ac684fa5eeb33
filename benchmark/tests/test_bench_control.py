"""The comparison that decides ``correct`` fails where it must: the control
(the reference one precision below the configuration's, in the program's
place) and each fault a training cell can have, planted under a run of the
harness. On the CPU at the tiny size, and on the card at the cell's size."""
import sys
import types
from argparse import Namespace

import pytest

from benchmark import control, run
from benchmark.entries import field_common
from benchmark.harness import compare, manifest
from benchmark.tests.conftest import TINY

SEEDS = (5, 2 ** 31 + 7)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(tiny_cell, name, seed):
    import torch

    cell = tiny_cell(name)
    got = control.readings_of(cell, seed, torch.device("cpu"))
    assert list(got) == ["seed", "control", "half_batch"]
    for kind in ("control", "half_batch"):
        # the reference in the program's place makes no rays of its own
        assert got[kind]["ray_gap"] == 0.0
        ok, rows = compare.verdict(got[kind], cell.workload["limits"])
        assert not ok, (kind, rows)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", field_common.FAULTS)
def test_fault_under_a_run_fails(tiny_cell, name, fault):
    import torch

    cell = tiny_cell(name)
    entry = control.faults_of(cell)
    assert fault in entry.FAULTS
    with entry.planted(fault):
        result = run.run(Namespace(workload=name, seed=SEEDS[1], seconds=0.001, trace=0),
                         cell, device_override=torch.device("cpu"))
    assert result["correct"] is False, result["compared"]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_at_cell_size(card, name):
    cell = manifest.load_cell(name)
    got = control.readings_of(cell, 4300000001, card)
    for kind in ("control", "half_batch"):
        ok, rows = compare.verdict(got[kind], cell.workload["limits"])
        assert not ok, (kind, rows)


def test_entry_without_faults_refused(tiny_cell, monkeypatch, capsys):
    """An entry that names no faults is a plain error, before any field
    function runs."""
    cell = tiny_cell("field_hash_rgb")
    cell.workload["entry"] = "no_faults"
    monkeypatch.setitem(sys.modules, "benchmark.entries.no_faults", types.ModuleType("no_faults"))
    with pytest.raises(ValueError, match="names no faults"):
        control.readings_of(cell, SEEDS[0], None)
    with pytest.raises(ValueError, match="names no faults"):
        control.program_faults(cell, SEEDS[0], None)
    monkeypatch.setattr(manifest, "load_cell", lambda name: cell)
    assert control.main(["--workload", "field_hash_rgb", "--seeds", "1"]) == 2
    assert "names no faults" in capsys.readouterr().err
