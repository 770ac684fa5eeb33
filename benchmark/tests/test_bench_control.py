"""The comparison that decides ``correct`` fails where it must: the control
(the reference one precision below the configuration's, in the program's
place) and each fault a training cell can have, planted under a run of the
harness. On the CPU at the tiny size, and on the card at the cell's size."""
from argparse import Namespace

import pytest

from benchmark import control, run
from benchmark.harness import compare, manifest
from benchmark.tests.conftest import TINY

SEEDS = (5, 2 ** 31 + 7)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(tiny_cell, name, seed):
    import torch

    cell = tiny_cell(name)
    got = control.readings_of(cell, seed, torch.device("cpu"))
    for kind in ("control", "half_batch"):
        ok, rows = compare.verdict(got[kind], cell.workload["limits"])
        assert not ok, (kind, rows)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_under_a_run_fails(tiny_cell, name, fault):
    import torch

    cell = tiny_cell(name)
    with control.planted(fault):
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
