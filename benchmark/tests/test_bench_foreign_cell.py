"""A training cell that is not a field, judged by the harness as it stands:
a small Conv3d model trained by ``torch.optim.Adam`` (``toy_entry.py``, the
program side) against the same model under a hand-written Adam
(``toy_reference.py``). The cell brings its own step span (``optimizer``)
and a number of its own (``out_gap``, from the reference's ``gaps``);
neither needs an edit of ``benchmark/harness/``, ``run.py`` or
``control.py``. The test installs the two modules as
``benchmark.entries.toy_train`` and ``benchmark.reference.toy_conv``, so no
cell is added to ``BENCHMARK.json``. On the CPU, as a dry run."""
import math
import sys
from argparse import Namespace

import pytest

from benchmark import control, run
from benchmark.harness import compare
from benchmark.harness.manifest import Cell
from benchmark.tests import toy_entry, toy_reference

SEED = 2 ** 31 + 4321
CONFIG = {"name": "toy_conv", "channels": 3, "hidden": 8, "lr": 1e-2,
          "control_precision": "bf16"}
TRAFFIC = {"batch": 4, "size": 6, "steps_per_call": 4}
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4, "out_gap": 1e-4}
END_TO_END = [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
               "source": "host_clock"}]
PER_LAYER = [{"name": f"{m}_ms", "unit": "ms", "better": "lower", "source": "program_span",
              "layer": "toy", "moves": "setup_s"} for m in ("backward", "adam")]


@pytest.fixture
def toy_cell(monkeypatch):
    """``toy_cell(limits)``: the cell, with its two modules installed."""
    import torch

    torch.set_num_threads(2)
    monkeypatch.setitem(sys.modules, "benchmark.entries.toy_train", toy_entry)
    monkeypatch.setitem(sys.modules, "benchmark.reference.toy_conv", toy_reference)

    def make(limits=LIMITS):
        return Cell(name="toy_conv_train", chips=1, config_name="toy_conv", config=dict(CONFIG),
                    traffic=dict(TRAFFIC), workload={"entry": "toy_train", "limits": dict(limits)},
                    end_to_end=END_TO_END, per_layer=PER_LAYER)

    return make


def _dry_run(cell, traced=0, seed=SEED):
    import torch

    return run.run(Namespace(workload=cell.name, seed=seed, seconds=0.001, trace=traced), cell,
                   device_override=torch.device("cpu"))


def test_foreign_cell_is_correct(toy_cell):
    cell = toy_cell()
    result = _dry_run(cell)
    assert result["correct"] is True, result["compared"]
    assert list(result["compared"]) == list(LIMITS)
    assert all(c["value"] <= c["limit"] for c in result["compared"].values())
    assert result["attempted"] == TRAFFIC["steps_per_call"] and result["failed"] == 0
    assert result["window"]["unit"] == "samples" and "trace" not in result
    assert set(result["metrics"]) == {"setup_s"}


def test_foreign_cell_traced(toy_cell):
    """Its steps are counted by its own step span; a span metric of a
    family the fields share reads its own prefix's span, and one whose
    span it lacks (``adam``) is left out."""
    result = _dry_run(toy_cell(), traced=1)
    assert result["correct"] is True
    assert result["trace"]["step_spans_seen"] == result["trace"]["steps_run"] > 0
    assert result["metrics"]["backward_ms"]["value"] > 0
    assert "adam_ms" not in result["metrics"]


def test_fault_in_its_own_number_fails(toy_cell):
    """An altered prediction, which only the configuration's own number
    reads, makes the cell not correct."""
    with toy_entry.planted("altered_output"):
        result = _dry_run(toy_cell())
    assert result["correct"] is False
    got = result["compared"]
    assert got["out_gap"]["value"] > got["out_gap"]["limit"]
    assert all(got[k]["value"] <= got[k]["limit"] for k in ("loss_gap", "grad_gap", "change_gap"))


def test_number_without_a_limit_fails(toy_cell):
    """A number that no limit judges is an error, not a pass."""
    limits = {k: v for k, v in LIMITS.items() if k != "out_gap"}
    result = _dry_run(toy_cell(limits))
    assert result["correct"] is False
    assert list(result["compared"]) == [*limits, "out_gap"]
    assert result["compared"]["out_gap"]["limit"] is None


def test_limit_without_a_number_fails(toy_cell):
    """A limit on a number that the two sides do not give (a field's
    ``occ_gap``, which needs grids) fails."""
    result = _dry_run(toy_cell({**LIMITS, "occ_gap": 1e-3}))
    assert result["correct"] is False
    assert math.isnan(result["compared"]["occ_gap"]["value"])


def test_reading_of_one_side_raises(toy_cell, monkeypatch):
    inner = toy_reference.readings

    def without_grad(*args, **kwargs):
        return {k: v for k, v in inner(*args, **kwargs).items() if k != "grad"}

    monkeypatch.setattr(toy_reference, "readings", without_grad)
    with pytest.raises(ValueError, match="only the program gives 'grad'"):
        _dry_run(toy_cell())


def test_control_on_the_foreign_cell(toy_cell):
    """``control.py`` on a configuration that is not a field: the control
    (bf16) and the reference's half batch fail, with no ``ray_gap``; the
    entry's own fault fails under a run of the harness."""
    import torch

    cell = toy_cell()
    got = control.readings_of(cell, SEED, torch.device("cpu"))
    assert list(got) == ["seed", "control", "half_batch"]
    for kind in ("control", "half_batch"):
        assert list(got[kind]) == ["loss_gap", "grad_gap", "change_gap", "out_gap"]
        assert not compare.verdict(got[kind], LIMITS)[0], got[kind]
    faults = control.program_faults(cell, SEED, torch.device("cpu"))
    assert faults["altered_output"]["out_gap"] > LIMITS["out_gap"]
