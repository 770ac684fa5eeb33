"""The port's torch-native ``CheckpointManager`` (``train/checkpoints.py``):
retention of the newest ``keep`` steps, the best checkpoint by its metric
across restarts, committed steps only, restore against a template, the
embedded config, loading params from a checkpoint directory or a flax
``.npz``, and ``--resume`` of a trainer at its saved step.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from instance_nerf_tpu_torch.data.synthetic import write_dataset
from instance_nerf_tpu_torch.train.checkpoints import (
    CheckpointManager,
    load_embedded_config,
    load_params,
    load_params_into,
)
from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

torch.set_num_threads(2)


def _state(v):
    return {"params": {"w": torch.full((2, 3), float(v))}, "opt_state": {"count": v},
            "step": v}


def test_retention_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step), config={"lr": 0.1})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    state, meta = mgr.restore_any()
    assert meta["step"] == 4 and torch.equal(state["params"]["w"], torch.full((2, 3), 4.0))
    state, _ = mgr.restore_any(step=3)
    assert state["step"] == 3


def test_best_survives_restarts_and_only_committed_steps_count(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, best_metric="recall_50")
    for step, r in ((1, 0.2), (2, 0.5), (3, 0.4)):
        mgr.save(step, _state(step), metrics={"recall_50": r, "ap": [None, 0.1]})
    assert mgr.all_steps() == [3]
    best, meta = mgr.restore_any(best=True)
    assert best["step"] == 2 and meta["metric_value"] == 0.5
    assert meta["metrics"]["ap"] == [None, 0.1]
    again = CheckpointManager(str(tmp_path), keep=1, best_metric="recall_50")
    assert again.best_value == 0.5
    again.save(4, _state(4), metrics={"recall_50": 0.45})
    assert again.restore_any(best=True)[0]["step"] == 2
    # best/ holds hard links, and outlives its step's removal
    assert os.stat(tmp_path / "best" / "state.pt").st_nlink == 1
    # a save cut off before its meta.json is never offered
    os.makedirs(tmp_path / "step_9")
    torch.save(_state(9), tmp_path / "step_9" / "state.pt")
    assert again.latest_step() == 4


def test_restore_checks_the_template_and_config_is_embedded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    cfg = {"lr": 3e-4, "fpn_strides": (4, 8, 16, 32), "ap_top_n": None}
    mgr.save(7, _state(7), config=cfg)
    state, meta = mgr.restore(_state(0))
    assert state["step"] == 7 and meta["config"]["fpn_strides"] == [4, 8, 16, 32]
    assert load_embedded_config(str(tmp_path)) == json.loads(json.dumps(meta["config"]))
    bad = _state(0)
    bad["params"]["w"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="params"):
        mgr.restore(bad)
    with pytest.raises(ValueError, match="keys"):
        mgr.restore({"params": {}})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_any()


def test_load_params_from_a_directory_or_a_flax_npz(tmp_path):
    model = torch.nn.Linear(3, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    sd = {k: torch.randn_like(v) for k, v in model.state_dict().items()}
    mgr.save(1, {"params": sd, "step": 1})
    assert torch.equal(load_params(str(tmp_path / "ck"))["weight"], sd["weight"])
    load_params_into(model, str(tmp_path / "ck"), from_jax=None)
    assert torch.equal(model.weight, sd["weight"])
    np.savez(tmp_path / "p.npz", **{"params/dense/kernel": np.ones((3, 2), np.float32),
                                    "params/dense/bias": np.zeros(2, np.float32)})

    def from_jax(tree):
        d = tree["params"]["dense"]
        return {"weight": torch.from_numpy(d["kernel"].T.copy()),
                "bias": torch.from_numpy(d["bias"])}

    load_params_into(model, str(tmp_path / "p.npz"), from_jax)
    assert float(model.weight.detach().sum()) == 6.0


def test_fcos_train_loop_resumes_at_the_saved_step(tmp_path):
    """Two epochs in two calls: the first stops after one (one checkpoint),
    the second resumes at that step with the optimizer's state."""
    root = str(tmp_path / "data")
    write_dataset(root, num_scenes=4, grid_size=(32, 32, 24), seed=1)
    kw = dict(features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, "metadata"), save_path=str(tmp_path / "out"),
              dtype="float32", resolution=32, batch_size=2, num_epochs=2, eval_interval=1,
              keep_checkpoints=3, num_convs=1, max_gt=8, backbone_type="vgg_AF")
    first = FCOSTrainer(FCOSConfig(stop_after_epochs=1, **kw), device="cpu").train_loop()
    steps = first["steps"]
    assert first["epochs"] == 1 and steps == 2 and first["gstep"] == steps
    mgr = CheckpointManager(kw["save_path"])
    assert mgr.all_steps() == [steps]
    saved, meta = mgr.restore_any()
    assert saved["opt_state"]["count"] == steps and meta["config"]["num_convs"] == 1
    second = FCOSTrainer(FCOSConfig(resume=True, **kw), device="cpu")
    out = second.train_loop()
    assert out["start_epoch"] == 1 and out["epochs"] == 1 and out["gstep"] == 2 * steps
    assert mgr.all_steps() == [steps, 2 * steps]
    assert second.state.tx.count == 2 * steps == second.state.step
    assert all(np.isfinite(v) for v in out["last"].values())
    shutil.rmtree(kw["save_path"])  # about 0.5 GB a checkpoint
