"""``--mode train`` of the port's three detector CLIs on the CPU: one epoch
each on a 4-scene dataset the port's ``write_dataset`` writes at 32x32x24,
evaluated after the epoch, chained as a user runs them (the RCNN grafts the
FCOS run's backbone with ``--rpn_ckpt``). Each prints the loop's summary as
JSON and leaves a checkpoint with its config embedded. The models take the
smaller ``vgg_AF`` backbone, and each checkpoint is removed once checked:
a full-width checkpoint with its Adam moments is about 0.9 GB."""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn
from instance_nerf_tpu_torch.data.synthetic import write_dataset
from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(2)

GRID = (32, 32, 24)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{"aabb": root, "obb": root}: 4 scenes each, the rotated ones in the
    room style."""
    out = {}
    for kind, rotated in (("aabb", False), ("obb", True)):
        root = str(tmp_path_factory.mktemp(kind))
        write_dataset(root, num_scenes=4, grid_size=GRID, seed=1,
                      style="room" if rotated else "boxes", rotated=rotated)
        out[kind] = root
    return out


def _train(main, argv, save_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--mode", "train", "--device", "cpu", "--num_epochs", "1", "--eval_interval", "1",
              "--batch_size", "2", "--backbone_type", "vgg_AF", "--save_path", save_path]
             + argv)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summary["epochs"] == 1 and summary["steps"] >= 1
    assert all(np.isfinite(v) for v in summary["last"].values())
    assert summary["eval"] is not None
    mgr = CheckpointManager(save_path)
    assert mgr.latest_step() == summary["gstep"]
    _, meta = mgr.restore_any()
    return summary, meta


def _proposal_args(root, boxes):
    return ["--features_path", os.path.join(root, "features"),
            "--boxes_path", os.path.join(root, boxes),
            "--dataset_split", os.path.join(root, "dataset_split.json"), "--resolution", "32",
            "--max_gt", "8"]


@pytest.fixture(scope="module")
def fcos_run(data, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fcos"))
    yield _train(run_fcos.main, _proposal_args(data["aabb"], "metadata")
                 + ["--dtype", "float32", "--num_convs", "2"], out) + (out,)
    shutil.rmtree(out)


def test_run_fcos_train(fcos_run):
    summary, meta, _ = fcos_run
    assert meta["config"]["num_convs"] == 2 and meta["step"] == summary["gstep"]
    assert set(summary["last"]) == {"loss_cls", "loss_reg", "loss_centerness", "num_pos", "total"}
    assert "recall_50" in summary["eval"]


def test_run_rpn_train_rotated(data, tmp_path):
    summary, meta = _train(run_rpn.main, _proposal_args(data["obb"], "boxes_obb")
                           + ["--rotated_bbox", "--dtype", "float32",
                              "--batch_size_per_mesh", "64"], str(tmp_path))
    assert meta["config"]["rotated_bbox"] and meta["config"]["proj2d_loss_weight"] == 1.0
    assert set(summary["last"]) == {"loss_objectness", "loss_rpn_box_reg",
                                    "loss_rpn_box_reg_2d", "total"}
    shutil.rmtree(tmp_path)


def test_run_rcnn_train_grafts_the_fcos_backbone(data, fcos_run, tmp_path):
    _, _, fcos_dir = fcos_run
    summary, meta = _train(run_rcnn.main, [
        "--dataset_root", data["aabb"], "--resolution", "32", "--dtype", "float32",
        "--rpn_ckpt", fcos_dir, "--batch_size_per_image", "32", "--max_rois", "16",
        "--max_gt", "4"], str(tmp_path))
    assert meta["config"]["rpn_ckpt"] == fcos_dir
    assert {"loss_classifier", "loss_box_reg", "loss_mask"} <= set(summary["last"])
    assert "mask_mAP_25" in summary["eval"]
    shutil.rmtree(tmp_path)
