"""The port's eval modes through its CLIs, chained as a user runs them, in
f32 on the CPU with the port's own seeded weights: ``run_fcos --mode eval``
in both box modes, ``run_rpn --mode eval --save_results`` exporting the
proposals into a dataset's ``rois/``, then ``run_rcnn --mode eval`` on
those rois. Each writes ``eval.json`` with every key the JAX trainers'
eval writes, all finite (``tests/test_torch_eval.py`` holds the values to
the JAX package's)."""
import json
import os

import numpy as np
import torch

from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn
from tests.test_torch_eval import PROPOSAL_KEYS, RCNN_KEYS, data  # noqa: F401  (fixture)

torch.set_num_threads(2)


def test_cli_eval_chain_on_the_cpu(data, tmp_path):
    small = ["--device", "cpu", "--dtype", "float32", "--num_convs", "2"]
    for rotated, root in ((False, data["aabb"]), (True, data["obb"])):
        out = tmp_path / f"fcos_{int(rotated)}"
        run_fcos.main(small + [
            "--mode", "eval", "--features_path", os.path.join(root, "features"),
            "--boxes_path", os.path.join(root, "boxes_obb" if rotated else "metadata"),
            "--dataset_split", os.path.join(root, "val_all.json"), "--save_path", str(out),
            "--save_results", "--pre_nms_top_n", "64", "--fpn_post_nms_top_n", "64"]
            + (["--rotated_bbox"] if rotated else []))
        m = json.load(open(out / "eval.json"))
        assert sorted(m) == PROPOSAL_KEYS and all(np.isfinite(v) for v in m.values())
        with np.load(out / "proposals" / "scene_0000.npz") as z:
            assert z["proposals"].shape[1] == (7 if rotated else 6)
    root = data["aabb"]
    export = tmp_path / "rpn"
    run_rpn.main(["--device", "cpu", "--dtype", "float32", "--mode", "eval",
                  "--features_path", os.path.join(root, "features"),
                  "--boxes_path", os.path.join(root, "metadata"),
                  "--dataset_split", os.path.join(root, "val_all.json"),
                  "--save_path", str(export), "--save_results",
                  "--rpn_pre_nms_top_n", "64", "--rpn_post_nms_top_n", "48"])
    assert sorted(json.load(open(export / "eval.json"))) == PROPOSAL_KEYS
    # the RCNN reads the RPN's rois beside the dataset's features and masks
    chained = tmp_path / "chained"
    os.makedirs(chained)
    for sub in ("features", "masks", "metadata"):
        os.symlink(os.path.join(root, sub), chained / sub)
    os.symlink(export / "rois", chained / "rois")
    run_rcnn.main(["--device", "cpu", "--dtype", "float32", "--mode", "eval",
                   "--dataset_root", str(chained),
                   "--dataset_split", os.path.join(root, "val_two.json"),
                   "--save_path", str(tmp_path / "rcnn")])
    m = json.load(open(tmp_path / "rcnn" / "eval.json"))
    assert sorted(m) == RCNN_KEYS
    assert all(np.isfinite(v) for k, v in m.items() if k != "box_AP_25_per_class")
    assert len(os.listdir(tmp_path / "rcnn" / "masks")) == 2
