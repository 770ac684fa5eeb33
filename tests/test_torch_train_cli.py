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


# -- device_data and steps_per_call -----------------------------------------


class _Saves:
    """A checkpoint manager that records the steps it is asked to save."""

    def __init__(self):
        self.steps = []

    def save(self, step, state, config=None, metrics=None):
        self.steps.append(step)


def _fcos_cfg(root, boxes, **kw):
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig

    base = dict(features_path=os.path.join(root, "features"),
                boxes_path=os.path.join(root, boxes),
                dataset_split=os.path.join(root, "dataset_split.json"), resolution=32,
                max_gt=8, dtype="float32", backbone_type="vgg_AF", num_convs=1,
                rot_scale_prob=0.0)
    return FCOSConfig(**{**base, **kw})


@pytest.mark.parametrize("kind", ["aabb", "obb"])
def test_fcos_device_batches_equal_the_host_loaders(data, kind):
    """A batch gathered from the card's store and augmented there equals the
    host loader's augmented batch under the same uniforms (rot90, flip W,
    flip L a scene; the host draws a fourth, the rotate-and-scale one, for
    OBB boxes), its grids rounded to bf16 as the store holds them."""
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSTrainer

    obb = kind == "obb"
    tt = FCOSTrainer(_fcos_cfg(data[kind], "boxes_obb" if obb else "metadata",
                               rotated_bbox=obb, device_data=True), device="cpu")
    ds = tt.make_dataset("train")
    store = tt.device_store(ds)
    assert store["grids"].dtype == torch.bfloat16 and store["grids"].shape[0] == len(ds)
    n_draws = 4 if obb else 3
    seen = set()
    for seed in range(6):
        idx = [1, 0, 1]
        ds.rng = np.random.default_rng(seed)
        host = ds.batch(idx, (32,) * 3, max_gt=8, box_dim=7 if obb else 6, augment=True)
        u = np.random.default_rng(seed).random((3, n_draws))[:, :3]
        seen |= {tuple(r) for r in (u < 0.5)}
        got = tt.store_batch(store, idx, torch.from_numpy(u))
        want_g = torch.from_numpy(host.grids).to(torch.bfloat16).float()
        assert torch.equal(got[0], want_g)
        np.testing.assert_array_equal(got[1].numpy(), host.grid_sizes)
        np.testing.assert_array_equal(got[3].numpy(), host.gt_mask)
        # the gt slots (the padding slots are moved too, as in the JAX
        # trainer; the losses mask them)
        m = host.gt_mask
        np.testing.assert_allclose(got[2].numpy()[m], host.gt_boxes[m], rtol=0, atol=1e-5)
    assert len(seen) >= 6  # most combinations of rot90 and the two flips


def test_rcnn_device_batches_equal_the_host_loaders(data):
    """The RCNN's store: grids in bf16, voxel masks bit-packed; a gathered
    batch equals the host batch (its grids rounded to bf16). With a frozen
    backbone the store holds the FPN levels of those grids instead."""
    from instance_nerf_tpu_torch.data.datasets import SegmentationDataset
    from instance_nerf_tpu_torch.train.rcnn_trainer import BATCH_FIELDS, RCNNConfig, RCNNTrainer

    kw = dict(dataset_root=data["aabb"], resolution=32, dtype="float32",
              backbone_type="vgg_AF", max_rois=16, max_gt=4, device_data=True)
    tt = RCNNTrainer(RCNNConfig(**kw), device="cpu")
    tt.init_state()
    ds = SegmentationDataset("train", data["aabb"], None)
    store = tt.device_store(ds)
    assert store["vmasks_packed"].shape == (len(ds), 4, 32 ** 3 // 8)
    host = ds.batch([1, 0], (32,) * 3, max_gt=4, max_rois=16)
    got = tt.store_batch(store, [1, 0])
    assert torch.equal(got[0], torch.from_numpy(host.grids).to(torch.bfloat16).float())
    for t, f in zip(got[1:], BATCH_FIELDS[1:]):
        np.testing.assert_array_equal(t.numpy(), getattr(host, f), err_msg=f)
    assert got[-1].sum() > 0
    frozen = RCNNTrainer(RCNNConfig(freeze_backbone=True, **kw), device="cpu")
    frozen.init_state()
    fstore = frozen.device_store(ds)
    assert "grids" not in fstore
    with torch.no_grad():
        want = frozen.model.features(got[0][[1]])
    for a, b in zip(frozen.store_batch(fstore, [0])[0], want):
        assert torch.equal(a, b)


def test_steps_per_call_equals_single_steps(tmp_path):
    """``steps_per_call = 4`` runs the same four steps as four single calls
    (the same params after them), with the JAX loop's cadence: a log line
    when the global step passed a multiple of ``log_interval`` in the call,
    the checkpoints at the same steps; ``device_data`` with it."""
    import logging

    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSTrainer

    root = str(tmp_path / "data")
    write_dataset(root, num_scenes=8, grid_size=GRID, seed=2)
    runs = {}
    for spc, dev_data in ((1, False), (4, False), (4, True), (1, True)):
        # no split file: all 8 scenes train, 4 steps of 2, no val eval
        tt = FCOSTrainer(_fcos_cfg(root, "metadata", dataset_split="", batch_size=2,
                                   num_epochs=1, eval_interval=1, log_interval=3,
                                   steps_per_call=spc, device_data=dev_data), device="cpu")
        tt.ckpt = saves = _Saves()
        logged = []
        handler = logging.Handler()
        handler.emit = lambda r: logged.append(r.args[1]) if "step" in r.msg else None
        log = logging.getLogger("fcos_trainer")
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        try:
            out = tt.train_loop()
        finally:
            log.removeHandler(handler)
        runs[spc, dev_data] = out, saves.steps, logged, tt.model.state_dict()
    for dev_data in (False, True):
        (one, s1, l1, p1), (four, s4, l4, p4) = runs[1, dev_data], runs[4, dev_data]
        assert one["gstep"] == four["gstep"] == one["steps"] == 4
        assert (one["calls"], four["calls"]) == (4, 1)
        assert s1 == s4 == [4, 4]  # the eval epoch's, then the end's
        assert (l1, l4) == ([3], [4])
        assert all(torch.equal(p1[k], p4[k]) for k in p1)
    # the device store draws its own batches (another permutation stream)
    assert not all(torch.equal(runs[1, False][3][k], runs[1, True][3][k])
                   for k in runs[1, True][3])


def test_device_data_refuses_the_host_rotate_and_scale(data):
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSTrainer

    tt = FCOSTrainer(_fcos_cfg(data["obb"], "boxes_obb", rotated_bbox=True, device_data=True,
                               rot_scale_prob=0.5), device="cpu")
    with pytest.raises(ValueError, match="rotate\\+scale"):
        tt.train_loop()


def test_run_fcos_and_rcnn_train_with_device_data(data, tmp_path):
    """``--device_data --steps_per_call 4`` through both CLIs: the step count
    of the epoch and the checkpoint at its end."""
    fcos_out = str(tmp_path / "fcos")
    summary, meta = _train(run_fcos.main, _proposal_args(data["aabb"], "metadata")
                           + ["--dtype", "float32", "--num_convs", "1", "--device_data",
                              "--rot_scale_prob", "0", "--steps_per_call", "4",
                              "--batch_size", "1"], fcos_out)
    assert meta["config"]["device_data"] and summary["steps"] == 2 and summary["calls"] == 1
    shutil.rmtree(fcos_out)
    rcnn_out = str(tmp_path / "rcnn")
    summary, meta = _train(run_rcnn.main, [
        "--dataset_root", data["aabb"], "--resolution", "32", "--dtype", "float32",
        "--batch_size_per_image", "32", "--max_rois", "16", "--max_gt", "4", "--device_data",
        "--steps_per_call", "4", "--batch_size", "1"], rcnn_out)
    assert meta["config"]["steps_per_call"] == 4 and summary["steps"] == 2
    assert summary["calls"] == 1
    shutil.rmtree(rcnn_out)


@pytest.mark.parametrize("backbone", ["resnet", "swin_t"])
def test_cli_modes_with_new_backbones(data, tmp_path, backbone):
    """``--backbone_type resnet`` and ``swin_t`` (full width) through every
    mode of the three CLIs that runs on the CPU, at 32^3: ``check_arch``,
    ``eval`` (metrics written to ``eval.json``) and one train step (no
    checkpoint; ``tests/test_torch_hygiene.py`` trains the RPN with
    ``resnet`` and FCOS with ``swin_t``). ``benchmark`` and ``profile``
    time the card and refuse the CPU."""
    root = data["aabb"]
    prop = _proposal_args(root, "metadata")
    common = ["--device", "cpu", "--dtype", "float32", "--backbone_type", backbone]
    clis = {"fcos": (run_fcos.main, prop + ["--num_convs", "1"]),
            "rpn": (run_rpn.main, prop + ["--batch_size_per_mesh", "64"]),
            "rcnn": (run_rcnn.main, ["--dataset_root", root, "--resolution", "32",
                                     "--max_rois", "16", "--max_gt", "4",
                                     "--batch_size_per_image", "32"])}
    trained = {"resnet": "rpn", "swin_t": "fcos"}[backbone]
    for name, (main, argv) in clis.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(common + argv + ["--mode", "check_arch"])
        assert json.loads(buf.getvalue().strip().splitlines()[-1])["device"] == "cpu"
        out = str(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()):
            main(common + argv + ["--mode", "eval", "--save_path", out])
        with open(os.path.join(out, "eval.json")) as f:
            metrics = json.load(f)
        assert metrics and all(np.isfinite(v) for v in metrics.values()
                               if isinstance(v, float)), name
        if name != trained:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(common + argv + ["--mode", "train", "--num_epochs", "1",
                                      "--eval_interval", "2", "--batch_size", "2"])
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            assert summary["steps"] == 1 and np.isfinite(summary["last"]["total"]), name
    with pytest.raises(RuntimeError, match="needs device='cuda'"):
        run_fcos.main(common + prop + ["--mode", "benchmark"])
