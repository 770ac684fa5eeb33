"""Import hygiene of the PyTorch port: no module of ``instance_nerf_tpu_torch``
and not ``chip_smoke.py`` (nor ``tests/dist_worker.py``, the multi-process
tests' ranks) may import JAX, flax or the JAX package; entry
points run on the card unless asked for the CPU; the kernel wrappers take a
CPU tensor to the plain version without counting a launch."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import instance_nerf_tpu_torch
from instance_nerf_tpu_torch.kernels import coarse_occ_cuda, nms_cuda, scatter_cuda

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(instance_nerf_tpu_torch.__file__)
FORBIDDEN = ("jax", "flax", "instance_nerf_tpu")


def _modules():
    names = ["instance_nerf_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="instance_nerf_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    # the multi-process tests' ranks run tests/dist_worker.py: it too imports
    # no JAX
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "dist_worker.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_has_every_slice_module():
    mods = set(_modules())
    for m in ("convert", "ops.boxes", "ops.coders", "ops.nms", "ops.roi_align",
              "ops.poolers", "ops.mask_paste", "kernels.nms_cuda", "kernels.build",
              "models.layers", "models.fpn", "models.backbones", "models.rcnn",
              "train.rcnn_trainer", "cli.run_rcnn",
              # slice 2: rotated anchor NeRF-RPN inference
              "ops.rotated_iou", "models.rpn", "train.rpn_trainer", "train.timing",
              "cli.run_rpn",
              # slice 3: instance-field training
              "models.hashgrid", "models.fast_encode", "models.render",
              "data.nerf_dataset", "kernels.scatter_cuda", "kernels.coarse_occ_cuda",
              "train.ngp_trainer",
              # slice 4: FCOS proposal inference and the eval modes
              "models.fcos", "train.fcos_trainer", "cli.run_fcos", "data.datasets",
              "data.augment", "data.synthetic", "eval.metrics",
              # slice 5a: detector training
              "ops.sampling", "ops.projection", "parallel.train_step",
              "train.checkpoints", "train.train_utils", "train.loop",
              # slice 5b: the Swin backbone (ResNet is in models.backbones)
              "models.swin",
              # slice 6: the field's CLIs, fleets, mask projection and match_seg
              "cli.run_instance_field", "cli.run_fleet", "train.multiscene",
              "parallel.ngp_train_step", "eval.instance_field_metrics", "data.png",
              "masks2d.project_masks", "masks2d.match_seg", "masks2d.coco_nyu40",
              # slice 7a: training over several cards
              "parallel.mesh", "data.prefetch",
              # slice 7c: the composed pipeline, the legacy classification
              # path, the FLOP / memory / profiling utilities, the scripts and
              # the rest of masks2d
              "pipeline", "ops.legacy_roi_pool", "models.legacy_classifier",
              "utils.flops", "utils.hbm", "utils.profiling", "utils.logging",
              "scripts.proposals2ngp", "scripts.render_heatmap",
              "scripts.visualize_rpn_input", "masks2d.refine_masks",
              "masks2d.async_predictor", "masks2d.run_mask2former",
              "masks2d.coco2nyu40_cli"):
        assert f"instance_nerf_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'instance_nerf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNTrainer
    from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer, NGPConfig
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer

    with pytest.raises(RuntimeError, match="CUDA"):
        RCNNTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        RPNTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        RPNTrainer(RPNConfig(rotated_bbox=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        InstanceFieldTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        InstanceFieldTrainer(NGPConfig(n_levels=2, table_size=2 ** 8), seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        instance_nerf_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_rcnn.main(["--mode", "check_arch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_rpn.main(["--mode", "check_arch", "--rotated_bbox"])
    with pytest.raises(RuntimeError, match="CUDA"):
        FCOSTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        FCOSTrainer(FCOSConfig(rotated_bbox=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fcos.main(["--mode", "check_arch", "--rotated_bbox"])
    for cli in (run_fcos, run_rpn, run_rcnn):  # the eval and train modes too
        for mode in ("eval", "train"):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(["--mode", mode])
    from instance_nerf_tpu_torch.cli import run_fleet, run_instance_field
    from instance_nerf_tpu_torch.masks2d import project_masks
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer

    for mode in ("train", "train_instance", "render", "extract_features", "benchmark"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_instance_field.main(["--mode", mode, "--n_levels", "2",
                                     "--log2_table_size", "8"])
    for mode in ("train", "train_instance", "benchmark"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_fleet.main(["--mode", mode, "--scenes", "nowhere"])
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiSceneFieldTrainer([], NGPConfig(n_levels=2, table_size=2 ** 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        project_masks.write_projections("nowhere", [[[0]]], [[[0.0]]], [], (1, 1, 0, 0),
                                        (1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        project_masks.project_voxel_masks(np.zeros((2, 2, 2), np.int32),
                                          np.zeros((2, 2, 2), np.float32), np.eye(4),
                                          (1, 1, 0, 0), (1, 1))
    from instance_nerf_tpu_torch import pipeline
    from instance_nerf_tpu_torch.models.legacy_classifier import LegacyProposalScorer

    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.main(["--workdir", "nowhere"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LegacyProposalScorer()


def test_nms_boxes_on_cpu_runs_plain_without_counting():
    before = nms_cuda.nms_boxes.launches
    boxes = torch.tensor([[0, 0, 0, 2, 2, 2], [0, 0, 0, 2, 2, 1.9],
                          [5, 5, 5, 6, 6, 6]], dtype=torch.float32)
    valid = torch.ones(3, dtype=torch.bool)
    keep = nms_cuda.nms_boxes(boxes, valid, 0.5)
    assert keep.tolist() == [True, False, True]
    assert torch.equal(keep, nms_cuda.nms_boxes_plain(boxes, valid, 0.5))
    assert nms_cuda.nms_boxes.launches == before


def test_nms_sweep_on_cpu_runs_plain_without_counting():
    before = nms_cuda.nms_sweep.launches
    iou = torch.tensor([[1.0, 0.8, 0.1], [0.8, 1.0, 0.9], [0.1, 0.9, 1.0]])
    valid = torch.ones(3, dtype=torch.bool)
    keep = nms_cuda.nms_sweep(iou, valid, 0.7)
    assert keep.tolist() == [True, False, True]  # box 1 suppressed, so 2 survives
    assert torch.equal(keep, nms_cuda.nms_sweep_plain(iou, valid, 0.7))
    assert nms_cuda.nms_sweep.launches == before


def test_scatter_add_on_cpu_runs_plain_without_counting():
    before = scatter_cuda.scatter_add.launches
    idx = torch.tensor([0, 2, 2, -1, 9], dtype=torch.int32)
    upd = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    out = scatter_cuda.scatter_add(idx, upd, 4)
    assert out.tolist() == [[6.0, 8.0], [0.0, 0.0], [6.0, 8.0], [8.0, 9.0]]
    table = torch.zeros((8, 2), requires_grad=True)
    scatter_cuda.gather_rows_kernel_grad(table, idx[:4].clamp(0, 7), 2, 1).sum().backward()
    assert float(table.grad.sum()) == 8.0
    assert scatter_cuda.scatter_add.launches == before


def test_coarse_occ_lookup_on_cpu_runs_plain_without_counting():
    before = coarse_occ_cuda.coarse_occ_lookup.launches
    grid = torch.zeros((4, 4, 4))
    grid[1, 2, 3] = 1.0
    cells = torch.tensor([[1, 2, 3], [0, 0, 0], [4, 2, 3]], dtype=torch.int32)
    assert coarse_occ_cuda.coarse_occ_lookup(cells, grid).tolist() == [1.0, 0.0, 0.0]
    assert coarse_occ_cuda.coarse_occ_lookup.launches == before


@pytest.fixture(scope="module")
def toy_data(tmp_path_factory):
    """A 4-scene dataset at 32x32x24 (2 train scenes), AABB and rotated."""
    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    out = {}
    for kind, rotated in (("aabb", False), ("obb", True)):
        root = str(tmp_path_factory.mktemp(kind))
        write_dataset(root, num_scenes=4, grid_size=(32, 32, 24), seed=1,
                      style="room" if rotated else "boxes", rotated=rotated)
        out[kind] = root
    return out


def _toy_argv(cli, root, boxes="metadata"):
    """The train mode at toy size: 32^3, batch 2, one epoch, no val eval,
    no checkpoint."""
    argv = ["--mode", "train", "--device", "cpu", "--resolution", "32", "--batch_size", "2",
            "--num_epochs", "1", "--eval_interval", "2", "--dtype", "float32",
            "--max_gt", "4"]
    if cli == "run_rcnn":
        return argv + ["--dataset_root", root, "--max_rois", "16",
                       "--batch_size_per_image", "32"]
    argv += ["--features_path", os.path.join(root, "features"),
             "--boxes_path", os.path.join(root, boxes),
             "--dataset_split", os.path.join(root, "dataset_split.json")]
    return argv + (["--batch_size_per_mesh", "64"] if cli == "run_rpn" else [])


def _summary(main, argv):
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_rpn_cli_modes_of_later_slices_raise(toy_data):
    """The options that slice 5b brought now train at toy size on the CPU:
    the ResNet and Swin backbones and more than one step per dispatch; OBB
    RCNN builds its 8-delta head and its step raises where the JAX step
    fails. Only the multi-card option (``--n_spatial > 1``) still raises,
    naming slice 7."""
    from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn

    root = toy_data["aabb"]
    for cli, argv in ((run_rpn, ["--backbone_type", "resnet"]),
                      (run_fcos, ["--backbone_type", "swin_t"]),
                      (run_fcos, ["--steps_per_call", "2", "--backbone_type", "vgg_AF"]),
                      (run_rcnn, ["--steps_per_call", "2", "--backbone_type", "vgg_AF"])):
        name = cli.__name__.rsplit(".", 1)[-1]
        out = _summary(cli.main, _toy_argv(name, root) + argv)
        assert out["steps"] == 1 and np.isfinite(out["last"]["total"]), (name, argv)
    with pytest.raises(ValueError, match="8 box deltas against 6-wide targets"):
        run_rcnn.main(_toy_argv("run_rcnn", root) + ["--bbox_type", "obb",
                                                     "--backbone_type", "vgg_AF"])
    with pytest.raises(NotImplementedError, match="slice 7"):
        run_fcos.main(_toy_argv("run_fcos", root) + ["--n_spatial", "2"])


def test_train_modes_of_later_slices_raise(toy_data):
    """OBB RCNN, ``steps_per_call > 1`` and the device-resident store
    ``device_data`` run in the trainers at toy size; the OBB sampler encodes
    8 deltas; a mesh over several cards (``n_spatial > 1``) raises, naming
    slice 7."""
    import torch as _torch

    from instance_nerf_tpu_torch.models.rcnn import select_training_samples
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer

    obb = RCNNTrainer(RCNNConfig(bbox_type="obb", backbone_type="vgg_AF"), device="cpu")
    assert obb.model.box_head.bbox_pred.weight.shape[0] == 11 * 8
    root = toy_data["aabb"]
    common = dict(resolution=32, batch_size=1, num_epochs=1, eval_interval=2, max_gt=4,
                  dtype="float32", backbone_type="vgg_AF")
    paths = dict(features_path=os.path.join(root, "features"),
                 boxes_path=os.path.join(root, "metadata"),
                 dataset_split=os.path.join(root, "dataset_split.json"), rot_scale_prob=0.0)
    for cfg in (FCOSConfig(steps_per_call=4, **paths, **common),
                FCOSConfig(device_data=True, **paths, **common)):
        out = FCOSTrainer(cfg, device="cpu").train_loop()
        assert out["steps"] == 2 and out["calls"] == (1 if cfg.steps_per_call > 1 else 2)
    for cfg in (RCNNConfig(steps_per_call=4, dataset_root=root, max_rois=16, **common),
                RCNNConfig(device_data=True, dataset_root=root, max_rois=16, **common)):
        out = RCNNTrainer(cfg, device="cpu").train_loop()
        assert out["steps"] == 2 and np.isfinite(out["last"]["total"])
    box = _torch.tensor([[[0.0, 0, 0, 4, 4, 4]]])
    gt = _torch.tensor([[[2.0, 2, 2, 4, 4, 4, 0.3]]])
    s = select_training_samples(box, _torch.ones((1, 1), dtype=_torch.bool), gt,
                                _torch.ones((1, 1), dtype=_torch.int64),
                                _torch.ones((1, 1), dtype=_torch.bool), box_dim=8)
    assert s.reg_targets.shape == (1, 2, 8) and bool(s.pos.all())
    with pytest.raises(NotImplementedError, match="slice 7"):
        FCOSTrainer(FCOSConfig(n_spatial=2), device="cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """The chip check exits nonzero, printing no result, with no CUDA
    device, and also when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
