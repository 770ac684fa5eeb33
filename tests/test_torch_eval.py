"""Parity of the port's eval modes (``FCOSTrainer.eval``, ``RPNTrainer.eval``
and ``RCNNTrainer.eval``) with the JAX trainers', on converted params and a
tiny dataset the port's ``write_dataset`` writes, in f32 on the CPU
(``tests/test_torch_eval_cli.py`` drives the CLIs' eval modes).

The metric dicts must agree to 1e-6 and the exported files must hold the
same arrays: discrete ones (level indices, labels, kept masks) identical,
float ones to the head outputs' f32 agreement (convs sum in another order
in the two packages: 1e-4 of the largest entry). Proposals are comparable
only where no two scores lie within float rounding: the weights scale the
score kernels as ``tests/test_torch_fcos.py`` and ``test_torch_rpn.py``
do, and each test asserts its margins.
"""
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.data.datasets import SegmentationDataset as JSegDataset
from instance_nerf_tpu.train.fcos_trainer import FCOSConfig as JFConfig
from instance_nerf_tpu.train.fcos_trainer import FCOSTrainer as JFTrainer
from instance_nerf_tpu.train.rcnn_trainer import RCNNConfig as JCConfig
from instance_nerf_tpu.train.rcnn_trainer import RCNNTrainer as JCTrainer
from instance_nerf_tpu.train.rpn_trainer import RPNConfig as JRConfig
from instance_nerf_tpu.train.rpn_trainer import RPNTrainer as JRTrainer
from instance_nerf_tpu_torch.data.datasets import SegmentationDataset
from instance_nerf_tpu_torch.data.synthetic import write_dataset
from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer
from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer
from tests.test_torch_fcos import _random_params as fcos_params
from tests.test_torch_fcos import _small_fcos_shapes
from tests.test_torch_rpn import _random_params as rpn_params

torch.set_num_threads(2)

GRID = (32, 32, 24)
# the keys the JAX trainers' eval writes
PROPOSAL_KEYS = sorted([f"recall_{t}_top{n}" for t in (25, 50) for n in (300, 1000, "all")]
                       + ["recall_25", "recall_50", "ar", "ap_25", "ap_50"])
RCNN_KEYS = sorted([f"{k}_{t}" for k in ("box_mAP", "box_AR", "mask_mAP", "mask_AR")
                    for t in (25, 50)] + ["box_AP_25_per_class"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{"aabb": root, "obb": root}: 4 scenes each (OBBs in the room style,
    which draws rotated boxes); ``val_all.json`` puts all four in the val
    split, ``val_two.json`` the first two (for the RCNN, whose full-grid
    masks cost most on the CPU)."""
    out = {}
    for kind, rotated in (("aabb", False), ("obb", True)):
        root = str(tmp_path_factory.mktemp(kind))
        scenes = write_dataset(root, num_scenes=4, grid_size=GRID, num_boxes=3, seed=2,
                               style="room" if rotated else "boxes", rotated=rotated)
        with open(os.path.join(root, "val_all.json"), "w") as f:
            json.dump({"val": scenes, "test": scenes}, f)
        with open(os.path.join(root, "val_two.json"), "w") as f:
            json.dump({"val": scenes[:2]}, f)
        out[kind] = root
    return out


def _same_metrics(got, want, keys):
    assert sorted(got) == sorted(want) == keys
    for k in keys:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert (a is None) == (b is None), k
                if b is not None:
                    assert abs(a - b) <= 1e-6, (k, a, b)
        else:
            assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names if f.endswith(".npz"))


def _same_exports(tdir, jdir, tol=1e-4, mask_flips=0.0):
    """The npz files under both roots hold the same arrays; ``mask_flips``
    is the share of the voxels of the pasted ``masks`` that may differ (a
    soft mask value within f32 rounding of the paste threshold)."""
    files = _files(jdir)
    assert files and files == _files(tdir)
    for f in files:
        with np.load(os.path.join(tdir, f)) as t, np.load(os.path.join(jdir, f)) as j:
            assert sorted(t.files) == sorted(j.files), f
            for k in j.files:
                a, b = t[k], j[k]
                assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (f, k)
                if b.dtype.kind == "f" and b.size:
                    scale = max(float(np.abs(b).max()), 1e-6)
                    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=f + k)
                elif k == "masks":
                    assert (a != b).sum() <= mask_flips * b.size, (f, int((a != b).sum()))
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f + k)
    return files


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_fcos_eval_matches_jax(data, tmp_path, rotated):
    root = data["obb" if rotated else "aabb"]
    shapes, _ = _small_fcos_shapes(rotated)
    params = fcos_params(shapes, 11, cls_scale=3.0)
    kw = dict(dtype="float32", rotated_bbox=rotated, num_convs=2, pre_nms_top_n=96,
              fpn_post_nms_top_n=80, features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, "boxes_obb" if rotated else "metadata"),
              dataset_split=os.path.join(root, "val_all.json"))
    jt = JFTrainer(JFConfig(**kw))
    jt.state = types.SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray, params))
    tt = FCOSTrainer(FCOSConfig(**kw), device="cpu")
    tt.load_jax_params(params)
    out = {}
    for name, tr in (("jax", jt), ("port", tt)):
        ds = tr.make_dataset("val")
        assert len(ds) == 4
        # voxel scores in one box mode (the head's scores do not depend on it)
        out[name] = tr.eval(ds, save_results_path=str(tmp_path / name),
                            output_voxel_scores=not rotated)
    # margins: each scene's proposal scores apart by more than their rounding
    for f in _files(str(tmp_path / "jax" / "proposals")):
        s = np.sort(np.load(tmp_path / "jax" / "proposals" / f)["scores"])
        assert s.size > 20 and np.diff(s).min() > 5e-6
    _same_metrics(out["port"], out["jax"], PROPOSAL_KEYS)
    assert rotated or 0 < out["port"]["recall_25"]  # random weights: no OBB recall
    files = _same_exports(str(tmp_path / "port"), str(tmp_path / "jax"), tol=3e-5)
    assert sum(f.startswith("voxel_scores") for f in files) == (0 if rotated else 4)
    assert sum(f.startswith("proposals") for f in files) == 4


def _rpn_params_aabb():
    shapes = jax.eval_shape(JRTrainer(JRConfig(dtype="float32")).model.init,
                            jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4)))
    return rpn_params(shapes, 12, cls_scale=3.0)


def test_rpn_eval_matches_jax(data, tmp_path):
    """The export that builds the RCNN's ``rois/``: proposals, level
    indices and scores (FP-filtered), the FPN level features and the voxel
    objectness of every scene."""
    root = data["aabb"]
    params = _rpn_params_aabb()
    kw = dict(dtype="float32", pre_nms_top_n=96, post_nms_top_n=80,
              features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, "metadata"),
              dataset_split=os.path.join(root, "val_all.json"))
    jt = JRTrainer(JRConfig(**kw))
    jt.state = (jax.tree_util.tree_map(jnp.asarray, params), None, None)
    tt = RPNTrainer(RPNConfig(**kw), device="cpu")
    tt.load_jax_params(params)
    out = {}
    for name, tr in (("jax", jt), ("port", tt)):
        out[name] = tr.eval(tr.make_dataset("val"), save_results_path=str(tmp_path / name),
                            output_proposals=True, filter_mode="fp", filter_threshold=0.25,
                            output_voxel_scores=True)
    for f in _files(str(tmp_path / "jax" / "rois")):
        s = np.sort(np.load(tmp_path / "jax" / "rois" / f)["scores"])
        assert s.size > 5 and np.diff(s).min() > 2.5e-7
    _same_metrics(out["port"], out["jax"], PROPOSAL_KEYS)
    files = _same_exports(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert {f.split("/")[0] for f in files} == {"rois", "level_features", "voxel_scores"}
    with np.load(tmp_path / "port" / "level_features" / "scene_0000.npz") as z:
        assert sorted(z.files) == ["level_0", "level_1", "level_2", "level_3", "resolution"]
        assert z["resolution"].tolist() == list(GRID) and z["level_0"].dtype == np.float32


def _rcnn_params(model):
    """numpy weights over the flax NeRF-RCNN tree's shapes (``jax.eval_shape``
    of the init, so the full model is not compiled for it): conv kernels
    normal(sqrt(2 / fan_in)), dense ones normal(sqrt(1 / fan_in)) as flax's
    lecun init, zero biases, unit norm scales."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 32, 32, 32, 4)),
                                                 jnp.ones((1, 1, 6)), with_masks=True),
                            jax.random.key(0))
    rng = np.random.default_rng(13)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "bias"):
            return np.full(s.shape, float(name == "scale"), np.float32)
        gain = 2.0 if len(s.shape) == 5 else 1.0
        return rng.normal(0, np.sqrt(gain / np.prod(s.shape[:-1])), s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_rcnn_eval_matches_jax(data, tmp_path):
    """Box and mask mAP / AR over the dataset's jittered rois, with random
    weights converted; the saved masks of each scene."""
    root = data["aabb"]
    split = os.path.join(root, "val_two.json")
    jt = JCTrainer(JCConfig(dtype="float32", num_classes=11))
    jt.params = jax.tree_util.tree_map(jnp.asarray, _rcnn_params(jt.model))
    tt = RCNNTrainer(RCNNConfig(dtype="float32", num_classes=11), device="cpu")
    tt.load_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
    want = jt.eval(JSegDataset("val", root, split), save_masks_path=str(tmp_path / "jax"))
    got = tt.eval(SegmentationDataset("val", root, split), save_masks_path=str(tmp_path / "port"))
    _same_metrics(got, want, RCNN_KEYS)
    assert len(got["box_AP_25_per_class"]) == 10
    for f in _files(str(tmp_path / "jax")):
        with np.load(tmp_path / "jax" / f) as z:
            s = np.sort(z["scores"])
            # scores apart by more than 1e-4 of their size (f32 agrees to 1e-5)
            assert s.size > 3 and (np.diff(s) / s[1:]).min() > 1e-4, f
    # the soft masks agree to a few 1e-3 (tests/test_torch_rcnn.py:SOFT_TOL),
    # so a voxel within that of 0.5 may flip: at most 1e-5 of them here
    files = _same_exports(str(tmp_path / "port"), str(tmp_path / "jax"), mask_flips=1e-5)
    assert len(files) == 2
