"""Parity of the port's data and metrics modules (``data/synthetic.py``,
``data/datasets.py``, ``data/augment.py``, ``eval/metrics.py``) with the JAX
package's, on tiny datasets both packages write.

Files, boxes, masks, rois and augmentations must be identical. Grids are
held to 1e-6: the port takes density to alpha in numpy, the JAX package
may take its native build, compiled with ``-ffast-math``. The metrics are
numpy in both packages and must agree exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from instance_nerf_tpu.data import augment as JA
from instance_nerf_tpu.data import datasets as JD
from instance_nerf_tpu.data import synthetic as JS
from instance_nerf_tpu.eval import metrics as JM
from instance_nerf_tpu_torch.data import augment as TA
from instance_nerf_tpu_torch.data import datasets as TD
from instance_nerf_tpu_torch.data import synthetic as TS
from instance_nerf_tpu_torch.eval import metrics as TM

torch.set_num_threads(2)

GRID = (32, 32, 24)
KINDS = {"boxes": dict(style="boxes", rotated=False),
         "room_rotated": dict(style="room", rotated=True)}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One dataset per kind written by each package: {kind: (jax, port)}."""
    out = {}
    for kind, kw in KINDS.items():
        pair = []
        for pkg, writer in (("jax", JS), ("port", TS)):
            root = str(tmp_path_factory.mktemp(f"{kind}_{pkg}"))
            writer.write_dataset(root, num_scenes=4, grid_size=GRID, num_boxes=4, seed=3, **kw)
            pair.append(root)
        out[kind] = tuple(pair)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _assert_same_file(a, b):
    if a.endswith(".json"):
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb), a
    elif a.endswith(".npy"):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype and x.shape == y.shape, a
        np.testing.assert_array_equal(x, y)
    else:
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files), a
            for k in x.files:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (a, k)
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("kind", list(KINDS))
def test_write_dataset_matches_jax(roots, kind):
    jroot, troot = roots[kind]
    files = _files(jroot)
    assert files == _files(troot)
    assert "dataset_split.json" in files and len(files) > 4 * 4
    assert any(f.startswith("boxes_obb") for f in files) == KINDS[kind]["rotated"]
    for f in files:
        _assert_same_file(os.path.join(jroot, f), os.path.join(troot, f))


def _grid_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_rpn_dataset_get_and_batch_match_jax(roots, kind):
    root = roots[kind][0]
    boxes = "boxes_obb" if KINDS[kind]["rotated"] else "metadata"
    kw = dict(features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, boxes),
              scene_list=JD.read_split(os.path.join(root, "dataset_split.json"), "train"))
    assert TD.read_split(os.path.join(root, "dataset_split.json"), "train") == kw["scene_list"]
    jds, tds = JD.RPNDataset(**kw), TD.RPNDataset(**kw)
    assert len(jds) == len(tds) == 2 and jds.scenes == tds.scenes
    for i in range(len(jds)):
        (js, jg, jb), (ts, tg, tb) = jds.get(i), tds.get(i)
        assert js == ts
        _grid_close(tg, jg)
        np.testing.assert_array_equal(tb, jb)
    box_dim = 7 if KINDS[kind]["rotated"] else 6
    jbt = jds.batch([1, 0], (32, 32, 32), max_gt=12, box_dim=box_dim)
    tbt = tds.batch([1, 0], (32, 32, 32), max_gt=12, box_dim=box_dim)
    _grid_close(tbt.grids, jbt.grids)
    for f in ("grid_sizes", "gt_boxes", "gt_mask"):
        np.testing.assert_array_equal(getattr(tbt, f), getattr(jbt, f))
    assert tbt.scenes == jbt.scenes and tbt.gt_mask.any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_rpn_dataset_augmented_get_matches_jax(roots, kind):
    """The train split's augmentation (rot90, flips and, for OBBs, the
    rotate-and-scale resample) from the same seed."""
    root = roots[kind][0]
    boxes = "boxes_obb" if KINDS[kind]["rotated"] else "metadata"
    kw = dict(features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, boxes), flip_prob=0.5, rotate_prob=0.5,
              rot_scale_prob=0.5, seed=5)
    jds, tds = JD.RPNDataset(**kw), TD.RPNDataset(**kw)
    for i in (0, 1, 2, 3, 0, 1):
        (_, jg, jb), (_, tg, tb) = jds.get(i, augment=True), tds.get(i, augment=True)
        _grid_close(tg, jg)
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("obb", [False, True])
def test_augment_rpn_inputs_matches_jax(obb):
    rng = np.random.default_rng(4)
    grid = rng.uniform(0, 1, (20, 20, 12, 4)).astype(np.float32)
    lo = rng.uniform(0, 10, (5, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 8, (5, 3))], 1).astype(np.float32)
    if obb:
        boxes = np.concatenate([(boxes[:, :3] + boxes[:, 3:]) / 2, boxes[:, 3:] - boxes[:, :3],
                                rng.uniform(-1.5, 1.5, (5, 1))], 1).astype(np.float32)
    jr, tr = np.random.default_rng(8), np.random.default_rng(8)
    for _ in range(6):
        jg, jb = JA.augment_rpn_inputs(jr, grid, boxes, 0.5, 0.5, 0.7)
        tg, tb = TA.augment_rpn_inputs(tr, grid, boxes, 0.5, 0.5, 0.7)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("mode", ["val", "test"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_segmentation_dataset_matches_jax(roots, kind, mode):
    root = roots[kind][0]
    jds, tds = JD.SegmentationDataset(mode, root), TD.SegmentationDataset(mode, root)
    assert jds.scenes == tds.scenes and len(tds) == 1
    jd, td = jds.load_scene(0), tds.load_scene(0)
    assert sorted(jd) == sorted(td)
    _grid_close(td["grid"], jd["grid"])
    for k in ("rois", "level_indices", "boxes", "class_ids", "masks"):
        if jd[k] is None:
            assert td[k] is None and mode == "test"
            continue
        assert td[k].dtype == jd[k].dtype, k
        np.testing.assert_array_equal(td[k], jd[k])
    jb = jds.batch([0], GRID, max_gt=8, max_rois=48)
    tb = tds.batch([0], GRID, max_gt=8, max_rois=48)
    _grid_close(tb.grids, jb.grids)
    for f in ("grid_sizes", "gt_boxes", "gt_labels", "gt_mask", "gt_voxel_masks", "rois",
              "roi_level", "roi_mask"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


def test_segmentation_dataset_obb_rois_become_enclosing_aabbs(roots, tmp_path):
    """OBB proposals (an OBB RPN's export) load as their enclosing AABBs,
    through the port's ``obb2hbb_3d``, to 1e-6 of the JAX package's."""
    src = roots["room_rotated"][0]
    root = tmp_path / "obb_rois"
    for sub in ("features", "masks", "metadata", "rois"):
        os.makedirs(root / sub)
    split = json.load(open(os.path.join(src, "dataset_split.json")))
    scene = split["val"][0]
    for sub, ext in (("features", ".npz"), ("masks", ".npy"), ("metadata", ".json")):
        with open(os.path.join(src, sub, scene + ext), "rb") as f:
            (root / sub / (scene + ext)).write_bytes(f.read())
    obbs = np.load(os.path.join(src, "boxes_obb", scene + ".npy"))
    np.savez(root / "rois" / (scene + ".npz"), proposals=obbs,
             level_indices=np.arange(len(obbs)) % 4)
    with open(root / "dataset_split.json", "w") as f:
        json.dump({"val": [scene]}, f)
    jd = JD.SegmentationDataset("val", str(root)).load_scene(0)
    td = TD.SegmentationDataset("val", str(root)).load_scene(0)
    assert td["rois"].shape == (len(obbs), 6) and td["rois"].dtype == np.float32
    np.testing.assert_allclose(td["rois"], jd["rois"], rtol=1e-6, atol=1e-5)
    assert (td["rois"][:, 3:] > td["rois"][:, :3]).all()


def _random_predictions(seed, n_scenes=4):
    rng = np.random.default_rng(seed)
    props, scores, labels, gts, glabels, pmasks, gmasks = [], [], [], [], [], [], []
    for s in range(n_scenes):
        k, p = int(rng.integers(1, 6)), int(rng.integers(0, 40))
        lo = rng.uniform(0, 20, (k, 3))
        gt = np.concatenate([lo, lo + rng.uniform(2, 8, (k, 3))], 1)
        pick = rng.integers(0, k, p)
        pr = gt[pick] + rng.normal(0, 1.0, (p, 6))
        pr[:, 3:] = np.maximum(pr[:, 3:], pr[:, :3] + 0.5)
        props.append(pr.astype(np.float32))
        gts.append(gt.astype(np.float32))
        scores.append(np.round(rng.uniform(0, 1, p), 2).astype(np.float32))  # ties
        labels.append(rng.integers(1, 4, p))
        glabels.append(rng.integers(1, 4, k))
        pmasks.append(rng.uniform(size=(p, 8, 8, 6)) < 0.3)
        gmasks.append(rng.uniform(size=(k, 8, 8, 6)) < 0.3)
    return props, scores, labels, gts, glabels, pmasks, gmasks


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    props, scores, labels, gts, glabels, pmasks, gmasks = _random_predictions(seed)
    for fn, args, kw in (
            ("evaluate_box_proposals_recall", (props, scores, gts), {}),
            ("evaluate_box_proposals_recall", (props, scores, gts), dict(thresholds=[0.25],
                                                                       limit=10)),
            ("evaluate_box_proposals_ap", (props, scores, gts), dict(iou_thresh=0.5)),
            ("evaluate_box_proposals_ap", (props, scores, gts), dict(top_k=7)),
            ("evaluate_box_proposals_precision", (props, scores, gts), {}),
            ("evaluate_box_proposals_average_precision", (props, scores, gts), {}),
            ("evaluate_labels", (props, gts), {}),
            ("evaluate_map_recall", (props, scores, labels, gts, glabels), {}),
            ("evaluate_map_recall", (pmasks, scores, labels, gmasks, glabels),
             dict(iou_thresh=0.5, iou_type="mask"))):
        want = getattr(JM, fn)(*args, **kw)
        got = getattr(TM, fn)(*args, **kw)
        np.testing.assert_equal(got, want, err_msg=fn)
    np.testing.assert_array_equal(TM.box_iou_3d_np(props[0], gts[0]),
                                  JM.box_iou_3d_np(props[0], gts[0]))
    np.testing.assert_array_equal(TM.mask_iou_3d_np(pmasks[0], gmasks[0]),
                                  JM.mask_iou_3d_np(pmasks[0], gmasks[0]))


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_split_batches_match_jax(roots, kind):
    """The trainers' augmented train split (``rpn_dataset(cfg, "train")``
    against the JAX ``RPNTrainer.make_dataset``): the same batches, drawn
    in turn from the dataset's ``default_rng(seed)``."""
    from instance_nerf_tpu.train.rpn_trainer import RPNConfig as JConfig
    from instance_nerf_tpu.train.rpn_trainer import RPNTrainer as JTrainer
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, rpn_dataset

    root = roots[kind][0]
    rotated = KINDS[kind]["rotated"]
    kw = dict(features_path=os.path.join(root, "features"),
              boxes_path=os.path.join(root, "boxes_obb" if rotated else "metadata"),
              dataset_split=os.path.join(root, "dataset_split.json"), rotated_bbox=rotated,
              rot_scale_prob=0.5, seed=4)
    jds = JTrainer(JConfig(**kw)).make_dataset("train")
    tds = rpn_dataset(RPNConfig(**kw), "train")
    assert tds.scenes == jds.scenes and (tds.flip_prob, tds.rot_scale_prob) == (0.5, 0.5)
    box_dim = 7 if rotated else 6
    for idx in ([0, 1], [1, 0], [1, 1]):
        jb = jds.batch(idx, (32, 32, 32), max_gt=8, box_dim=box_dim, augment=True)
        tb = tds.batch(idx, (32, 32, 32), max_gt=8, box_dim=box_dim, augment=True)
        _grid_close(tb.grids, jb.grids)
        for f in ("grid_sizes", "gt_boxes", "gt_mask"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert rpn_dataset(RPNConfig(**kw), "val").flip_prob == 0.0


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
def test_device_augment_matches_jax(obb):
    """The FCOS trainer's on-device rot90 + flips of one padded scene, with
    the JAX key's three uniforms passed in."""
    import jax
    import jax.numpy as jnp

    from instance_nerf_tpu.train.fcos_trainer import device_augment as j_aug
    from instance_nerf_tpu_torch.train.fcos_trainer import device_augment as t_aug

    rng = np.random.default_rng(6)
    g = np.zeros((16, 16, 12, 4), np.float32)
    g[:14, :11, :10] = rng.uniform(size=(14, 11, 10, 4))
    size = np.array([14.0, 11.0, 10.0], np.float32)
    lo = rng.uniform(0, 6, (3, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(1, 4, (3, 3))], 1)
    if obb:
        boxes = np.concatenate([(boxes[:, :3] + boxes[:, 3:]) / 2, boxes[:, 3:] - boxes[:, :3],
                                rng.uniform(-1, 1, (3, 1))], 1)
    boxes = boxes.astype(np.float32)
    seen = set()
    for seed in range(12):
        key = jax.random.key(seed)
        draws = np.array([float(jax.random.uniform(k)) for k in jax.random.split(key, 3)])
        seen.add(tuple(draws < 0.5))
        want = j_aug(key, jnp.asarray(g), jnp.asarray(size), jnp.asarray(boxes), 0.5, 0.5, obb)
        got = t_aug(torch.from_numpy(g), torch.from_numpy(size), torch.from_numpy(boxes),
                    0.5, 0.5, obb, torch.from_numpy(draws))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert len(seen) >= 6  # most combinations of rot90 and the two flips
