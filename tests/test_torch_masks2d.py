"""The port's 2D-mask tooling against the JAX package: 3D voxel masks
projected into views (``masks2d/project_masks.py``, id maps equal exactly,
file by file through ``write_projections`` and the ``main`` entry point),
match_seg (``convert_seg``, ``panoptic_to_semantic``, ``match_view``,
``match_scene`` with ``.npy`` and ``.png`` projections), the COCO -> NYU40
tables and ``evaluate_instance_masks`` (exactly equal); the chain of BASELINE
config #3 ends in ``run_instance_field --mode train_instance`` on the
matched masks."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.eval import instance_field_metrics as JE
from instance_nerf_tpu.masks2d import coco_nyu40 as JN
from instance_nerf_tpu.masks2d import match_seg as JMS
from instance_nerf_tpu.masks2d import project_masks as JP
from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene, write_nerf_scene
from instance_nerf_tpu_torch.eval import instance_field_metrics as TE
from instance_nerf_tpu_torch.masks2d import coco_nyu40 as TN
from instance_nerf_tpu_torch.masks2d import match_seg as TMS
from instance_nerf_tpu_torch.masks2d import project_masks as TP

torch.set_num_threads(2)

G = 24


@pytest.fixture(scope="module")
def voxels():
    """A scene with three boxes, its voxel instance grid (two boxes
    overlapping in depth from some views) and a weak alpha grid with fog."""
    rng = np.random.default_rng(0)
    scene, boxes = make_synthetic_nerf_scene(rng, n_views=4, hw=(20, 28), n_blobs=3)
    inst = np.zeros((G, G, G), np.int32)
    for k, b in enumerate(boxes * G):
        lo, hi = np.floor(b[:3]).astype(int), np.ceil(b[3:]).astype(int)
        inst[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = k + 1
    alpha = np.where(inst > 0, rng.uniform(0.05, 0.9, inst.shape),
                     rng.uniform(0.0, 0.05, inst.shape)).astype(np.float32)
    return scene, inst, alpha


@pytest.mark.parametrize("n_samples,chunk", [(64, 100), (192, 8192)])
def test_project_voxel_masks_equals_jax(voxels, n_samples, chunk):
    scene, inst, alpha = voxels
    for v in range(scene.num_views):
        want = JP.project_voxel_masks(jnp.asarray(inst), jnp.asarray(alpha),
                                      jnp.asarray(scene.poses[v]), scene.intrinsics, scene.hw,
                                      n_samples=n_samples, chunk=chunk)
        got = TP.project_voxel_masks(inst, alpha, scene.poses[v], scene.intrinsics, scene.hw,
                                     n_samples=n_samples, chunk=chunk, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and (got > 0).sum() > 10
    assert len(np.unique(got)) >= 3


def _files(d):
    return sorted(os.listdir(d))


def _same_dirs(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _panoptic(rng, ids_map):
    """A panoptic segmentation that roughly follows ``ids_map``: each
    projected instance a 'chair' segment (shifted by a pixel), a 'wall-wood'
    stuff segment, a 'zebra' (otherprop) segment and void."""
    seg = np.zeros(ids_map.shape, np.int32)
    info = []
    for k in np.unique(ids_map):
        if k > 0:
            seg[np.roll(ids_map == k, 1, axis=1)] = 10 + k
            info.append({"id": int(10 + k), "category_id": 0, "isthing": True,
                         "category_name": "chair"})
    seg[:3] = 3
    info.append({"id": 3, "category_id": 1, "isthing": False, "category_name": "wall-wood"})
    seg[-2:, :4] = 4
    info.append({"id": 4, "category_id": 2, "isthing": True, "category_name": "zebra"})
    seg[-1, -1] = 0
    return seg, info


def test_projections_and_match_scene_file_by_file(voxels, tmp_path):
    scene, inst, alpha = voxels
    pj, pt = str(tmp_path / "proj_jax"), str(tmp_path / "proj_port")
    kw = dict(n_samples=96)
    assert JP.write_projections(pj, inst, alpha, scene.poses, scene.intrinsics, scene.hw,
                                **kw) == 4
    assert TP.write_projections(pt, inst, alpha, scene.poses, scene.intrinsics, scene.hw,
                                device="cpu", **kw) == 4
    _same_dirs(pj, pt)
    # panoptic segmentations of the views, one matched through PNG projections
    seg_dir = str(tmp_path / "seg")
    os.makedirs(seg_dir)
    rng = np.random.default_rng(1)
    for v in range(4):
        seg, info = _panoptic(rng, np.load(os.path.join(pt, f"{v:04d}.npy")))
        np.save(os.path.join(seg_dir, f"{v:04d}.npy"), seg)
        with open(os.path.join(seg_dir, f"{v:04d}.json"), "w") as f:
            json.dump(info, f)
        np.testing.assert_array_equal(TMS.convert_seg(seg, info), JMS.convert_seg(seg, info))
        np.testing.assert_array_equal(TMS.panoptic_to_semantic(seg, info),
                                      JMS.panoptic_to_semantic(seg, info))
    from PIL import Image

    png = str(tmp_path / "proj_png")
    os.makedirs(png)
    for f in _files(pt):
        if "_" in f:
            m = np.load(os.path.join(pt, f))
            Image.fromarray(m.astype(np.uint8) * 255).save(
                os.path.join(png, f.replace(".npy", ".png")))
    for proj in (pt, png):
        oj, ot = str(tmp_path / "m_jax"), str(tmp_path / "m_port")
        assert JMS.match_scene(proj, seg_dir, oj) == TMS.match_scene(proj, seg_dir, ot) == 4
        _same_dirs(oj, ot)
        matched = np.load(os.path.join(ot, "0000.npy"))
        assert (matched > 0).any() and (matched == -1).any()
    masks, ids = TMS.load_projections(png, "0001")
    want_m, want_i = JMS.load_projections(png, "0001")
    np.testing.assert_array_equal(masks, want_m)
    np.testing.assert_array_equal(ids, want_i)


def test_project_masks_main_and_config3_chain(voxels, tmp_path, capsys):
    """RCNN voxel masks -> ``project_masks.main`` (port and JAX, the same
    files) -> ``match_seg`` -> ``run_instance_field --mode train_instance``
    on the matched masks."""
    from instance_nerf_tpu.masks2d.project_masks import main as jmain
    from instance_nerf_tpu_torch.cli import run_instance_field as TC

    scene, inst, _ = voxels
    root = write_nerf_scene(str(tmp_path / "scene"), scene, masks_dir=None)
    det = np.stack([inst == k for k in (1, 2, 3)])
    np.savez(str(tmp_path / "det.npz"), masks=det)
    rgbsigma = np.random.default_rng(2).normal(0, 2, (G, G, G, 4)).astype(np.float32)
    rgbsigma[..., 3] += 6.0 * (inst > 0)
    np.savez(str(tmp_path / "feats.npz"), rgbsigma=rgbsigma, resolution=np.asarray([G] * 3))
    args = ["--masks_npz", str(tmp_path / "det.npz"), "--features_npz",
            str(tmp_path / "feats.npz"), "--scene", root]
    jmain(args + ["--out_dir", str(tmp_path / "pj")])
    TP.main(args + ["--out_dir", str(tmp_path / "pt"), "--device", "cpu"])
    _same_dirs(str(tmp_path / "pj"), str(tmp_path / "pt"))
    seg_dir = str(tmp_path / "seg")
    os.makedirs(seg_dir)
    rng = np.random.default_rng(3)
    for v in range(scene.num_views):
        seg, info = _panoptic(rng, np.load(str(tmp_path / "pt" / f"{v:04d}.npy")))
        np.save(os.path.join(seg_dir, f"{v:04d}.npy"), seg)
        with open(os.path.join(seg_dir, f"{v:04d}.json"), "w") as f:
            json.dump(info, f)
    TMS.match_scene(str(tmp_path / "pt"), seg_dir, os.path.join(root, "masks_matched"))
    TC.main(["--mode", "train_instance", "--scene", root, "--masks_dir",
             os.path.join(root, "masks_matched"), "--steps", "4", "--n_levels", "2",
             "--log2_table_size", "8", "--max_res", "32", "--num_instances", "5", "--n_rays",
             "64", "--n_samples", "16", "--k_occupied", "4", "--occ_res", "8", "--device",
             "cpu", "--log_every", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["instance"])


def test_mapping_tables_equal():
    for name in ("COCO_THINGS_TO_NYU40", "COCO_STUFF_TO_NYU40", "NYU40_CLASS_NAMES",
                 "NYU40_OTHERS", "NYU40_BACKGROUND", "NYU40_UNLABELED"):
        assert getattr(TN, name) == getattr(JN, name), name
    for nm in ("chair", "wall-wood", "zebra", "table-merged", ""):
        for thing in (True, False):
            assert TN.map_category(nm, thing) == JN.map_category(nm, thing)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_instance_masks_equal(seed):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(5):
        gt = rng.integers(-1, 5, (12, 14))
        pred = np.where(rng.uniform(size=gt.shape) < 0.8, np.maximum(gt, 0),
                        rng.integers(0, 6, gt.shape))
        preds.append(pred)
        gts.append(gt)
    preds.append(np.zeros((4, 4), int))  # a view with no instance on either side
    gts.append(np.zeros((4, 4), int))
    preds.append(np.ones((4, 4), int))  # predictions only
    gts.append(np.zeros((4, 4), int))
    for thr in (0.5, 0.25):
        assert TE.evaluate_instance_masks(preds, gts, thr) == JE.evaluate_instance_masks(
            preds, gts, thr)
    np.testing.assert_array_equal(
        TE.instance_iou_matrix(preds[0], gts[0], [1, 2], [1, 3]),
        JE.instance_iou_matrix(preds[0], gts[0], [1, 2], [1, 3]))
