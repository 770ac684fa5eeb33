"""The port's rest of ``masks2d`` against the JAX package's (mirroring the
refine / async / CLI cases of ``tests/test_masks2d.py``): the guided
refinement equal to JAX's, the async predictor ordered and propagating
errors, ``coco2nyu40_cli`` and ``refine_masks`` writing the same files, and
the external backends failing with the JAX modules' messages."""
import json
import os
import time

import numpy as np
import pytest

from instance_nerf_tpu.masks2d import coco2nyu40_cli as j_cli
from instance_nerf_tpu.masks2d import refine_masks as j_refine
from instance_nerf_tpu.masks2d import run_mask2former as j_m2f
from instance_nerf_tpu_torch.data.png import write_png
from instance_nerf_tpu_torch.masks2d import coco2nyu40_cli, refine_masks, run_mask2former
from instance_nerf_tpu_torch.masks2d.async_predictor import AsyncPredictor


def _view(seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((24, 24, 3), np.float32) + 0.1
    img[6:18, 6:18] = 0.9  # a bright square object
    img[2:6, 15:22] = 0.6
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    ids = np.zeros((24, 24), np.int32)
    ids[8:16, 5:17] = 1  # sloppy masks: offset from the objects
    ids[1:7, 14:20] = 2
    return np.clip(img, 0, 1), ids


@pytest.mark.parametrize("kw", [{}, {"r": 2, "eps": 1e-2, "thresh": 0.4}])
def test_refine_instance_map_matches_jax(kw):
    img, ids = _view(0)
    got = refine_masks.refine_instance_map(img, ids, **kw)
    np.testing.assert_array_equal(got, j_refine.refine_instance_map(img, ids, **kw))
    gt = np.zeros_like(ids)
    gt[6:18, 6:18] = 1
    if not kw:  # refinement moves toward the image's edges
        assert ((got == 1) == (gt == 1)).mean() >= ((ids == 1) == (gt == 1)).mean()
    empty = np.zeros_like(ids)
    np.testing.assert_array_equal(refine_masks.refine_instance_map(img, empty), empty)


def test_refine_masks_cli_writes_the_jax_files(tmp_path):
    for d in ("images", "masks"):
        os.makedirs(tmp_path / d)
    for v in range(2):
        img, ids = _view(v)
        write_png(str(tmp_path / "images" / f"{v:04d}.png"),
                  np.round(img * 255).astype(np.uint8))
        np.save(tmp_path / "masks" / f"{v:04d}.npy", ids)
    np.save(tmp_path / "masks" / "0009.npy", ids)  # no image: skipped
    for name, main in (("port", refine_masks.main), ("jax", j_refine.main)):
        main(["--images", str(tmp_path / "images"), "--masks", str(tmp_path / "masks"),
              "--out_dir", str(tmp_path / name)])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["0000.npy", "0001.npy"]
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / n),
                                      np.load(tmp_path / "jax" / n))


def test_cascadepsp_without_its_package_fails_as_jax():
    img, ids = _view(1)
    with pytest.raises(SystemExit) as want:
        j_refine.refine_instance_map(img, ids, backend="cascadepsp")
    with pytest.raises(SystemExit) as got:
        refine_masks.refine_instance_map(img, ids, backend="cascadepsp")
    assert str(got.value) == str(want.value) and "segmentation_refinement" in str(got.value)


def test_async_predictor_ordered_and_parallel():
    def make(widx):
        def predict(x):
            # reversed latency: later tasks finish first without ordering
            time.sleep(0.01 * (5 - x % 5))
            return x * 10
        return predict

    with AsyncPredictor(make, num_workers=3) as pred:
        assert list(pred.imap(range(17))) == [x * 10 for x in range(17)]
    with AsyncPredictor(make, num_workers=2) as pred:
        assert pred(7) == 70


def test_async_predictor_propagates_errors():
    def make(widx):
        def predict(x):
            if x == 2:
                raise ValueError("boom")
            return x
        return predict

    with AsyncPredictor(make, num_workers=2) as pred:
        pred.put(1)
        pred.put(2)
        pred.put(3)
        assert pred.get() == 1
        with pytest.raises(ValueError, match="boom"):
            pred.get()
        assert pred.get() == 3


def test_coco2nyu40_cli_writes_the_jax_files(tmp_path):
    seg_dir = tmp_path / "seg"
    os.makedirs(seg_dir)
    rng = np.random.default_rng(2)
    info = [{"id": 1, "category_id": 0, "isthing": True, "category_name": "chair"},
            {"id": 2, "category_id": 1, "isthing": False, "category_name": "wall-wood"},
            {"id": 3, "category_id": 2, "isthing": True, "category_name": "zebra"}]
    for v in range(3):
        np.save(seg_dir / f"{v:04d}.npy", rng.integers(0, 4, (10, 12)).astype(np.int64))
        with open(seg_dir / f"{v:04d}.json", "w") as f:
            json.dump(info, f)
    for name, main in (("port", coco2nyu40_cli.main), ("jax", j_cli.main)):
        main(["--seg_dir", str(seg_dir), "--out_dir", str(tmp_path / name)])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3
    for n in names:
        a, b = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_run_mask2former_without_a_checkpoint_fails_as_jax(tmp_path):
    argv = ["--model_path", str(tmp_path / "absent"), "--input", str(tmp_path),
            "--output", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as want:
        j_m2f.main(argv)
    with pytest.raises(SystemExit) as got:
        run_mask2former.main(argv)
    assert str(got.value) == str(want.value) and "not found" in str(got.value)
    assert not os.path.exists(tmp_path / "out")
