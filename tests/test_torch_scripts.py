"""The port's scripts (``instance_nerf_tpu_torch/scripts``) against the JAX
package's (mirroring ``tests/test_scripts.py``): the same command lines on
the same files write the same files, byte for byte."""
import json
import os

import numpy as np
import pytest

from instance_nerf_tpu.scripts import proposals2ngp as j_p2n
from instance_nerf_tpu.scripts import render_heatmap as j_heat
from instance_nerf_tpu.scripts import visualize_rpn_input as j_vis
from instance_nerf_tpu_torch.data.synthetic import write_dataset
from instance_nerf_tpu_torch.scripts import proposals2ngp, render_heatmap, visualize_rpn_input


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scripts"))
    write_dataset(root, num_scenes=1, grid_size=(24, 24, 24), num_boxes=2)
    return root


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


@pytest.mark.parametrize("extra", [["--grid_res", "24", "24", "24"],
                                   ["--bbox_format", "obb", "--threshold", "0.1",
                                    "--top_k", "3"]], ids=["aabb", "obb"])
def test_proposals2ngp_writes_the_jax_file(dataset_dir, tmp_path, extra):
    tpath = str(tmp_path / "transforms.json")
    with open(tpath, "w") as f:
        json.dump({"frames": []}, f)
    rois = os.path.join(dataset_dir, "rois", "scene_0000.npz")
    if "obb" in extra:  # OBB proposals with scores
        r = np.load(rois)["proposals"]
        obb = np.concatenate([(r[:, :3] + r[:, 3:6]) / 2, r[:, 3:6] - r[:, :3],
                              np.linspace(-1, 1, len(r))[:, None]], 1)
        rois = str(tmp_path / "obb.npz")
        np.savez(rois, proposals=obb, scores=np.linspace(0, 1, len(r)))
    for name, main in (("port", proposals2ngp.main), ("jax", j_p2n.main)):
        main(["--proposals", rois,
              "--metadata", os.path.join(dataset_dir, "metadata", "scene_0000.json"),
              "--transforms", tpath, "--output", str(tmp_path / name / "out.json"), *extra])
    _same_files(tmp_path / "port", tmp_path / "jax")
    boxes = json.load(open(tmp_path / "port" / "out.json"))["bounding_boxes"]
    assert boxes and all(np.isfinite(b["position"]).all() for b in boxes)


def test_frame_functions_equal_jax():
    feats = {"resolution": np.array([160.0, 160.0, 128.0]),
             "bbox_min": np.array([-3.0, -2.0, 0.0]), "bbox_max": np.array([3.0, 2.0, 2.5]),
             "scale": np.array(0.33), "offset": np.array([0.5, 0.5, 0.5]),
             "from_mitsuba": np.array(False)}
    props = np.array([[20.0, 40.0, 10.0, 100.0, 90.0, 60.0]])
    obb = np.array([[80.0, 80.0, 64.0, 40.0, 20.0, 30.0, 0.6]])
    assert proposals2ngp.proposals_to_ngp_boxes(props, feats) == j_p2n.proposals_to_ngp_boxes(
        props, feats)
    assert proposals2ngp.obb_to_ngp_boxes(obb, feats) == j_p2n.obb_to_ngp_boxes(obb, feats)
    m = np.concatenate([np.eye(3), np.array([[1.0], [2.0], [3.0]])], 1)
    for mitsuba in (True, False):
        np.testing.assert_array_equal(
            proposals2ngp.ngp_matrix_to_nerf(m, 2.0, np.array([0.5, 0.5, 0.5]), mitsuba),
            j_p2n.ngp_matrix_to_nerf(m, 2.0, np.array([0.5, 0.5, 0.5]), mitsuba))


def test_render_heatmap_writes_the_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    spath = str(tmp_path / "scene.npz")
    np.savez(spath, **{"0": rng.uniform(0, 1, (8, 8, 8)), "1": rng.uniform(0, 1, (4, 4, 4))})
    for name, main in (("port", render_heatmap.main), ("jax", j_heat.main)):
        main(["--scores", spath, "--output_dir", str(tmp_path / name)])
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port")) == ["scene_level0.png", "scene_level1.png"]


def test_visualize_rpn_input_writes_the_jax_files(dataset_dir, tmp_path):
    for name, main in (("port", visualize_rpn_input.main), ("jax", j_vis.main)):
        os.makedirs(tmp_path / name)
        main(["--features", os.path.join(dataset_dir, "features", "scene_0000.npz"),
              "--boxes", os.path.join(dataset_dir, "rois", "scene_0000.npz"),
              "--output", str(tmp_path / name / "vis"), "--max_points", "300"])
    _same_files(tmp_path / "port", tmp_path / "jax")
    with open(tmp_path / "port" / "vis_pts.ply", "rb") as f:
        assert f.read(64).startswith(b"ply\nformat binary_little_endian")
