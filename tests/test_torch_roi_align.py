"""Parity of the port's RoIAlign-3D and multi-scale pooler with the JAX
package, to 1e-5 in f32 (same ops in the same order; the gathers are
exact)."""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.ops.poolers import map_levels as j_map_levels
from instance_nerf_tpu.ops.poolers import multiscale_roi_align_3d as j_msra
from instance_nerf_tpu.ops.roi_align import roi_align_3d as j_roi_align
from instance_nerf_tpu_torch.ops.poolers import map_levels, multiscale_roi_align_3d
from instance_nerf_tpu_torch.ops.roi_align import roi_align_3d

torch.set_num_threads(2)


def _rois(rng, k, size):
    lo = rng.uniform(-4.0, size * 0.7, (k, 3))
    hi = lo + rng.uniform(1.0, size * 0.6, (k, 3))  # some reach past the grid
    return np.concatenate([lo, hi], 1).astype(np.float32)


@pytest.mark.parametrize("out_size,scale,ratio", [((5, 5, 5), 0.5, 1),
                                                  ((4, 3, 2), 1.0, 2)])
def test_roi_align_3d_matches_jax(out_size, scale, ratio):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 11, 9, 7, 6)).astype(np.float32)
    rois = _rois(rng, 9, 22.0)
    rois[0] = [-30, -30, -30, -20, -20, -20]  # every sample outside the grid
    batch = np.asarray([0, 1, 1, 0, 2, 1, 0, 1, 0], np.int32)  # 2: out of range
    want = j_roi_align(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(batch),
                       out_size, spatial_scale=scale, sampling_ratio=ratio)
    got = roi_align_3d(torch.from_numpy(feats), torch.from_numpy(rois),
                       torch.from_numpy(batch), out_size, spatial_scale=scale,
                       sampling_ratio=ratio)
    assert got.shape == (9, *out_size, 6)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(got[0].abs().max()) == 0.0


def test_roi_align_3d_integer_features():
    rng = np.random.default_rng(1)
    masks = (rng.uniform(size=(3, 10, 10, 10, 1)) < 0.3).astype(np.uint8)
    rois = _rois(rng, 3, 10.0)
    idx = np.arange(3, dtype=np.int32)
    want = j_roi_align(jnp.asarray(masks), jnp.asarray(rois), jnp.asarray(idx), (4, 4, 4))
    got = roi_align_3d(torch.from_numpy(masks), torch.from_numpy(rois),
                       torch.from_numpy(idx), (4, 4, 4))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _level_frac(boxes):
    """Distance of each box's FPN eq. (1) level value from the nearest
    integer (the floor boundary)."""
    vol = np.prod(boxes[:, 3:] - boxes[:, :3], axis=1).astype(np.float64)
    v = 4 + np.log2(np.cbrt(np.maximum(vol, 0)) / 160) + 1e-6
    return np.abs(v - np.round(v))


def test_map_levels_and_multiscale_match_jax():
    """Four levels of a 48x40x36 grid at strides 4..32. Boxes whose level
    value lies within 1e-4 of a level boundary are excluded by
    construction (asserted), since ``cbrt`` and ``log2`` may differ by an
    ulp between the libraries."""
    rng = np.random.default_rng(3)
    shapes = [(12, 10, 9), (6, 5, 5), (3, 3, 3), (2, 2, 2)]
    feats = [rng.normal(size=(1, *s, 8)).astype(np.float32) for s in shapes]
    boxes = _rois(rng, 12, 48.0)
    boxes[0] = [0, 0, 0, 300, 300, 300]  # large: the top level
    boxes[1] = [1, 1, 1, 3, 3, 3]  # tiny: the bottom level
    assert _level_frac(boxes).min() > 1e-4
    for k_min, k_max in ((2, 5), (1, 3)):
        np.testing.assert_array_equal(
            map_levels(torch.from_numpy(boxes), k_min, k_max).numpy(),
            np.asarray(j_map_levels(jnp.asarray(boxes), k_min, k_max)))
    want = j_msra([jnp.asarray(f) for f in feats], jnp.asarray(boxes)[None],
                  (5, 5, 5), (48, 48, 48))
    got = multiscale_roi_align_3d([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(boxes)[None], (5, 5, 5), (48, 48, 48))
    assert got.shape == (1, 12, 5, 5, 5, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cbrt_is_exact_on_cubes():
    vol = torch.tensor([0.0, 1.0, 8.0, 27.0, 64.0 ** 3, 160.0 ** 3])
    from instance_nerf_tpu_torch.ops.poolers import _cbrt

    assert _cbrt(vol).tolist() == [0.0, 1.0, 2.0, 3.0, 64.0, 160.0]
    assert math.isclose(float(_cbrt(torch.tensor([2.0]))), 2 ** (1 / 3), rel_tol=1e-7)


def test_project_masks_on_boxes_matches_jax():
    from instance_nerf_tpu.ops.roi_align import project_masks_on_boxes as j_project
    from instance_nerf_tpu_torch.ops.roi_align import project_masks_on_boxes

    rng = np.random.default_rng(3)
    masks = rng.uniform(size=(6, 12, 10, 9)) < 0.4
    boxes = _rois(rng, 6, 12.0)
    want = np.asarray(j_project(jnp.asarray(masks), jnp.asarray(boxes), (7, 7, 7)))
    got = project_masks_on_boxes(torch.from_numpy(masks), torch.from_numpy(boxes), (7, 7, 7))
    assert got.dtype == torch.float32 and got.shape == (6, 7, 7, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
