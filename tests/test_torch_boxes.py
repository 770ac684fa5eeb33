"""Parity of the port's AABB geometry and AABBCoder with the JAX package.

Same numpy inputs through both; float outputs to 1e-6 (both run the same
f32 ops in the same order), masks exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.ops import boxes as JB
from instance_nerf_tpu.ops.coders import AABBCoder as JAABBCoder
from instance_nerf_tpu_torch.ops import boxes as TB
from instance_nerf_tpu_torch.ops.coders import BBOX_XFORM_CLIP, AABBCoder
from tests.test_boxes import random_aabbs

torch.set_num_threads(2)


def _boxes(seed, n, size=50.0):
    rng = np.random.default_rng(seed)
    b = random_aabbs(rng, n, size=size)
    b[:3] = 0.0  # padded (zero-volume) boxes, as fixed-shape callers pass
    b[3, 3:] = b[3, :3]  # degenerate: zero extent
    return b


def test_aabb_volume_and_iou():
    b1, b2 = _boxes(0, 23), _boxes(1, 17)
    np.testing.assert_allclose(
        TB.aabb_volume(torch.from_numpy(b1)).numpy(),
        np.asarray(JB.aabb_volume(jnp.asarray(b1))), rtol=1e-6, atol=1e-6)
    got = TB.box_iou_3d(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(JB.box_iou_3d(jnp.asarray(b1), jnp.asarray(b2)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_clip_and_small_box_mask():
    rng = np.random.default_rng(2)
    b = (random_aabbs(rng, 40, size=80.0) - 15.0).astype(np.float32)
    b[5, 3:] = b[5, :3] + 0.005  # below the 1e-2 minimum side
    size = np.asarray([48.0, 40.0, 36.0], np.float32)
    got = TB.clip_boxes_to_mesh(torch.from_numpy(b), torch.from_numpy(size))
    want = JB.clip_boxes_to_mesh(jnp.asarray(b), jnp.asarray(size))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for min_size in (1e-2, 3.0):
        np.testing.assert_array_equal(
            TB.small_box_mask(got, min_size).numpy(),
            np.asarray(JB.small_box_mask(want, min_size)))


@pytest.mark.parametrize("seed", [0, 1])
def test_aabb_coder_encode_decode(seed):
    rng = np.random.default_rng(seed)
    props = random_aabbs(rng, 30, size=60.0)
    gt = random_aabbs(rng, 30, size=60.0)
    jc, tc = JAABBCoder(), AABBCoder()
    assert tc.bbox_xform_clip == BBOX_XFORM_CLIP == jc.bbox_xform_clip
    enc_t = tc.encode(torch.from_numpy(gt), torch.from_numpy(props))
    enc_j = jc.encode(jnp.asarray(gt), jnp.asarray(props))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), rtol=1e-6, atol=1e-6)
    deltas = rng.normal(0, 1.0, (30, 6)).astype(np.float32)
    deltas[0, 3:] = 20.0  # beyond the log(2000) clip
    dec_t = tc.decode(torch.from_numpy(deltas), torch.from_numpy(props))
    dec_j = jc.decode(jnp.asarray(deltas), jnp.asarray(props))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-6, atol=1e-6)
    # round trip
    back = tc.decode(enc_t, torch.from_numpy(props)).numpy()
    np.testing.assert_allclose(back, gt, rtol=1e-5, atol=1e-4)


def test_obb_center_inside_mesh_matches_jax():
    rng = np.random.default_rng(9)
    obb = rng.uniform(-5, 45, (64, 7)).astype(np.float32)
    obb[0, :3] = [0.0, 40.0, 30.0]  # on the boundary: inside
    obb[1, :3] = [40.0, 40.0, np.nextafter(np.float32(30), np.float32(31))]
    size = (40.0, 40.0, 30.0)
    want = np.asarray(JB.obb_center_inside_mesh(jnp.asarray(obb), size))
    got = TB.obb_center_inside_mesh(torch.from_numpy(obb), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] and not got[1] and 0 < got.sum() < 64
