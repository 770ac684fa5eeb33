"""Parity of the port's OBB box helpers (``ops/boxes.py``) and
``MidpointOffsetCoder`` (``ops/coders.py``) with the JAX package.

Tolerance: 1e-5 relative (1e-4 absolute for coordinates near 0): the same
f32 arithmetic in both, up to an ulp of ``sin`` / ``cos`` / ``atan2`` /
``exp`` / ``log``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.ops import boxes as JB
from instance_nerf_tpu.ops.coders import MidpointOffsetCoder as JCoder
from instance_nerf_tpu_torch.ops import boxes as TB
from instance_nerf_tpu_torch.ops.coders import MidpointOffsetCoder
from tests.test_boxes import random_aabbs
from tests.test_torch_rotated_iou import random_obbs

torch.set_num_threads(2)


def _close(got, want, rtol=1e-5, atol=1e-4):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _obb2d(seed, n=40):
    rng = np.random.default_rng(seed)
    b = random_obbs(rng, n)[:, [0, 1, 3, 4, 6]]
    b[:, 4] = rng.uniform(-3 * np.pi, 3 * np.pi, n)  # angles far outside the range
    return b


@pytest.mark.parametrize("name", ["regular_obb", "obb2hbb", "obb2poly"])
def test_obb_helpers_match_jax(name):
    b = _obb2d(0)
    _close(getattr(TB, name)(torch.from_numpy(b)), getattr(JB, name)(jnp.asarray(b)))


@pytest.mark.parametrize("mode", ["180", "360"])
def test_regular_theta_is_floor_mod(mode):
    t = np.concatenate([np.linspace(-10, 10, 101), [-np.pi / 2, np.pi / 2, 0.0, -0.0]])
    t = t.astype(np.float32)
    got = TB.regular_theta(torch.from_numpy(t), mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(JB.regular_theta(jnp.asarray(t), mode)))
    cycle = 2 * np.pi if mode == "360" else np.pi
    assert np.all((got >= -np.pi / 2 - 1e-6) & (got < -np.pi / 2 + cycle + 1e-6))


def test_rectpoly2obb_matches_jax():
    polys = np.array(JB.obb2poly(jnp.asarray(_obb2d(1))))
    got = TB.rectpoly2obb(torch.from_numpy(polys))
    want = JB.rectpoly2obb(jnp.asarray(polys))
    _close(got, want)
    assert np.all(got[:, 2].numpy() >= got[:, 3].numpy())  # w >= h


def test_small_box_mask_obb_branch():
    b = random_obbs(np.random.default_rng(2), 30)
    b[:5, 3 + np.arange(5) % 3] = 5e-4  # one side below the minimum
    for min_size in (1e-3, 4.0):
        got = TB.small_box_mask(torch.from_numpy(b), min_size).numpy()
        np.testing.assert_array_equal(got, np.asarray(JB.small_box_mask(jnp.asarray(b), min_size)))
    assert not got[:5].any()


def test_midpoint_offset_decode_matches_jax():
    rng = np.random.default_rng(3)
    anchors = random_aabbs(rng, 64, size=60.0)
    deltas = rng.normal(0, 0.5, (64, 8)).astype(np.float32)
    deltas[0, 3:6] = 9.0  # beyond the log(1000 / 16) ratio clip
    deltas[1, 6:8] = [2.0, -2.0]  # beyond the +-0.5 midpoint clip
    got = MidpointOffsetCoder().decode(torch.from_numpy(deltas), torch.from_numpy(anchors))
    want = JCoder().decode(jnp.asarray(deltas), jnp.asarray(anchors))
    assert got.shape == (64, 7)
    _close(got, want)


def test_midpoint_offset_encode_matches_jax_and_round_trips():
    rng = np.random.default_rng(4)
    anchors = random_aabbs(rng, 50, size=60.0)
    gt = random_obbs(rng, 50, size=60.0, lo=4.0, hi=12.0)
    gt[:, 6] = rng.uniform(-np.pi / 2, np.pi / 2, 50)
    coder = MidpointOffsetCoder(stds=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5))
    jcoder = JCoder(stds=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5))
    enc = coder.encode(torch.from_numpy(gt), torch.from_numpy(anchors))
    _close(enc, jcoder.encode(jnp.asarray(gt), jnp.asarray(anchors)))
    dec = coder.decode(enc, torch.from_numpy(anchors)).numpy()
    # the decoded box is the gt up to the w >= l canonicalisation
    np.testing.assert_allclose(dec[:, :3], gt[:, :3], atol=1e-3)
    np.testing.assert_allclose(dec[:, 5], gt[:, 5], rtol=1e-4)
    np.testing.assert_allclose(np.sort(dec[:, 3:5], 1), np.sort(gt[:, 3:5], 1), rtol=1e-3)
