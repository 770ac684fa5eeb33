"""Parity of the port's legacy ROIPool and proposal classifier with the JAX
package on the same numpy inputs, at the JAX tests' shapes
(``tests/test_legacy_roi_pool.py``, ``tests/test_legacy_classifier.py``).

Tolerances: 1e-6 of the output's largest magnitude for the sampled and
interpolated features (the same f32 ops in the same order; ``cos`` / ``sin``
may round an ulp apart), exact for the masked max-pool of exact inputs and
for the AABB integer crop, bit-exact for the chunked port against one chunk,
1e-5 for the classifier's scores. The rotated rois' lattice points stay away
from integer coordinates, where the 8-corner weighting jumps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.models.legacy_classifier import ProposalClassifier as JProposalClassifier
from instance_nerf_tpu.ops import legacy_roi_pool as J
from instance_nerf_tpu_torch.convert import legacy_classifier_params_from_jax
from instance_nerf_tpu_torch.models.legacy_classifier import (
    LegacyProposalScorer,
    ProposalClassifier,
)
from instance_nerf_tpu_torch.ops import legacy_roi_pool as L

torch.set_num_threads(2)


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def test_eight_corner_sample_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(6, 7, 8, 3)).astype(np.float32)
    pts = rng.uniform(-1.5, 8.5, (200, 3)).astype(np.float32)  # some out of bounds
    want = J.eight_corner_sample(jnp.asarray(feat), jnp.asarray(pts))
    got = L.eight_corner_sample(torch.from_numpy(feat), torch.from_numpy(pts))
    _close(got.numpy(), want)
    assert float(got[~torch.all((torch.from_numpy(pts) >= 0)
                                & (torch.from_numpy(pts) <= torch.tensor([5., 6., 7.])),
                                dim=-1)].abs().max()) == 0.0
    # integer points: the 8 corners are the point itself (the weighting is
    # the identity up to the rounding of the 8-term sum), as in JAX exactly
    grid = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    grid = grid.astype(np.float32)
    feat5 = rng.normal(size=(5, 5, 5, 2)).astype(np.float32)
    got = L.eight_corner_sample(torch.from_numpy(feat5), torch.from_numpy(grid))
    want = J.eight_corner_sample(jnp.asarray(feat5), jnp.asarray(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), feat5.reshape(-1, 2), rtol=1e-6)


@pytest.mark.parametrize("output_size", [(1, 1, 1), (2, 3, 2), (5, 5, 5)])
def test_adaptive_maxpool_masked_matches_jax(output_size):
    rng = np.random.default_rng(1)
    g = 8
    feats = rng.normal(size=(4, g, g, g, 3)).astype(np.float32)
    sizes = np.asarray([[8, 8, 8], [3, 5, 7], [1, 2, 8], [6, 4, 3]], np.int32)
    got = L._adaptive_maxpool_masked(torch.from_numpy(feats), torch.from_numpy(sizes),
                                     output_size)
    for i in range(4):
        want = J._adaptive_maxpool_masked(jnp.asarray(feats[i]), jnp.asarray(sizes[i]),
                                          output_size)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("output_size", [(1, 1, 1), (3, 3, 3), (2, 4, 1)])
def test_trilinear_resize_ac_matches_jax(output_size):
    rng = np.random.default_rng(2)
    g = 8
    feats = rng.normal(size=(3, g, g, g, 2)).astype(np.float32)
    sizes = np.asarray([[8, 8, 8], [3, 5, 7], [1, 2, 6]], np.int32)
    got = L._trilinear_resize_ac(torch.from_numpy(feats), torch.from_numpy(sizes), output_size)
    for i in range(3):
        want = J._trilinear_resize_ac(jnp.asarray(feats[i]), jnp.asarray(sizes[i]),
                                      output_size)
        _close(got[i].numpy(), want)


def _pool_inputs(rotated):
    rng = np.random.default_rng(3)
    levels = [rng.normal(size=(16, 16, 12, 4)).astype(np.float32),
              rng.normal(size=(8, 8, 6, 4)).astype(np.float32)]
    if rotated:  # the JAX test's rois, theta off 0, and more at both levels
        rois = np.asarray([[8.0, 8.0, 6.0, 8.0, 5.0, 6.0, 0.4],
                           [6.0, 9.0, 5.0, 4.0, 7.0, 4.0, -1.1],
                           [10.0, 6.0, 6.0, 6.0, 6.0, 8.0, 0.3],
                           [15.3, 14.1, 10.7, 21.0, 11.0, 9.0, 1.2],
                           [20.2, 11.9, 12.4, 30.0, 26.0, 14.0, -0.7],
                           [-1.3, 3.1, 2.2, 5.0, 5.5, 6.5, 2.9]], np.float32)
    else:  # interior AABBs
        rois = np.asarray([[4.0, 4.0, 4.0, 12.0, 14.0, 10.0],
                           [2.5, 3.0, 1.0, 9.5, 8.0, 7.0],
                           [6.0, 6.0, 4.0, 26.0, 22.0, 18.0],
                           [8.0, 2.0, 2.0, 28.0, 30.0, 20.0],
                           [1.0, 1.0, 1.0, 5.0, 5.0, 5.0]], np.float32)
    level_ids = np.asarray([0, 0, 1, 1, 0, 1][:len(rois)], np.int32)
    return levels, rois, level_ids


@pytest.mark.parametrize("rotated", [True, False], ids=["rotated", "aabb"])
@pytest.mark.parametrize("kind,output_size", [("pooling", (2, 2, 2)),
                                              ("interpolation", (3, 3, 3))])
def test_legacy_roi_pool_matches_jax(rotated, kind, output_size):
    levels, rois, level_ids = _pool_inputs(rotated)
    args = dict(output_size=output_size, extracting_type=kind, rotated=rotated, max_grid=16)
    want = np.asarray(J.legacy_roi_pool(tuple(jnp.asarray(f) for f in levels),
                                        jnp.asarray(rois), jnp.asarray(level_ids), (2, 4),
                                        **args))
    t_levels = [torch.from_numpy(f) for f in levels]
    got = L.legacy_roi_pool(t_levels, torch.from_numpy(rois), torch.from_numpy(level_ids),
                            (2, 4), **args)
    assert got.shape == (len(rois), *output_size, 4)
    if not rotated and kind == "pooling":  # integer crops: exact
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.numpy(), want)
    # one roi a chunk is the same, bit for bit
    one = L.legacy_roi_pool(t_levels, torch.from_numpy(rois), torch.from_numpy(level_ids),
                            (2, 4), chunk=1, **args)
    assert torch.equal(one, got)


def test_roi_chunk_budget():
    # the card's legacy path: max_grid 32, 256 channels, about 2 GiB a chunk
    n = L.roi_chunk(32, 256)
    per_roi = 32 ** 3 * (256 * 16 + 96)
    assert n == (2 << 30) // per_roi and n * per_roi <= 2 << 30
    assert L.roi_chunk(64, 4096) == 1


def test_proposal_classifier_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 5, 5, 5, 16)).astype(np.float32)  # (B, P, w, l, h, C)
    jm = JProposalClassifier(num_classes=2)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    m = ProposalClassifier(16, (5, 5, 5), num_classes=2)
    m.load_state_dict(legacy_classifier_params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        flat = m(torch.from_numpy(x.reshape(21, 5, 5, 5, 16)))
    assert got.shape == (3, 7, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flat.numpy(), want.reshape(21, 2), rtol=1e-5, atol=1e-5)

    # the scorer on the CPU: the legacy pool, then the classifier
    levels, rois, level_ids = _pool_inputs(True)
    scorer = LegacyProposalScorer(in_channels=4, output_size=(1, 1, 1), conv_channels=(8,),
                                  rep_size=16, max_grid=16, device="cpu")
    scores, pooled = scorer([torch.from_numpy(f) for f in levels], torch.from_numpy(rois),
                            torch.from_numpy(level_ids), (2, 4))
    assert scores.shape == (len(rois), 2) and pooled.shape == (len(rois), 1, 1, 1, 4)
    with torch.no_grad():
        assert torch.equal(scores, scorer.model(pooled))
