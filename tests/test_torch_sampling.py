"""Parity of the port's matcher and sampler (``ops/sampling.py``) and of the
RCNN's training-sample selection (``models/rcnn.py:select_training_samples``,
``_pack``) with the JAX package on the CPU.

The JAX package draws the sampler's uniforms from a key; the port takes
them as a tensor, and given the key's uniforms every mask, label, packed
slot and matched index must be identical. Box targets agree to 1e-6 (the
same f32 arithmetic on the same rows).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import rcnn as JR
from instance_nerf_tpu.ops import sampling as JS
from instance_nerf_tpu_torch.models import rcnn as TR
from instance_nerf_tpu_torch.ops import sampling as TS

torch.set_num_threads(2)


def jax_uniforms(key, n):
    """The uniforms ``balanced_sample`` draws from ``key`` for ``n`` rows:
    (2, n), the positives' then the negatives'."""
    kp, kn = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                     np.asarray(jax.random.uniform(kn, (n,)))])


def scene_uniforms(key, n_scenes, n):
    """(N, 2, n): per scene the draws of ``split(key, N)[i]``, as the JAX
    package's ``rpn_loss`` and ``select_training_samples`` draw them."""
    return np.stack([jax_uniforms(k, n) for k in jax.random.split(key, n_scenes)])


def _quality(rng, m, n, levels=None):
    q = rng.uniform(0, 1, (m, n)).astype(np.float32)
    if levels:  # quantised values: ties within columns and rows
        q = np.round(q * levels) / levels
    return q


@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("levels", [None, 5], ids=["distinct", "ties"])
def test_match_proposals_matches_jax(low_quality, levels):
    rng = np.random.default_rng(0 if levels is None else 1)
    for m, n in ((1, 7), (5, 40), (8, 300)):
        q = _quality(rng, m, n, levels)
        gt_valid = rng.uniform(size=m) < 0.8
        gt_valid[0] = True
        for valid in (None, gt_valid):
            want = JS.match_proposals(jnp.asarray(q), 0.6, 0.3, low_quality,
                                      None if valid is None else jnp.asarray(valid))
            got = TS.match_proposals(torch.from_numpy(q), 0.6, 0.3, low_quality,
                                     None if valid is None else torch.from_numpy(valid))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_match_proposals_batched_equals_per_scene():
    rng = np.random.default_rng(2)
    q = _quality(rng, 6, 50, 4).reshape(1, 6, 50).repeat(3, 0)
    q[1] = _quality(rng, 6, 50)
    valid = rng.uniform(size=(3, 6)) < 0.7
    got = TS.match_proposals(torch.from_numpy(q), 0.5, 0.2, True, torch.from_numpy(valid))
    for i in range(3):
        one = TS.match_proposals(torch.from_numpy(q[i]), 0.5, 0.2, True,
                                 torch.from_numpy(valid[i]))
        assert torch.equal(got[i], one)


@pytest.mark.parametrize("budget,frac", [(16, 0.25), (64, 0.5), (8, 1.0)])
def test_balanced_sample_matches_jax(budget, frac):
    rng = np.random.default_rng(budget)
    for n, p_pos in ((30, 0.1), (200, 0.3), (500, 0.02)):
        labels = np.where(rng.uniform(size=n) < p_pos, rng.integers(1, 5, n),
                          rng.integers(-2, 1, n)).astype(np.int32)
        valid = rng.uniform(size=n) < 0.9
        for v in (None, valid):
            key = jax.random.key(n + budget)
            want = JS.balanced_sample(key, jnp.asarray(labels), budget, frac,
                                      None if v is None else jnp.asarray(v))
            got = TS.balanced_sample(torch.from_numpy(labels), budget, frac,
                                     None if v is None else torch.from_numpy(v),
                                     uniforms=torch.from_numpy(jax_uniforms(key, n)))
            np.testing.assert_array_equal(got.pos_mask.numpy(), np.asarray(want.pos_mask))
            np.testing.assert_array_equal(got.neg_mask.numpy(), np.asarray(want.neg_mask))


def test_balanced_sample_batched_and_drawn():
    """Scenes batched along a leading dim sample each with its own draws;
    drawn from a generator the budget and fraction hold."""
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(rng.integers(-1, 3, (3, 400)))
    key = jax.random.key(3)
    u = torch.from_numpy(scene_uniforms(key, 3, 400))
    got = TS.balanced_sample(labels, 32, 0.25, uniforms=u)
    for i in range(3):
        one = TS.balanced_sample(labels[i], 32, 0.25, uniforms=u[i])
        assert torch.equal(got.pos_mask[i], one.pos_mask)
        assert torch.equal(got.neg_mask[i], one.neg_mask)
    drawn = TS.balanced_sample(labels, 32, 0.25, generator=torch.Generator().manual_seed(0))
    assert drawn.pos_mask.sum(-1).tolist() == [8, 8, 8]
    assert (drawn.pos_mask | drawn.neg_mask).sum(-1).tolist() == [32, 32, 32]
    assert not (drawn.pos_mask & (labels < 1)).any()
    assert not (drawn.neg_mask & (labels != 0)).any()


def test_rank_within_orders_members_by_uniform():
    u = torch.tensor([0.5, 0.1, 0.9, 0.3, 0.2])
    member = torch.tensor([True, False, True, True, False])
    ranks = TS._rank_within(u, member)
    assert ranks[member].tolist() == [1, 2, 0]
    assert sorted(ranks.tolist()) == [0, 1, 2, 3, 4]
    want = JS._rank_within(jax.random.key(0), jnp.asarray(member.numpy()))
    # the JAX ranks with that key's uniforms
    uj = torch.from_numpy(np.array(jax.random.uniform(jax.random.key(0), (5,))))
    assert TS._rank_within(uj, member).tolist() == np.asarray(want).tolist()


def test_pack_is_stable():
    mask = np.array([False, True, True, False, True, False, True])
    for size in (2, 4, 7, 10):
        want_idx, want_valid = JR._pack(jnp.asarray(mask), size)
        idx, valid = TR._pack(torch.from_numpy(mask), size)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def _rcnn_case(seed, n=2, p=24, k=4, grid=32.0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, grid * 0.6, (n, k, 3))
    gt = np.concatenate([lo, lo + rng.uniform(4, 12, (n, k, 3))], -1).astype(np.float32)
    # proposals: jittered gt copies and random boxes
    jit = gt[:, rng.integers(0, k, p)] + rng.normal(0, 1.5, (n, p, 6)).astype(np.float32)
    rnd_lo = rng.uniform(0, grid * 0.7, (n, p, 3))
    rnd = np.concatenate([rnd_lo, rnd_lo + rng.uniform(2, 10, (n, p, 3))], -1)
    pick = rng.uniform(size=(n, p, 1)) < 0.5
    props = np.where(pick, jit, rnd).astype(np.float32)
    props[..., 3:] = np.maximum(props[..., 3:], props[..., :3] + 0.5)
    pvalid = rng.uniform(size=(n, p)) < 0.85
    labels = rng.integers(1, 11, (n, k)).astype(np.int32)
    gmask = np.ones((n, k), bool)
    gmask[0, -1] = False
    if n > 2:
        gmask[2] = False  # a background scene
    return props, pvalid, gt, labels, gmask


@pytest.mark.parametrize("budget,frac", [(512, 0.25), (12, 0.5)])
def test_select_training_samples_matches_jax(budget, frac):
    props, pvalid, gt, labels, gmask = _rcnn_case(budget, n=3)
    key = jax.random.key(budget)
    want = JR.select_training_samples(
        key, *(jnp.asarray(a) for a in (props, pvalid, gt, labels, gmask)),
        batch_size_per_image=budget, positive_fraction=frac)
    u = scene_uniforms(key, 3, props.shape[1] + gt.shape[1])
    got = TR.select_training_samples(
        *(torch.from_numpy(a) for a in (props, pvalid, gt, labels, gmask)),
        batch_size_per_image=budget, positive_fraction=frac, uniforms=torch.from_numpy(u))
    assert got.rois.shape == want.rois.shape  # min(S, P + K) slots
    for f in ("labels", "matched_gt_idx", "valid", "pos"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets),
                               rtol=1e-6, atol=1e-6)
    assert got.pos.any() and (got.valid & ~got.pos).any()


def test_select_training_samples_obb_raises():
    """``box_dim = 8`` no longer raises: the OBB gt are matched by their AABB
    and the targets are 8 midpoint-offset deltas, as in the JAX package
    (held there in ``tests/test_torch_rcnn_obb.py``)."""
    props, pvalid, gt, labels, gmask = _rcnn_case(0)
    obb = np.concatenate([(gt[..., :3] + gt[..., 3:]) / 2, gt[..., 3:] - gt[..., :3],
                          np.zeros(gt.shape[:-1] + (1,), np.float32)], -1)
    key = jax.random.key(0)
    want = JR.select_training_samples(
        key, *(jnp.asarray(a) for a in (props, pvalid, obb, labels, gmask)), box_dim=8)
    got = TR.select_training_samples(
        *(torch.from_numpy(a) for a in (props, pvalid, obb, labels, gmask)), box_dim=8,
        uniforms=torch.from_numpy(scene_uniforms(key, 2, props.shape[1] + gt.shape[1])))
    assert got.reg_targets.shape == (2, props.shape[1] + gt.shape[1], 8)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets),
                               rtol=1e-6, atol=1e-6)
