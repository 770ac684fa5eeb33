"""Parity of the port's OBB RoI-head functions and of ``RCNNTrainer`` with
``bbox_type="obb"`` with the JAX package, in f32 on the CPU.

* ``RotatedCoder`` encode and decode to 1e-6 (the decode's angle wrap is
  ``jnp.remainder``, held at negative angles and across +-pi/2);
* ``select_training_samples(box_dim=8)``: OBB gt matched by their AABB,
  ``MidpointOffsetCoder`` targets; the sample (labels, matched gt, slots)
  exact given the JAX key's uniforms, the rois and targets to 1e-6;
* ``postprocess_detections(box_dim=8)``: decoded OBBs through the OBB NMS;
  keep set, labels and roi indices exact, boxes and scores to 1e-5;
* the trainer: ``predict_scene`` held to the JAX trainer's (which decodes
  the 8-delta head as AABBs, passing no ``box_dim``), and a train step
  raising where the JAX step fails (``fastrcnn_loss``: 8 deltas against 6
  targets; ROADMAP, known gaps of the reference).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import rcnn as JR
from instance_nerf_tpu.ops.coders import RotatedCoder as JRotated
from instance_nerf_tpu.train import rcnn_trainer as JRC
from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep, nms_sweep_plain
from instance_nerf_tpu_torch.models import rcnn as TR
from instance_nerf_tpu_torch.ops.coders import RotatedCoder
from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer
from tests.test_torch_rotated_iou import random_obbs
from tests.test_torch_rpn import _random_params as random_params
from tests.test_torch_sampling import _rcnn_case, scene_uniforms

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _obb_gt(gt, seed):
    """AABB gt (..., 6) -> OBBs (center, size, angle in [-pi/2, pi/2))."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, gt.shape[:-1] + (1,))
    return np.concatenate([(gt[..., :3] + gt[..., 3:]) / 2, gt[..., 3:] - gt[..., :3], theta],
                          -1).astype(np.float32)


def test_rotated_coder_encode_matches_jax():
    rng = np.random.default_rng(0)
    anchors, gt = random_obbs(rng, 64, size=60.0), random_obbs(rng, 64, size=60.0)
    gt[0, 3:6] = 0.0  # sizes clamped to 1e-6 before the log
    got = RotatedCoder().encode(torch.from_numpy(gt), torch.from_numpy(anchors))
    want = JRotated().encode(jnp.asarray(gt), jnp.asarray(anchors))
    _close(got, want, 1e-6)


def test_rotated_coder_decode_matches_jax_and_round_trips():
    rng = np.random.default_rng(1)
    anchors = random_obbs(rng, 64, size=60.0)
    deltas = rng.normal(0, 0.4, (64, 7)).astype(np.float32)
    deltas[0, 3:6] = 12.0  # beyond the log(2000) size clip
    deltas[1:9, 6] = [-0.9, -0.5, -0.26, -0.24, 0.24, 0.26, 0.5, 0.9]  # the wrap's edges
    got = RotatedCoder().decode(torch.from_numpy(deltas), torch.from_numpy(anchors))
    want = JRotated().decode(jnp.asarray(deltas), jnp.asarray(anchors))
    _close(got, want, 1e-6)
    a = got[:, 6].numpy()
    assert (a > -np.pi / 2 - 1e-6).all() and (a <= np.pi / 2 + 1e-6).all()
    assert (a < 0).any()  # remainder, not fmod: negative angles wrap to the same range
    # encode(decode(d)) = d up to the angle's period (and the size clip)
    gt = got.clone()
    back = RotatedCoder().encode(gt, torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(back[1:, :6], deltas[1:, :6], atol=1e-4)
    turns = (back[1:, 6] - deltas[1:, 6]) * 2  # whole half-turns
    np.testing.assert_allclose(turns, np.round(turns), atol=1e-4)


@pytest.mark.parametrize("budget,frac", [(512, 0.25), (12, 0.5)])
def test_select_training_samples_obb_matches_jax(budget, frac):
    props, pvalid, gt, labels, gmask = _rcnn_case(budget + 1, n=3)
    gt = _obb_gt(gt, budget)
    key = jax.random.key(budget + 1)
    args = (props, pvalid, gt, labels, gmask)
    want = JR.select_training_samples(key, *map(jnp.asarray, args), box_dim=8,
                                      batch_size_per_image=budget, positive_fraction=frac)
    u = scene_uniforms(key, 3, props.shape[1] + gt.shape[1])
    got = TR.select_training_samples(*map(torch.from_numpy, args), box_dim=8,
                                     batch_size_per_image=budget, positive_fraction=frac,
                                     uniforms=torch.from_numpy(u))
    assert got.reg_targets.shape[-1] == 8 and got.rois.shape[-1] == 6
    for f in ("labels", "matched_gt_idx", "valid", "pos"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    # the appended gt's AABBs (obb2hbb_3d: cos / sin) agree to an ulp
    for f in ("rois", "reg_targets"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert got.pos.any()


def _obb_logits_case(seed, p=24, c=6):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 20, (1, p, 3))
    props = np.concatenate([lo, lo + rng.uniform(4, 16, (1, p, 3))], -1).astype(np.float32)
    props[0, p // 2:] = props[0, :p - p // 2] + rng.normal(0, 0.5, (p - p // 2, 6))  # overlaps
    logits = rng.normal(0, 2.0, (1, p, c)).astype(np.float32)
    deltas = rng.normal(0, 0.2, (1, p, c, 8)).astype(np.float32)
    valid = rng.uniform(size=(1, p)) < 0.9
    return logits, deltas, props.astype(np.float32), valid, np.asarray([[40.0, 36, 32]],
                                                                       np.float32)


@pytest.mark.parametrize("seed,thresh", [(0, 0.0), (1, 0.1)])
def test_postprocess_detections_obb_matches_jax(seed, thresh):
    args = _obb_logits_case(seed)
    kw = dict(score_thresh=thresh, nms_thresh=0.15, detections_per_img=150, box_dim=8)
    want = JR.postprocess_detections(*map(jnp.asarray, args), **kw)
    before = nms_sweep.launches
    got = TR.postprocess_detections(*map(torch.from_numpy, args), **kw)
    assert nms_sweep.launches == before  # CPU tensors: the plain sweep
    assert got.boxes.shape == (1, 24 * 5, 7)  # every candidate's slot
    for f in ("valid", "labels", "roi_index"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    _close(got.boxes, want.boxes, 1e-5)
    _close(got.scores, want.scores, 1e-5)
    assert 5 < int(got.valid.sum()) < int(args[3].sum()) * 5  # the NMS suppressed some
    plain = TR.postprocess_detections(*map(torch.from_numpy, args), nms_sweep=nms_sweep_plain,
                                      **kw)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def obb_trainers():
    """The JAX OBB trainer and the port's, the same random weights, f32,
    VGG-AF, 32^3."""
    kw = dict(dtype="float32", resolution=32, bbox_type="obb", backbone_type="vgg_AF",
              batch_size_per_image=32, max_rois=16, max_gt=4)
    jt = JRC.RCNNTrainer(JRC.RCNNConfig(**kw))
    shapes = jax.eval_shape(lambda k, g, r: jt.model.init(k, g, r, with_masks=True),
                            jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4)),
                            jnp.asarray([[[2.0, 2, 2, 20, 20, 20]]]))
    jt.params = random_params(shapes, 26)
    tt = RCNNTrainer(RCNNConfig(**kw), device="cpu")
    tt.load_jax_params(_np(jt.params))
    assert tt.model.box_head.bbox_pred.weight.shape[0] == 11 * 8
    return jt, tt


def test_obb_trainer_predict_scene_matches_jax(obb_trainers):
    """Both decode the first six of the 8 deltas as an AABB (no ``box_dim``
    reaches ``postprocess_detections``), so the detections are AABBs."""
    jt, tt = obb_trainers
    rng = np.random.default_rng(2)
    grid = rng.uniform(0, 1, (32, 32, 32, 4)).astype(np.float32)
    lo = rng.uniform(0, 16, (8, 3))
    rois = np.concatenate([lo, np.minimum(lo + rng.uniform(6, 16, (8, 3)), 32)],
                          1).astype(np.float32)
    jdet, _ = jt.predict_scene(grid, rois, with_masks=False)
    tdet, _ = tt.predict_scene(grid, rois, with_masks=False)
    assert tdet.boxes.shape == (25, 6)
    for f in ("valid", "labels", "roi_index"):
        np.testing.assert_array_equal(getattr(tdet, f).numpy(), np.asarray(getattr(jdet, f)),
                                      err_msg=f)
    _close(tdet.boxes, jdet.boxes, 1e-4)
    _close(tdet.scores, jdet.scores, 1e-4)


def test_obb_trainer_train_step_raises_where_jax_fails(obb_trainers):
    jt, tt = obb_trainers
    rng = np.random.default_rng(3)
    grids = rng.uniform(0, 1, (1, 32, 32, 32, 4)).astype(np.float32)
    rois = np.concatenate([np.full((1, 16, 3), 4.0), np.full((1, 16, 3), 20.0)], -1)
    gt = np.concatenate([np.full((1, 4, 3), 5.0), np.full((1, 4, 3), 19.0)], -1)
    batch = (grids, np.full((1, 3), 32.0), rois.astype(np.float32), np.ones((1, 16), bool),
             gt.astype(np.float32), np.ones((1, 4), np.int32), np.ones((1, 4), bool),
             np.ones((1, 4, 32, 32, 32), np.uint8))
    step = JRC.make_rcnn_step_fn(jt.model, JRC.optax.sgd(0.0), jt.cfg, jt.mask_slots)
    with pytest.raises(TypeError, match=r"\(1, 20, 8\), \(1, 20, 6\)"):
        jax.eval_shape(step, jt.params, JRC.optax.sgd(0.0).init(jt.params), jax.random.key(0),
                       *map(jnp.asarray, batch))
    tt.init_state()
    with pytest.raises(ValueError, match="8 box deltas against 6-wide targets"):
        tt.train_step_fn()(tt.state, *map(torch.from_numpy, batch))
