"""Parity of the port's anchor NeRF-RPN inference (``models/rpn.py``,
``train/rpn_trainer.py``, ``convert.py:rpn_params_from_jax``) with the JAX
package, in f32 on the CPU.

Anchors must be bit-identical; the head agrees to 1e-4 relative with the
JAX weights converted; proposals (valid, level ids) must be identical and
boxes agree to 1e-4. The exact comparisons hold only where no two scores
and no candidate IoU lie within float rounding of a decision: each test
asserts the margins of its inputs.

Random weights come from numpy over the flax tree's shapes
(``jax.eval_shape`` of the init, so nothing of the full model compiles for
the init), and the same weights go into both packages.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import rpn as JR
from instance_nerf_tpu.ops.rotated_iou import cal_iou_3d as j_iou_obb
from instance_nerf_tpu.train.rpn_trainer import RPNConfig as JConfig
from instance_nerf_tpu.train.rpn_trainer import RPNTrainer as JTrainer
from instance_nerf_tpu_torch.convert import rpn_params_from_jax
from instance_nerf_tpu_torch.kernels import nms_cuda
from instance_nerf_tpu_torch.models import rpn as TR
from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer

torch.set_num_threads(2)


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _random_params(shapes, seed, cls_scale=1.0):
    """numpy weights over a flax params tree of ShapeDtypeStructs, at the
    flax init's scales: backbone kernels normal(sqrt(2 / fan_in)), head
    kernels normal(0.01), zero biases, unit GroupNorm scales.
    ``cls_scale`` scales the objectness kernel (see ``CLS_SCALE``)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        keys = [p.key for p in path]
        std = 0.01 if "rpn_head" in keys else np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if keys[-2] == "cls_logits":
            std *= cls_scale
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_anchors_bitwise():
    jg, tg = JR.AnchorGenerator3D(), TR.AnchorGenerator3D()
    assert tg.num_anchors_per_location() == jg.num_anchors_per_location() == [13] * 4
    shapes = [(14, 14, 10), (7, 7, 5), (4, 4, 3), (2, 2, 2)]
    strides = [(s,) * 3 for s in (4, 8, 16, 32)]
    for a, b in zip(tg.grid_anchors(shapes, strides), jg.grid_anchors(shapes, strides)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    norm_j = JR.AnchorGenerator3D(is_normalized=True)
    norm_t = TR.AnchorGenerator3D(is_normalized=True)
    for lvl in range(4):
        np.testing.assert_array_equal(norm_t.base_anchors(lvl), norm_j.base_anchors(lvl))


@pytest.mark.parametrize("rotated", [True, False])
def test_rpn_head_and_flatten_match_jax(rotated):
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(1, *s, 16)).astype(np.float32)
             for s in ((5, 4, 3), (3, 2, 2))]
    jh = JR.RPNHead(num_anchors=13, rotated=rotated)
    params = jh.init(jax.random.key(0), [jnp.asarray(f) for f in feats])
    jo, jd = JR.flatten_head_outputs(*jh.apply(params, [jnp.asarray(f) for f in feats]))
    th = TR.RPNHead(16, 13, rotated=rotated)
    th.load_state_dict(rpn_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        to, td = TR.flatten_head_outputs(*th([torch.from_numpy(f) for f in feats]))
    assert td.shape == (1, (60 + 12) * 13, 8 if rotated else 6)
    _close(to, jo)
    _close(td, jd)


def test_anchor_padding_mask_matches_jax():
    gen = JR.AnchorGenerator3D()
    anchors = gen.grid_anchors([(6, 5, 4), (3, 3, 2)], [(4,) * 3, (8,) * 3])
    sizes = np.asarray([[14.0, 9.0, 5.0], [24.0, 20.0, 16.0]], np.float32)
    want = JR.anchor_padding_mask([jnp.asarray(a) for a in anchors], jnp.asarray(sizes), [4, 8])
    got = TR.anchor_padding_mask([torch.from_numpy(a) for a in anchors],
                                 torch.from_numpy(sizes), [4, 8])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got[0].sum() < got[1].sum() == got.shape[1]


def _filter_case(seed, rotated):
    rng = np.random.default_rng(seed)
    gen = JR.AnchorGenerator3D()
    shapes = [(6, 5, 4), (3, 3, 2), (2, 2, 1), (1, 1, 1)]
    anchors = gen.grid_anchors(shapes, [(s,) * 3 for s in (4, 8, 16, 32)])
    r = sum(a.shape[0] for a in anchors)
    obj = rng.normal(0, 2.0, (1, r)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (1, r, 8 if rotated else 6)).astype(np.float32)
    sizes = np.asarray([[22.0, 18.0, 14.0]], np.float32)
    pm = np.array(JR.anchor_padding_mask([jnp.asarray(a) for a in anchors],
                                           jnp.asarray(sizes), [4, 8, 16, 32]))
    return obj, deltas, anchors, sizes, pm


@pytest.mark.parametrize("rotated", [True, False])
def test_filter_proposals_matches_jax(rotated):
    obj, deltas, anchors, sizes, pm = _filter_case(3, rotated)
    kw = dict(pre_nms_top_n=100, post_nms_top_n=60, nms_thresh=0.3, rotated=rotated)
    want = jax.jit(functools.partial(JR.filter_proposals, **kw))(
        jnp.asarray(obj), jnp.asarray(deltas), [jnp.asarray(a) for a in anchors],
        jnp.asarray(sizes), pad_mask=jnp.asarray(pm))
    seen = []

    def sweep(x, svalid, thr):  # records the NMS input (IoU matrix or boxes)
        seen.append(x)
        return (nms_cuda.nms_sweep_plain if rotated else nms_cuda.nms_boxes_plain)(
            x, svalid, thr)

    got = TR.filter_proposals(torch.from_numpy(obj), torch.from_numpy(deltas),
                              [torch.from_numpy(a) for a in anchors],
                              torch.from_numpy(sizes), pad_mask=torch.from_numpy(pm),
                              nms_sweep=sweep, **kw)
    # margins: distinct scores, no OBB IoU within 1e-5 of the threshold
    sc = np.sort(np.asarray(want.scores[0])[np.asarray(want.valid[0])])
    assert np.diff(sc).min() > 1e-6
    if rotated:
        assert seen[0].shape == (100 + 100 + 52 + 13,) * 2
        assert np.abs(seen[0].numpy() - 0.3).min() >= 1e-5
    for f in ("valid", "level_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    _close(got.boxes, want.boxes)
    _close(got.scores, want.scores, 1e-6)
    n = int(got.valid.sum())
    assert 10 < n <= 60
    assert torch.isfinite(got.boxes).all()


@pytest.fixture(scope="module")
def rpn_tree_shapes():
    """Shapes of the flax VGG-EF RPN params tree (rotated head)."""
    jt = JTrainer(JConfig(dtype="float32", rotated_bbox=True))
    return jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4)))


def test_convert_covers_the_full_rpn_tree(rpn_tree_shapes):
    """Every leaf of the flax RPN tree lands in the port's state dict with
    its shape (conv kernels DHWIO -> OIDHW)."""
    leaves = jax.tree_util.tree_leaves_with_path(rpn_tree_shapes)
    assert len(leaves) == 96
    tree = _random_params(rpn_tree_shapes, 0)
    sd = rpn_params_from_jax(tree)
    model_sd = RPNTrainer(RPNConfig(rotated_bbox=True), device="cpu").model.state_dict()
    assert sorted(sd) == sorted(model_sd)
    assert all(sd[k].shape == model_sd[k].shape for k in sd)
    assert model_sd["rpn_head.bbox_pred.weight"].shape == (13 * 8, 256, 1, 1, 1)
    head = {k for k in sd if k.startswith("rpn_head.")}
    assert head == {f"rpn_head.{m}.{p}" for m in ("conv_0", "conv_1", "conv_2", "conv_3",
                                                  "cls_logits", "bbox_pred")
                    for p in ("weight", "bias")}


# The flax init draws the objectness kernel from normal(0.01): here its
# logits spread by about 0.07, so the top-100 sigmoid scores sit an ulp or
# two apart and rounding would decide their order. The shared weights scale
# that kernel by 3 (the scores then lie at least 1.5e-6 apart); much more
# saturates the sigmoids at 1.
CLS_SCALE = 3.0


@pytest.mark.parametrize("rotated", [True, False])
def test_predict_scene_end_to_end_matches_jax(rpn_tree_shapes, rotated):
    shapes = rpn_tree_shapes
    if not rotated:  # the AABB head predicts 6 deltas per anchor
        bp = shapes["params"]["rpn_head"]["bbox_pred"]
        shapes = jax.tree_util.tree_map(lambda x: x, shapes)
        shapes["params"]["rpn_head"]["bbox_pred"] = {
            "kernel": jax.ShapeDtypeStruct((1, 1, 1, 256, 13 * 6), bp["kernel"].dtype),
            "bias": jax.ShapeDtypeStruct((13 * 6,), bp["bias"].dtype)}
    params = _random_params(shapes, 11, cls_scale=CLS_SCALE)
    kw = dict(dtype="float32", rotated_bbox=rotated, pre_nms_top_n=128, post_nms_top_n=100)
    jt = JTrainer(JConfig(**kw))
    jt.state = (jax.tree_util.tree_map(jnp.asarray, params), None, None)
    tt = RPNTrainer(RPNConfig(**kw), device="cpu")
    tt.load_jax_params(params)
    grid = np.random.default_rng(7).uniform(0, 1, (48, 40, 36, 4)).astype(np.float32)

    jb, js, jl, jf, jo = jt.predict_scene(grid)
    before = (nms_cuda.nms_boxes.launches, nms_cuda.nms_sweep.launches)
    tb, ts, tl, tf, to = tt.predict_scene(grid)
    # CPU tensors: the plain sweeps, no kernel launch counted
    assert (nms_cuda.nms_boxes.launches, nms_cuda.nms_sweep.launches) == before
    _close(to, jo)
    for a, b in zip(tf, jf):
        assert a.shape == b.shape
        _close(a, b)
    # the scores lie more than 4 ulps of 1.0 apart, so a last-bit difference
    # of the two sigmoids cannot reorder them
    sc = np.sort(np.asarray(js))
    assert sc.size > 20 and np.diff(sc).min() > 2.5e-7
    assert tb.shape == jb.shape and tb.shape[-1] == (7 if rotated else 6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tb, jb)
    _close(ts, js, 1e-6)
