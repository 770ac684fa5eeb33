"""Parity of the port's FCOS proposal inference (``models/fcos.py``,
``train/fcos_trainer.py``, ``convert.py:fcos_params_from_jax``) with the JAX
package on the CPU.

Locations, padding masks and the AABB decode must be identical; the OBB
decode agrees to 1e-6 (its angle is an f64 ``atan2`` rounded to f32). The
head agrees to 1e-4 relative in f32 and to 2e-2 of the largest output in
bf16 (a bf16 ulp is 2^-8 relative, and the two packages round the convs'
sums in another order). ``fcos_postprocess`` on the same head outputs must
give identical valid masks, level ids and order, and boxes to 1e-6, in f32
and in bf16 with forced score ties (``lax.top_k`` breaks ties to the lower
index; the port sorts stably). End to end, proposals are compared where
the inputs leave no score within float rounding of another (each test
asserts its margins): identical count, order and level ids, boxes to 1e-5
of the largest coordinate.

Random weights come from numpy over the flax tree's shapes, and the same
weights go into both packages.
"""
import math
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import fcos as JF
from instance_nerf_tpu.models.backbones import build_backbone as j_build_backbone
from instance_nerf_tpu.ops.rotated_iou import cal_iou_3d as j_iou_obb
from instance_nerf_tpu.train.fcos_trainer import FCOSConfig as JConfig
from instance_nerf_tpu.train.fcos_trainer import FCOSTrainer as JTrainer
from instance_nerf_tpu_torch.convert import fcos_params_from_jax
from instance_nerf_tpu_torch.kernels import nms_cuda
from instance_nerf_tpu_torch.models import fcos as TF
from instance_nerf_tpu_torch.models.backbones import build_backbone
from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

torch.set_num_threads(2)

STRIDES = (4, 8, 16, 32)
LEVEL_SHAPES = [(8, 8, 6), (4, 4, 3), (2, 2, 2), (1, 1, 1)]


def _close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _random_params(shapes, seed, cls_scale=1.0):
    """numpy weights over a flax FCOS params tree of ShapeDtypeStructs, at
    the flax init's scales: backbone kernels normal(sqrt(2 / fan_in)), head
    kernels normal(0.01) (``cls_logits`` and ``centerness`` times
    ``cls_scale``), zero biases but the focal prior -log(99) on
    ``cls_logits``, unit GroupNorm scales; the per-level ``scales`` drawn
    from [0.8, 1.2] so that each level's own scale is checked."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "scales":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if keys[-1] == "scale":
            return np.ones(s.shape, np.float32)
        if keys[-1] == "bias":
            prior = -math.log(99.0) if keys[-2] == "cls_logits" else 0.0
            return np.full(s.shape, prior, np.float32)
        std = 0.01 if "head" in keys else np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if keys[-2] in ("cls_logits", "centerness"):
            std *= cls_scale
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _head_sd(params):
    """The port's ``FCOSHead`` state dict of a flax ``FCOSHead`` tree."""
    sd = fcos_params_from_jax({"head": params["params"]})
    return {k[len("head."):]: v for k, v in sd.items()}


def test_compute_locations_and_padding_mask_exact():
    want = JF.compute_locations(LEVEL_SHAPES, STRIDES)
    got = TF.compute_locations(LEVEL_SHAPES, STRIDES)
    for f in want._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    sizes = np.asarray([[40, 40, 40], [22, 17, 9], [1, 40, 40]], np.float32)
    pm_j = np.asarray(JF.padding_mask(want, jnp.asarray(sizes)))
    pm_t = TF.padding_mask(got, torch.from_numpy(sizes)).numpy()
    np.testing.assert_array_equal(pm_t, pm_j)
    assert pm_t[0].all() and 0 < pm_t[1].sum() < pm_t.shape[1]


def _head_case(use_obb, dtype):
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(1, *s, 32)).astype(np.float32) for s in ((6, 5, 4), (3, 3, 2))]
    jh = JF.FCOSHead(num_convs=2, num_levels=2, fpn_strides=(4, 8), use_obb=use_obb,
                     dtype=dtype)
    shapes = jax.eval_shape(jh.init, jax.random.key(0), [jnp.asarray(f) for f in feats])
    params = _random_params(shapes, 4, cls_scale=20.0)
    return feats, jh, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_obb", [False, True])
def test_fcos_head_matches_jax(use_obb, dtype):
    bf16 = dtype == "bfloat16"
    feats, jh, params = _head_case(use_obb, jnp.bfloat16 if bf16 else None)
    jl, jr, jc = jh.apply(params, [jnp.asarray(f) for f in feats], train=False)
    th = TF.FCOSHead(32, num_convs=2, num_levels=2, fpn_strides=(4, 8), use_obb=use_obb,
                     dtype=torch.bfloat16 if bf16 else None)
    th.load_state_dict(_head_sd(params), strict=True)
    with torch.no_grad():
        tl, tr, tc = th([torch.from_numpy(f) for f in feats], train=False)
    tol = 2e-2 if bf16 else 1e-4
    for lvl in range(2):
        # the dtype rules: logits and centerness in the compute dtype, the
        # regression promoted to f32 by the f32 level scale
        assert tl[lvl].dtype == tc[lvl].dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert tr[lvl].dtype == torch.float32 and jr[lvl].dtype == jnp.float32
        assert tr[lvl].shape[-1] == (8 if use_obb else 6)
        _close(tl[lvl], jl[lvl], tol)
        _close(tc[lvl], jc[lvl], tol)
        _close(tr[lvl], jr[lvl], tol)
        assert (tr[lvl][..., :6] >= 0).all()  # relu'd distances, times the stride


def test_decode_fcos_aabb_exact_and_obb_to_1e6():
    rng = np.random.default_rng(5)
    locs = rng.uniform(0, 60, (500, 3)).astype(np.float32)
    reg = np.concatenate([rng.uniform(0, 20, (500, 6)), rng.uniform(-0.7, 0.7, (500, 2))],
                         1).astype(np.float32)
    reg[:20, :6] = 0.0  # degenerate boxes: the mid == 0 branch of the angle
    reg[20:40, 6:] = 0.5  # offsets on the box's edge
    want = np.asarray(JF.decode_fcos_aabb(jnp.asarray(locs), jnp.asarray(reg[:, :6])))
    got = TF.decode_fcos_aabb(torch.from_numpy(locs), torch.from_numpy(reg[:, :6])).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(JF.decode_fcos_obb(jnp.asarray(locs), jnp.asarray(reg)))
    got = TF.decode_fcos_obb(torch.from_numpy(locs), torch.from_numpy(reg)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _postprocess_case(use_obb, ties):
    """Head outputs over LEVEL_SHAPES' 441 locations and a padding mask.
    ``ties``: bf16 logits and centerness drawn from a few values, so many
    scores tie exactly."""
    rng = np.random.default_rng(6 + use_obb)
    info = JF.compute_locations(LEVEL_SHAPES, STRIDES)
    r = info.locations.shape[0]
    if ties:
        logits = rng.choice(np.asarray([-4.6, -2.0, -1.0, 0.5], np.float32), (1, r))
        ctr = rng.choice(np.asarray([-1.0, 0.0, 1.5], np.float32), (1, r))
    else:
        logits = rng.normal(-1.0, 2.0, (1, r)).astype(np.float32)
        ctr = rng.normal(0.0, 1.5, (1, r)).astype(np.float32)
    dist = rng.uniform(0, 12, (1, r, 6)) * np.asarray(info.strides)[None, :, None] / 4
    reg = np.concatenate([dist, rng.uniform(-0.6, 0.6, (1, r, 2))], -1) if use_obb else dist
    sizes = np.asarray([[30.0, 26.0, 20.0]], np.float32)
    return info, logits, reg.astype(np.float32), ctr, sizes


@pytest.mark.parametrize("ties", [False, True], ids=["f32", "bf16_ties"])
@pytest.mark.parametrize("use_obb", [False, True], ids=["aabb", "obb"])
def test_fcos_postprocess_matches_jax(use_obb, ties):
    info, logits, reg, ctr, sizes = _postprocess_case(use_obb, ties)
    jdt = jnp.bfloat16 if ties else jnp.float32
    kw = dict(num_levels=4, pre_nms_top_n=100, nms_thresh=0.3, fpn_post_nms_top_n=80,
              use_obb=use_obb)
    pm = JF.padding_mask(info, jnp.asarray(sizes))
    want = jax.jit(lambda lg, rg, ct: JF.fcos_postprocess(
        info, lg, rg, ct, jnp.asarray(sizes), pad_mask=pm, **kw))(
        jnp.asarray(logits, jdt), jnp.asarray(reg), jnp.asarray(ctr, jdt))
    tdt = torch.bfloat16 if ties else torch.float32
    tinfo = TF.compute_locations(LEVEL_SHAPES, STRIDES)
    seen = []

    def sweep(x, svalid, thr):  # records the NMS input
        seen.append(x)
        return (nms_cuda.nms_sweep_plain if use_obb else nms_cuda.nms_boxes_plain)(
            x, svalid, thr)

    got = TF.fcos_postprocess(
        tinfo, torch.from_numpy(logits).to(tdt), torch.from_numpy(reg),
        torch.from_numpy(ctr).to(tdt), torch.from_numpy(sizes),
        pad_mask=torch.from_numpy(np.asarray(pm)), nms_sweep=sweep, **kw)
    assert got.scores.dtype == tdt
    if ties:  # the top-100 of a level hold tied scores, which the order must break alike
        s = np.asarray(want.scores[0], np.float32)
        assert len(np.unique(s[s > 0])) < (s > 0).sum() // 4
    if use_obb:  # no candidate IoU within float rounding of the threshold
        iou = seen[0].numpy()
        # the IoU of the 129 valid ones of the 4 x 100 candidates
        assert iou.shape == (129, 129) and np.abs(iou - 0.3).min() >= 1e-5
    for f in ("valid", "level_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    v = got.valid.numpy()
    assert 10 < v.sum() <= 80
    # bf16 scores are equal (the sigmoid's roundings are XLA's); f32 ones
    # differ by an ulp where torch's and XLA's f32 sigmoids do
    np.testing.assert_allclose(got.scores.float().numpy(), np.asarray(want.scores, np.float32),
                               rtol=0 if ties else 1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6,
                               atol=1e-6 * float(np.abs(np.asarray(want.boxes)).max()))


@pytest.fixture(scope="module")
def fcos_tree_shapes():
    """Shapes of the flax VGG-EF FCOS params tree (rotated head, 4 convs a
    tower, the trainer's default)."""
    jt = JTrainer(JConfig(dtype="float32", rotated_bbox=True))
    return jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4)))


def test_convert_covers_the_full_fcos_tree(fcos_tree_shapes):
    """Every leaf of the flax FCOS tree, ``head/scales`` among them, lands in
    the port's state dict with its shape; the load is strict."""
    leaves = jax.tree_util.tree_leaves_with_path(fcos_tree_shapes)
    head = [p for p, _ in leaves if p[1].key == "head"]
    assert len(head) == 4 * 2 * 4 + 3 * 2 + 1  # towers (conv + GN, 2 leaves each), outputs, scales
    tree = _random_params(fcos_tree_shapes, 0)
    sd = fcos_params_from_jax(tree)
    trainer = FCOSTrainer(FCOSConfig(rotated_bbox=True), device="cpu")
    model_sd = trainer.model.state_dict()
    assert len(sd) == len(leaves) and sorted(sd) == sorted(model_sd)
    assert all(sd[k].shape == model_sd[k].shape for k in sd)
    assert model_sd["head.bbox_pred.weight"].shape == (8, 256, 3, 3, 3)
    np.testing.assert_array_equal(sd["head.scales"].numpy(),
                                  np.asarray(tree["params"]["head"]["scales"]))
    trainer.load_jax_params(tree)  # strict
    assert torch.equal(trainer.model.head.scales, sd["head.scales"])


def _small_fcos_shapes(use_obb):
    """The flax tree of a 2-conv FCOS head over VGG-EF (what the trainer
    builds with ``num_convs=2``)."""
    model = JF.FCOSOverNeRF(backbone=j_build_backbone("vgg_EF", input_size=160),
                            num_convs=2, use_obb=use_obb)
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 32, 4))), model


def test_fcos_over_nerf_forward_matches_jax():
    """VGG-EF + a 2-conv head on a 64^3 grid, f32, converted weights."""
    shapes, jm = _small_fcos_shapes(True)
    params = _random_params(shapes, 8)
    grid = np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 64, 4)).astype(np.float32)
    jinfo, jl, jr, jc, jf = jax.jit(lambda p, g: jm.apply(p, g, train=False))(
        params, jnp.asarray(grid))
    tm = TF.FCOSOverNeRF(build_backbone("vgg_EF", input_size=160), num_convs=2, use_obb=True)
    tm.load_state_dict(fcos_params_from_jax(params), strict=True)
    with torch.no_grad():
        tinfo, tl, tr, tc, tf = tm(torch.from_numpy(grid))
    assert [tuple(f.shape) for f in tf] == [tuple(f.shape) for f in jf]
    assert tl.shape == (1, 16 ** 3 + 8 ** 3 + 4 ** 3 + 2 ** 3)
    for f in jinfo._fields:
        np.testing.assert_array_equal(getattr(tinfo, f).numpy(), np.asarray(getattr(jinfo, f)))
    for a, b in zip(tf, jf):
        _close(a, b)
    _close(tl, jl)
    _close(tc, jc)
    _close(tr, jr)


@pytest.mark.parametrize("rotated", [True, False])
def test_predict_scene_end_to_end_matches_jax(rotated):
    """``FCOSTrainer.predict_scene``: a 40x36x30 grid padded to 64x64x32,
    f32, a 2-conv head, 128 candidates a level into the NMS and 100 after."""
    shapes, _ = _small_fcos_shapes(rotated)
    # cls and centerness kernels at 3x the init scale put the valid scores
    # more than 5e-6 apart (asserted below), twice what the two packages'
    # f32 convs differ by; much more saturates the sigmoids at 1
    params = _random_params(shapes, 11, cls_scale=3.0)
    kw = dict(dtype="float32", rotated_bbox=rotated, num_convs=2, pre_nms_top_n=128,
              fpn_post_nms_top_n=100)
    jt = JTrainer(JConfig(**kw))
    jt.state = types.SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray, params))
    tt = FCOSTrainer(FCOSConfig(**kw), device="cpu")
    tt.load_jax_params(params)
    grid = np.random.default_rng(7).uniform(0, 1, (40, 36, 30, 4)).astype(np.float32)

    jb, js, jl = jt.predict_scene(grid)
    before = (nms_cuda.nms_boxes.launches, nms_cuda.nms_sweep.launches)
    tb, ts, tl = tt.predict_scene(grid)
    # CPU tensors: the plain sweeps, no kernel launch counted
    assert (nms_cuda.nms_boxes.launches, nms_cuda.nms_sweep.launches) == before
    sc = np.sort(np.asarray(js))
    assert sc.size > 20 and np.diff(sc).min() > 5e-6
    if rotated:
        iou = np.asarray(jax.jit(lambda b: j_iou_obb(b[:, None], b[None]))(jnp.asarray(jb)))
        assert np.abs(iou[np.triu_indices(len(jb), 1)] - 0.3).min() >= 1e-5
    assert tb.shape == jb.shape and tb.shape[-1] == (7 if rotated else 6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the head outputs agree to about 2e-6 (convs sum in another order), so
    # boxes to 1e-5 and scores to 3e-5 of the largest
    _close(tb, jb, 1e-5)
    _close(ts, js, 3e-5)
