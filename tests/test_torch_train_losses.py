"""Parity of the port's training losses with the JAX package on the CPU, in
f32: FCOS target assignment (AABB and OBB), the centerness, focal, IoU-family
and projection losses, ``fcos_loss`` with every box loss, the box helpers
and enclosing boxes of the rotated GIoU / DIoU, the anchor RPN's target
assignment and ``rpn_loss`` in both box modes, and the RCNN's
``fastrcnn_loss`` and ``maskrcnn_loss``.

The JAX side runs under ``jax.jit`` but for the GIoU / DIoU losses of
OBBs: the JAX package's ``smallest_bounding_box`` reads its pair indices
with ``int()`` while it traces, so it runs eagerly only. Those tests share
one leading shape, ``EAGER_ROWS`` (the anchors of one 16^3 scene), so the
eager primitives compile once.

Labels, matches and sampled masks must be identical; losses agree to 1e-5
relative and their gradients to 1e-4 of each tensor's largest entry (the
rotated IoU's f64 angle and the sums' order differ by f32 rounding). The
sampler's uniforms are the JAX key's (``tests/test_torch_sampling.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import fcos as JF
from instance_nerf_tpu.models import rcnn as JRC
from instance_nerf_tpu.models import rpn as JRP
from instance_nerf_tpu.ops import boxes as JB
from instance_nerf_tpu.ops import projection as JP
from instance_nerf_tpu.ops import rotated_iou as JI
from instance_nerf_tpu_torch.models import fcos as TF
from instance_nerf_tpu_torch.models import rcnn as TRC
from instance_nerf_tpu_torch.models import rpn as TRP
from instance_nerf_tpu_torch.ops import boxes as TB
from instance_nerf_tpu_torch.ops import projection as TP
from instance_nerf_tpu_torch.ops import rotated_iou as TI
from tests.test_torch_rotated_iou import random_obbs
from tests.test_torch_sampling import scene_uniforms

torch.set_num_threads(2)

STRIDES = (4, 8, 16, 32)
# the FPN levels of a 32 x 32 x 24 grid
LEVEL_SHAPES = [(8, 8, 6), (4, 4, 3), (2, 2, 2), (1, 1, 1)]
GRID = (32.0, 32.0, 24.0)
# (scenes, anchors) of a 16^3 grid: the leading shape of the eager tests
EAGER_ROWS = (1, 962)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-12))


def _grad_close(got, want, tol=1e-4):
    """Gradients to ``tol`` of the tensor's largest entry."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale, (np.abs(got - want).max(), scale)


def _infos():
    return (JF.compute_locations(LEVEL_SHAPES, STRIDES),
            TF.compute_locations(LEVEL_SHAPES, STRIDES))


def _aabb_gt(rng, n, k):
    lo = rng.uniform(0, 14, (n, k, 3))
    gt = np.concatenate([lo, lo + rng.uniform(3, 30, (n, k, 3))], -1)
    gt[..., 3:] = np.minimum(gt[..., 3:], GRID)
    mask = rng.uniform(size=(n, k)) < 0.8
    mask[:, 0] = True
    return gt.astype(np.float32), mask


def _obb_gt(rng, n, k):
    c = rng.uniform(6, 24, (n, k, 3))
    whd = rng.uniform(3, 22, (n, k, 3))
    theta = rng.uniform(-np.pi / 2, np.pi / 2, (n, k, 1))
    mask = rng.uniform(size=(n, k)) < 0.8
    mask[:, 0] = True
    return np.concatenate([c, whd, theta], -1).astype(np.float32), mask


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_fcos_targets_match_jax(obb, radius):
    jinfo, tinfo = _infos()
    rng = np.random.default_rng(3 + obb)
    gt, mask = (_obb_gt if obb else _aabb_gt)(rng, 3, 5)
    jfn, tfn = (JF.fcos_targets_obb, TF.fcos_targets_obb) if obb else (JF.fcos_targets,
                                                                      TF.fcos_targets)
    jl, jr = jax.vmap(lambda b, m: jfn(jinfo, b, m, radius))(jnp.asarray(gt), jnp.asarray(mask))
    tl, tr = tfn(tinfo, _t(gt), _t(mask), radius)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert 0 < float(tl.sum()) < tl.numel()
    _close(tr, jr)
    # unbatched as the JAX function
    tl0, tr0 = tfn(tinfo, _t(gt[1]), _t(mask[1]), radius)
    assert torch.equal(tl0, tl[1]) and torch.equal(tr0, tr[1])


def test_encode_fcos_obb_and_centerness_match_jax():
    rng = np.random.default_rng(4)
    locs = rng.uniform(0, 32, (50, 3)).astype(np.float32)
    boxes = random_obbs(rng, 50, size=32.0)
    boxes[:5, 6] = 0.0  # axis-aligned: the near-AABB vertex rule
    _close(TF.encode_fcos_obb(_t(locs), _t(boxes)),
           JF.encode_fcos_obb(jnp.asarray(locs), jnp.asarray(boxes)), 1e-5)
    reg = rng.uniform(-1, 8, (40, 6)).astype(np.float32)
    _close(TF.centerness_target(_t(reg)), JF.centerness_target(jnp.asarray(reg)), 1e-6)


def _maybe_jit(fn, jit):
    return jax.jit(fn) if jit else fn


def _value_and_grads(jfn, tfn, *arrays, jit=True):
    """The JAX loss and its gradient in every input against the port's."""
    jv, jg = _maybe_jit(jax.value_and_grad(lambda *a: jnp.sum(jfn(*a)), argnums=tuple(
        range(len(arrays)))), jit)(*map(jnp.asarray, arrays))
    ts = [_t(a).requires_grad_() for a in arrays]
    tv = tfn(*ts).sum()
    tv.backward()
    _close(tv, jv)
    for t, g in zip(ts, jg):
        _grad_close(t.grad, g)


def test_elementwise_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (200,)).astype(np.float32)
    labels = (rng.uniform(size=200) < 0.3).astype(np.float32)
    soft = rng.uniform(size=200).astype(np.float32)
    _value_and_grads(lambda x: JF.sigmoid_focal_loss(x, jnp.asarray(labels)),
                     lambda x: TF.sigmoid_focal_loss(x, _t(labels)), logits)
    _value_and_grads(lambda x: JF.optax_sigmoid_ce(x, jnp.asarray(soft)),
                     lambda x: TF.optax_sigmoid_ce(x, _t(soft)), logits)
    a, b = rng.normal(0, 1, (2, 100, 4)).astype(np.float32)
    for beta in (1.0, 1 / 9):
        _value_and_grads(lambda x, y: JF.smooth_l1(x, y, beta),
                         lambda x, y: TF.smooth_l1(x, y, beta), a, b)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_6dist_matches_jax(loss_type):
    rng = np.random.default_rng(6)
    pred, tgt = rng.uniform(0.1, 5, (2, 120, 6)).astype(np.float32)
    _value_and_grads(lambda p, t: JF.iou_loss_6dist(p, t, loss_type),
                     lambda p, t: TF.iou_loss_6dist(p, t, loss_type), pred, tgt)


def _obb_params(rng, n):
    """8-param midpoint offsets: 6 distances and 2 vertex offsets."""
    return np.concatenate([rng.uniform(0.5, 6, (n, 6)), rng.uniform(-0.45, 0.45, (n, 2))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou", "diou"])
def test_rotated_iou_loss_matches_jax(loss_type):
    rng = np.random.default_rng(7)
    n = int(np.prod(EAGER_ROWS))
    pred, tgt = (_obb_params(rng, n).reshape(*EAGER_ROWS, 8) for _ in range(2))
    _value_and_grads(lambda p, t: JF.rotated_iou_loss(p, t, loss_type),
                     lambda p, t: TF.rotated_iou_loss(p, t, loss_type), pred, tgt,
                     jit=loss_type not in ("giou", "diou"))


def test_box_helpers_match_jax():
    rng = np.random.default_rng(8)
    obbs = random_obbs(rng, 30, size=32.0)
    aabbs = np.sort(rng.uniform(0, 32, (30, 2, 3)), axis=1).reshape(30, 6).astype(np.float32)
    aabbs = aabbs[:, [0, 2, 4, 1, 3, 5]]
    for jfn, tfn, x in ((JB.obb2poly_3d, TB.obb2poly_3d, obbs),
                        (JB.obb2points_3d, TB.obb2points_3d, obbs),
                        (JB.aabb2obb_3d, TB.aabb2obb_3d, aabbs),
                        (JI.aabb2obb_3d, TI.aabb2obb_3d, aabbs),
                        (JB.box_centers, TB.box_centers, aabbs),
                        (JB.box_centers, TB.box_centers, obbs)):
        _close(tfn(_t(x)), jfn(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("kind", ["aligned", "pca", "smallest"])
def test_enclosing_boxes_match_jax(kind):
    """(w, h) as an unordered pair: the smallest rectangle is often reached
    along two perpendicular hull edges, whose areas tie to rounding, and
    which of them comes first decides the order (GIoU and DIoU use only
    w h and w^2 + h^2)."""
    rng = np.random.default_rng(9)
    a, b = random_obbs(rng, 60), random_obbs(rng, 60)
    c1 = JI.box2corners(jnp.asarray(a[:, [0, 1, 3, 4, 6]]))
    c2 = JI.box2corners(jnp.asarray(b[:, [0, 1, 3, 4, 6]]))
    jw, jh = JI.enclosing_box(c1, c2, kind)
    tw, th = TI.enclosing_box(_t(c1), _t(c2), kind)
    _close(torch.sort(torch.stack([tw, th]), dim=0).values,
           np.sort(np.stack([jw, jh]), axis=0), 1e-5)


@pytest.mark.parametrize("which", ["giou", "diou"])
def test_giou_diou_3d_match_jax(which):
    rng = np.random.default_rng(10)
    a = random_obbs(rng, int(np.prod(EAGER_ROWS))).reshape(*EAGER_ROWS, 7)
    b = a + rng.normal(0, 1.0, a.shape).astype(np.float32)  # overlapping pairs
    b[:, 3:6] = np.abs(b[:, 3:6]) + 1
    jfn = {"giou": lambda x, y: JI.cal_giou_3d(x, y)[0], "diou": lambda x, y: JI.cal_diou_3d(x, y)[0]}
    tfn = {"giou": lambda x, y: TI.cal_giou_3d(x, y)[0], "diou": lambda x, y: TI.cal_diou_3d(x, y)[0]}
    _value_and_grads(jfn[which], tfn[which], a, b, jit=False)
    ji, _, _, jz, ju = JI.cal_iou_3d(jnp.asarray(a), jnp.asarray(b), verbose=True)
    ti, _, _, tz, tu = TI.cal_iou_3d(_t(a), _t(b), verbose=True)
    _close(ti, ji)
    _close(tz, jz)
    _close(tu, ju)


def test_projection_loss_matches_jax():
    rng = np.random.default_rng(11)
    pred = rng.uniform(-10, 40, (64, 3)).astype(np.float32)
    tgt = (pred + rng.normal(0, 2, pred.shape)).astype(np.float32)
    w = np.where(rng.uniform(size=64) < 0.6, rng.uniform(0.1, 1, 64), 0).astype(np.float32)
    _value_and_grads(lambda p: JP.projection_loss_points(p, jnp.asarray(tgt), jnp.asarray(w), 32),
                     lambda p: TP.projection_loss_points(p, _t(tgt), _t(w), 32), pred)
    np.testing.assert_allclose(TP.get_w2cs(48), JP.get_w2cs(48), rtol=0, atol=0)


def _fcos_case(rng, obb, n=2):
    r = sum(int(np.prod(s)) for s in LEVEL_SHAPES)
    gt, mask = (_obb_gt if obb else _aabb_gt)(rng, n, 4)
    logits = rng.normal(-2, 2, (n, r)).astype(np.float32)
    reg = (_obb_params(rng, n * r).reshape(n, r, 8) if obb
           else rng.uniform(0.2, 4, (n, r, 6)).astype(np.float32))
    ctr = rng.normal(0, 1, (n, r)).astype(np.float32)
    sizes = np.array([GRID, (28.0, 32.0, 20.0)][:n], np.float32)
    return logits, reg, ctr, gt, mask, sizes


# the OBB GIoU / DIoU box losses are held by test_rotated_iou_loss_matches_jax
# (fcos_loss takes every OBB loss type through the same positive rows)
FCOS_CASES = [(False, "iou", {}), (False, "linear_iou", {}), (False, "giou", {}),
              (False, "smooth_l1", {}), (True, "iou", {}), (True, "linear_iou", {}),
              (True, "smooth_l1", {}),
              (True, "iou", dict(use_additional_l1_loss=True, proj2d_loss_weight=1.0))]


@pytest.mark.parametrize("obb,loss_type,extra", FCOS_CASES,
                         ids=[f"{'obb' if o else 'aabb'}-{t}{'-l1-proj2d' if e else ''}"
                              for o, t, e in FCOS_CASES])
def test_fcos_loss_matches_jax(obb, loss_type, extra):
    jinfo, tinfo = _infos()
    rng = np.random.default_rng(12)
    logits, reg, ctr, gt, mask, sizes = _fcos_case(rng, obb)
    kw = dict(iou_loss_type=loss_type, use_obb=obb, **extra)
    jpm = JF.padding_mask(jinfo, jnp.asarray(sizes))

    def jloss(lg, rg, ct):
        out = JF.fcos_loss(jinfo, lg, rg, ct, jnp.asarray(gt), jnp.asarray(mask), jpm, **kw)
        return out["loss_cls"] + out["loss_reg"] + out["loss_centerness"], out

    (jtot, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(ctr))
    ts = [_t(a).requires_grad_() for a in (logits, reg, ctr)]
    tout = TF.fcos_loss(tinfo, *ts, _t(gt), _t(mask), TF.padding_mask(tinfo, _t(sizes)), **kw)
    ttot = tout["loss_cls"] + tout["loss_reg"] + tout["loss_centerness"]
    ttot.backward()
    assert float(tout["num_pos"]) == float(jout["num_pos"]) > 0
    for k in ("loss_cls", "loss_reg", "loss_centerness"):
        _close(tout[k], jout[k])
    for t, g in zip(ts, jg):
        _grad_close(t.grad, g)


# -- anchor RPN ---------------------------------------------------------------

def _rpn_case(rng, rotated, n=2, k=4, small=False):
    """Anchors of a 32^3 padded grid (16^3 with ``small``), gt, head outputs
    and grid sizes."""
    gen = TRP.AnchorGenerator3D()
    shapes = ([(4, 4, 4), (2, 2, 2), (1, 1, 1), (1, 1, 1)] if small
              else [(8, 8, 8), (4, 4, 4), (2, 2, 2), (1, 1, 1)])
    anchors_l = gen.grid_anchors(shapes, [(s,) * 3 for s in STRIDES])
    anchors = np.concatenate(anchors_l)
    r = anchors.shape[0]
    gt, mask = (_obb_gt if rotated else _aabb_gt)(rng, n, k)
    obj = rng.normal(0, 2, (n, r)).astype(np.float32)
    deltas = rng.normal(0, 0.2, (n, r, 8 if rotated else 6)).astype(np.float32)
    sizes = np.array([GRID, (28.0, 32.0, 20.0)][:n], np.float32)
    return anchors_l, anchors, gt, mask, obj, deltas, sizes


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_rpn_target_assignment_matches_jax(rotated):
    rng = np.random.default_rng(13)
    anchors_l, anchors, gt, mask, _, _, sizes = _rpn_case(rng, rotated)
    mask[1] = False  # a scene without gt: all background
    jpm = JRP.anchor_padding_mask([jnp.asarray(a) for a in anchors_l], jnp.asarray(sizes),
                                  STRIDES)
    tpm = TRP.anchor_padding_mask([_t(a) for a in anchors_l], _t(sizes), STRIDES)
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    for i in range(2):
        want = JRP.assign_targets_to_anchors(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                             jnp.asarray(mask[i]), pad_mask=jpm[i])
        got = TRP.assign_targets_to_anchors(_t(anchors), _t(gt[i]), _t(mask[i]),
                                            pad_mask=tpm[i])
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    assert (got.labels == 0).any() and not (got.labels == 1).any()


# GIoU / DIoU on a 16^3 grid's anchors: the JAX side runs them eagerly
RPN_CASES = [(False, "smooth_l1", True), (False, "smooth_l1", False), (True, "smooth_l1", True),
             (True, "iou", False), (True, "linear_iou", False), (True, "giou", False),
             (True, "diou", False)]


@pytest.mark.parametrize("rotated,loss_type,proj2d", RPN_CASES,
                         ids=[f"{'obb' if r else 'aabb'}-{t}{'-proj2d' if p else ''}"
                              for r, t, p in RPN_CASES])
def test_rpn_loss_matches_jax(rotated, loss_type, proj2d):
    rng = np.random.default_rng(14)
    small = loss_type in ("giou", "diou")
    anchors_l, anchors, gt, mask, obj, deltas, sizes = _rpn_case(
        rng, rotated, n=EAGER_ROWS[0] if small else 2, small=small)
    if small:
        gt[..., :6] /= 2
        sizes /= 2
    key = jax.random.key(5)
    jpm = JRP.anchor_padding_mask([jnp.asarray(a) for a in anchors_l], jnp.asarray(sizes),
                                  STRIDES)
    kw = dict(batch_size_per_mesh=64, positive_fraction=0.5, rotated=rotated,
              reg_loss_type=loss_type, max_mesh_dim=16 if small else 32, proj2d=proj2d)

    def jloss(o, d):
        out = JRP.rpn_loss(key, o, d, jnp.asarray(anchors), jnp.asarray(gt),
                           jnp.asarray(mask), pad_mask=jpm, **kw)
        return sum(out.values()), out

    (_, jout), jg = _maybe_jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
                               not small)(
        jnp.asarray(obj), jnp.asarray(deltas))
    u = torch.from_numpy(scene_uniforms(key, obj.shape[0], anchors.shape[0]))
    to, td = _t(obj).requires_grad_(), _t(deltas).requires_grad_()
    tout = TRP.rpn_loss(to, td, _t(anchors), _t(gt), _t(mask),
                        pad_mask=_t(np.asarray(jpm)), uniforms=u, **kw)
    sum(tout.values()).backward()
    assert sorted(tout) == sorted(jout)
    for k in jout:
        _close(tout[k], jout[k])
    _grad_close(to.grad, jg[0])
    _grad_close(td.grad, jg[1])
    assert float(td.grad.abs().sum()) > 0


def test_rpn_iou_losses_need_rotated_boxes():
    rng = np.random.default_rng(15)
    _, anchors, gt, mask, obj, deltas, _ = _rpn_case(rng, False)
    with pytest.raises(ValueError, match="rotated"):
        TRP.rpn_loss(_t(obj), _t(deltas), _t(anchors), _t(gt), _t(mask), reg_loss_type="giou")


# -- RCNN ---------------------------------------------------------------------

def test_fastrcnn_loss_matches_jax():
    rng = np.random.default_rng(16)
    n, s, c = 2, 30, 11
    logits = rng.normal(0, 2, (n, s, c)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (n, s, c, 6)).astype(np.float32)
    labels = rng.integers(-1, c, (n, s)).astype(np.int32)
    reg_t = rng.normal(0, 0.5, (n, s, 6)).astype(np.float32)
    valid = labels >= 0

    def j(lg, dl):
        a, b = JRC.fastrcnn_loss(lg, dl, jnp.asarray(labels), jnp.asarray(reg_t),
                                 jnp.asarray(valid))
        return a + 2 * b

    def t(lg, dl):
        a, b = TRC.fastrcnn_loss(lg, dl, _t(labels).long(), _t(reg_t), _t(valid))
        return a + 2 * b

    _value_and_grads(j, t, logits, deltas)


def test_maskrcnn_loss_matches_jax():
    """Each roi's matched gt mask RoI-aligned from uint8 voxel masks."""
    rng = np.random.default_rng(17)
    k, m, c, rois = 3, 4, 11, 12
    gt_masks = (rng.uniform(size=(k, 16, 16, 12)) < 0.4).astype(np.uint8)
    lo = rng.uniform(0, 8, (rois, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 8, (rois, 3))], 1).astype(np.float32)
    logits = rng.normal(0, 1, (rois, m, m, m, c)).astype(np.float32)
    labels = rng.integers(0, c, rois).astype(np.int32)
    midx = rng.integers(0, k, rois).astype(np.int32)
    valid = rng.uniform(size=rois) < 0.7
    _close(TRC.project_gt_masks(_t(gt_masks), _t(boxes), _t(midx), m),
           JRC.project_gt_masks(jnp.asarray(gt_masks), jnp.asarray(boxes), jnp.asarray(midx),
                                m), 1e-6)
    args_j = [jnp.asarray(a) for a in (boxes, gt_masks, labels, midx, valid)]
    args_t = [_t(boxes), _t(gt_masks), _t(labels).long(), _t(midx), _t(valid)]
    _value_and_grads(lambda lg: JRC.maskrcnn_loss(lg, *args_j),
                     lambda lg: TRC.maskrcnn_loss(lg, *args_t), logits)
