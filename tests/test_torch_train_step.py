"""Parity of one train step of the port's trainers with the JAX package's on
the CPU, on converted params at 32^3, batch 2: FCOS (AABB and rotated), the
anchor RPN (AABB and rotated) and the NeRF-RCNN (trainable and frozen
backbone). And of the optimizer: the port's clip + AdamW + one-cycle
schedule given the JAX gradients.

The JAX side is the package's own step (``make_fcos_train_step``,
``make_rpn_train_step``, ``make_rcnn_step_fn``) with an optax transformation
whose state is the gradient, so the step's loss and backward are read
without an update; the port's side is the trainer's ``train_step_fn``, whose
gradients stay in each parameter's ``.grad``. The JAX key's uniforms go to
the port's sampler. The loss dicts agree to 1e-5 relative and every
gradient to 1e-4 of its tensor's largest entry (layouts mapped by
``convert.py``, which only permutes).

The steps run in f32, and their check of the gradients stops above the
VGG trunk (the stem and ``conv_*`` of the backbone; its FPN is checked):
the trunk's 17 GroupNorms take their statistics as E[x^2] - E[x]^2, whose
sums round differently in XLA and in torch, so ReLU inputs within rounding
of 0 fall on either side, and the trunk's gradients differ by up to 2e-2 of
their largest entry. ``test_backbone_gradients_match_jax_in_f64`` holds the
trunk's backward in f64 instead (one VGG-EF, the same module in the three
trainers), where it agrees to 1e-6. JAX cannot run the steps in f64 here:
its x64 mode draws the sampler's uniforms in f64, which changes the sample.

Adam turns an ulp-level gradient difference near zero into a whole ``lr``
step, so params after a step are not compared; the optimizer is held to
optax on the same gradients instead: params to 1e-6, and the lr at every
step of a schedule.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from instance_nerf_tpu.parallel import train_step as JS
from instance_nerf_tpu.train import rcnn_trainer as JRC
from instance_nerf_tpu.train import train_utils as JU
from instance_nerf_tpu.train.fcos_trainer import FCOSConfig as JFConfig
from instance_nerf_tpu.train.fcos_trainer import FCOSTrainer as JFTrainer
from instance_nerf_tpu.train.rpn_trainer import RPNConfig as JRConfig
from instance_nerf_tpu.train.rpn_trainer import RPNTrainer as JRTrainer
from instance_nerf_tpu_torch.convert import (
    fcos_params_from_jax,
    rcnn_params_from_jax,
    rpn_params_from_jax,
)
from instance_nerf_tpu_torch.parallel import train_step as TS
from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer
from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer
from instance_nerf_tpu_torch.train.train_utils import partition_optimizer
from tests.test_torch_fcos import _random_params as fcos_params
from tests.test_torch_rpn import _random_params as random_params
from tests.test_torch_sampling import scene_uniforms

torch.set_num_threads(2)

SHAPE = (32, 32, 32)
SIZES = np.array([[32.0, 32.0, 24.0], [28.0, 32.0, 32.0]], np.float32)


def capture():
    """optax transformation whose state is the last gradient (and whose
    update is zero)."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def save_npz(tree, path):
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}
    np.savez(path, **flat)
    return str(path)


def _grids(seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 1, (2, *SHAPE, 4)).astype(np.float32)
    g[0, :, :, 24:] = 0  # the padding of scene 0
    g[1, 28:] = 0
    return g


def _gt(seed, box_dim, k=4):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(1, 14, (2, k, 3))
    boxes = np.concatenate([lo, np.minimum(lo + rng.uniform(4, 18, (2, k, 3)), SIZES[:, None])],
                           -1)
    if box_dim == 7:  # (center, size, angle)
        boxes = np.concatenate([(boxes[..., :3] + boxes[..., 3:]) / 2,
                                boxes[..., 3:] - boxes[..., :3],
                                rng.uniform(-1.2, 1.2, (2, k, 1))], -1)
    mask = np.ones((2, k), bool)
    mask[1, -1] = False
    return boxes.astype(np.float32), mask


def _compare(metrics, jmetrics, keys):
    for k in keys:
        want, got = float(jmetrics[k]), float(metrics[k])
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (k, got, want)


def in_trunk(name):
    """A parameter of the VGG trunk (the backbone but its FPN)."""
    return name.startswith("backbone.") and not name.startswith("backbone.fpn.")


def _compare_grads(model, jgrads, convert, loose=()):
    """Every parameter's ``.grad`` above the trunk (with a gradient) against
    the converted JAX gradient: to 1e-4 of its largest entry, to 5e-4 under
    the prefixes ``loose``."""
    want = convert(jax.tree_util.tree_map(np.asarray, jgrads))
    n = 0
    for name, p in model.named_parameters():
        if in_trunk(name) or p.grad is None:
            continue
        w = want[name].double().numpy()
        g = p.grad.double().numpy()
        tol = 5e-4 if name.split(".")[0] in loose else 1e-4
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= tol * scale, (name, float(np.abs(g - w).max()),
                                                           scale)
        n += 1
    assert n > 10


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_fcos_train_step_matches_jax(rotated, tmp_path):
    box_dim = 7 if rotated else 6
    kw = dict(dtype="float32", rotated_bbox=rotated, num_convs=2, resolution=32)
    jt = JFTrainer(JFConfig(**kw))
    shapes = jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, *SHAPE, 4)))
    params = fcos_params(shapes, 21, cls_scale=3.0)
    step = JS.make_fcos_train_step(jt.model, capture(), use_obb=rotated)
    gt, mask = _gt(2, box_dim)
    args = (_grids(1), SIZES, gt, mask)
    state = JS.TrainState(params, capture().init(params), jnp.zeros((), jnp.int32))
    jstate, jm = step(state, *map(jnp.asarray, args))

    tt = FCOSTrainer(FCOSConfig(checkpoint=save_npz(params, tmp_path / "p.npz"), **kw),
                     device="cpu")
    tt.init_state()
    _, tm = tt.train_step_fn()(tt.state, *map(torch.from_numpy, args))
    assert float(tm["num_pos"]) == float(jm["num_pos"]) > 0
    _compare(tm, jm, ("loss_cls", "loss_reg", "loss_centerness", "total"))
    _compare_grads(tt.model, jstate.opt_state, fcos_params_from_jax)


def _toy_backbones(name):
    """(JAX, port) toy backbones of ``name``: Swin with embed 24 and depths
    (2, 2, 2, 2) (shifted windows at 32^3), ResNet-FPN with one bottleneck
    a stage from 8 planes and the max-pooled stem."""
    from instance_nerf_tpu.models.backbones import ResNet_FPN_256 as JRes
    from instance_nerf_tpu.models.swin import SwinTransformerFPN as JSwin
    from instance_nerf_tpu_torch.models.backbones import ResNet_FPN_256 as TRes
    from instance_nerf_tpu_torch.models.swin import SwinTransformerFPN as TSwin

    if name == "swin":
        kw = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
        return JSwin(**kw), TSwin(**kw)
    kw = dict(layers=(1, 1, 1, 1), in_planes=8, is_max_pool=True)
    return JRes(**kw), TRes(**kw)


@pytest.mark.parametrize("name", ["swin", "resnet"])
def test_fcos_train_step_with_new_backbones_matches_jax(name):
    """One FCOS (AABB) step with a toy Swin and a toy ResNet backbone: the
    losses to 1e-5 and the gradients to 1e-4 of their largest entry. The
    Swin step runs in f32, its own trunk included (no ReLU in it). The
    ResNet features differ by 1e-5 of their largest entry in f32 (its trunk's
    ReLUs flip at rounding, ``tests/test_torch_resnet.py``), which flips the
    head's ReLUs in turn (4e-3 on a tower's gradient), so that step runs in
    f64 in both packages (JAX's x64 mode; the FCOS step draws nothing, so
    x64 changes no sample), the trunk included."""
    from instance_nerf_tpu.models.fcos import FCOSOverNeRF as JFCOS
    from instance_nerf_tpu_torch.models.fcos import FCOSOverNeRF as TFCOS

    f64 = name == "resnet"
    jb, tb = _toy_backbones(name)
    jm = JFCOS(backbone=jb, num_convs=2)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, *SHAPE, 4)))
    params = fcos_params(shapes, 27, cls_scale=3.0)
    gt, mask = _gt(8, 6)
    args = (_grids(9), SIZES, gt, mask)
    with jax.enable_x64(f64):
        dt = jnp.float64 if f64 else jnp.float32
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
        state = JS.TrainState(p, capture().init(p), jnp.zeros((), jnp.int32))
        jstate, jmet = JS.make_fcos_train_step(jm, capture())(
            state, *(jnp.asarray(a, dt) if a.dtype == np.float32 else jnp.asarray(a)
                     for a in args))
        jgrads = jax.tree_util.tree_map(np.asarray, jstate.opt_state)

    tm = TFCOS(tb, num_convs=2)
    tm.load_state_dict(fcos_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    targs = [torch.from_numpy(a) for a in args]
    if f64:
        tm = tm.double()
        targs = [a.double() if a.is_floating_point() else a for a in targs]
    tstate = TS.TrainState(tm, TS.make_optimizer(tm.named_parameters(), lr=0.0))
    _, tmet = TS.make_fcos_train_step(tm)(tstate, *targs)
    assert float(tmet["num_pos"]) == float(jmet["num_pos"]) > 0
    _compare(tmet, jmet, ("loss_cls", "loss_reg", "loss_centerness", "total"))
    _compare_grads(tm, jgrads, fcos_params_from_jax)
    # the trunk too: patch embed, attention, merging and MLPs; stem and
    # bottlenecks
    want = fcos_params_from_jax(jgrads)
    trunk = [(n, p) for n, p in tm.named_parameters() if in_trunk(n)]
    assert any(("rel_pos_bias_table" if name == "swin" else "downsample") in n for n, _ in trunk)
    top = max(float(w.abs().max()) for w in want.values())
    for n, p in trunk:
        w = want[n].double()
        scale = max(float(w.abs().max()), 1e-9 * top)  # biases ahead of a GroupNorm: 0
        assert float((p.grad.double() - w).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_rpn_train_step_matches_jax(rotated, tmp_path):
    box_dim = 7 if rotated else 6
    kw = dict(dtype="float32", rotated_bbox=rotated, resolution=32, batch_size_per_mesh=64)
    jt = JRTrainer(JRConfig(**kw))
    shapes = jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, *SHAPE, 4)))
    params = random_params(shapes, 22, cls_scale=30.0)
    step = JS.make_rpn_train_step(jt.model, capture(), jt.cfg)
    gt, mask = _gt(4, box_dim)
    args = (_grids(3), SIZES, gt, mask)
    key = jax.random.key(7)
    (_, jgrads, _), jm = step((params, capture().init(params), 0), key, *map(jnp.asarray, args))

    tt = RPNTrainer(RPNConfig(checkpoint=save_npz(params, tmp_path / "p.npz"), **kw),
                    device="cpu")
    tt.init_state()
    n_anchors = sum(a.shape[0] for a in tt.model.anchors(tt.model.features(
        torch.zeros((1, *SHAPE, 4)))))
    u = torch.from_numpy(scene_uniforms(key, 2, n_anchors))
    _, tm = tt.train_step_fn()(tt.state, *map(torch.from_numpy, args), uniforms=u)
    _compare(tm, jm, ("loss_objectness", "loss_rpn_box_reg", "loss_rpn_box_reg_2d", "total"))
    _compare_grads(tt.model, jgrads, rpn_params_from_jax)


@pytest.fixture(scope="module")
def rcnn_case():
    """An RCNN batch at 32^3: 16 rois and 4 gt a scene, voxel masks."""
    rng = np.random.default_rng(5)
    gt, gmask = _gt(6, 6)
    idx = rng.integers(0, 4, (2, 16))
    rois = np.take_along_axis(gt, idx[..., None], 1) + rng.normal(0, 1.5, (2, 16, 6))
    rois[..., 3:] = np.maximum(rois[..., 3:], rois[..., :3] + 1)
    rois = rois.astype(np.float32)
    roi_valid = rng.uniform(size=(2, 16)) < 0.9
    labels = rng.integers(1, 11, (2, 4)).astype(np.int32)
    vmasks = np.zeros((2, 4, *SHAPE), np.uint8)
    for i in range(2):
        for j in range(4):
            lo, hi = gt[i, j, :3].astype(int), np.ceil(gt[i, j, 3:]).astype(int)
            vmasks[i, j, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.uniform(
                size=tuple(hi - lo)) < 0.7
    return (_grids(7), SIZES, rois, roi_valid, gt, labels, gmask, vmasks)


@pytest.fixture(scope="module")
def rcnn_jax(rcnn_case, tmp_path_factory):
    """The JAX RCNN step's metrics and gradients (trainable backbone), the
    params as an ``.npz``, the JAX key's sampling draws and the config."""
    kw = dict(dtype="float32", resolution=32, num_classes=11, batch_size_per_image=64)
    jt = JRC.RCNNTrainer(JRC.RCNNConfig(**kw))
    shapes = jax.eval_shape(lambda k, g, r: jt.model.init(k, g, r, with_masks=True),
                            jax.random.key(0), jnp.zeros((1, *SHAPE, 4)),
                            jnp.asarray([[[2.0, 2, 2, 20, 20, 20]]]))
    params = random_params(shapes, 23)
    key = jax.random.key(9)
    step = jax.jit(JRC.make_rcnn_step_fn(jt.model, capture(), jt.cfg, jt.mask_slots))
    _, jgrads, jm = step(params, capture().init(params), key, *map(jnp.asarray, rcnn_case))
    k_sample, _ = jax.random.split(key)
    p_all = rcnn_case[2].shape[1] + rcnn_case[4].shape[1]
    u = torch.from_numpy(scene_uniforms(k_sample, 2, p_all))
    npz = save_npz(params, tmp_path_factory.mktemp("rcnn") / "p.npz")
    assert jt.mask_slots == 16
    return jm, jgrads, npz, u, kw


# the mask branch's five ReLUs flip at f32 rounding as the trunk's do (see
# the module docstring): its gradients read up to 1.9e-4 of their largest
# entry apart, and are held to 5e-4
MASK_BRANCH = ("mask_head", "mask_predictor")


@pytest.mark.parametrize("freeze", [False, True], ids=["trainable", "frozen"])
def test_rcnn_train_step_matches_jax(freeze, rcnn_case, rcnn_jax):
    """Against the JAX step with a trainable backbone: freezing it (features
    outside autograd in both packages) changes no gradient above it."""
    jm, jgrads, npz, u, kw = rcnn_jax
    tt = RCNNTrainer(RCNNConfig(rcnn_ckpt=npz, freeze_backbone=freeze, **kw), device="cpu")
    tt.init_state()
    _, tm = tt.train_step_fn()(tt.state, *map(torch.from_numpy, rcnn_case), uniforms=u)
    assert float(tm["num_pos"]) == float(jm["num_pos"]) > 0
    _compare(tm, jm, ("loss_classifier", "loss_box_reg", "loss_mask", "total", "cls_acc",
                      "fg_cls_acc"))
    _compare_grads(tt.model, jgrads, rcnn_params_from_jax, loose=MASK_BRANCH)
    if freeze:
        assert all(p.grad is None for p in tt.model.backbone.parameters())
        assert all(not n.startswith("backbone.") for n in tt.state.tx.names)


def test_backbone_gradients_match_jax_in_f64():
    """The VGG-EF trunk and FPN's backward in f64 (JAX in its x64 mode): the
    gradient of every backbone parameter under a random cotangent on the 4
    levels, at 16^3 batch 1, to 1e-6 of its largest entry."""
    from instance_nerf_tpu.models.backbones import build_backbone as j_build
    from instance_nerf_tpu_torch.models.backbones import build_backbone as t_build

    jm = j_build("vgg_EF", input_size=160)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 16, 16, 16, 4)))
    params = random_params(shapes, 24)
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (1, 16, 16, 16, 4))
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        cot = [rng.normal(size=f.shape) for f in jm.apply(p64, jnp.asarray(x))]

        def loss(p):
            return sum(jnp.sum(f * c) for f, c in zip(jm.apply(p, jnp.asarray(x)), cot))

        want = rcnn_params_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.jit(jax.grad(loss))(p64)))
    tm = t_build("vgg_EF", input_size=160).double()
    tm.load_state_dict(rcnn_params_from_jax(params))
    sum((f * torch.from_numpy(c)).sum() for f, c in zip(tm(torch.from_numpy(x)), cot)).backward()
    for name, p in tm.named_parameters():
        w = want[name].double()
        assert float((p.grad - w).abs().max()) <= 1e-6 * float(w.abs().max()), name


# -- optimizer ----------------------------------------------------------------

def _tree(rng):
    return {"backbone": {"w": rng.normal(0, 1, (4, 5)).astype(np.float32)},
            "head": {"w": rng.normal(0, 1, (6, 3)).astype(np.float32),
                     "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}}


def _named(tree):
    return [(f"{m}.{k}", torch.nn.Parameter(torch.from_numpy(v.copy())))
            for m, sub in tree.items() for k, v in sub.items()]


@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_matches_optax(frozen):
    """20 steps of clip + AdamW + one-cycle from the same gradients, some
    above the clip norm and some below; with ``frozen`` the backbone is
    partitioned off as ``partition_optimizer`` does in both packages."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tx = JS.make_optimizer(lr=3e-3, weight_decay=1e-2, clip_grad_norm=0.5, total_steps=20)
    if frozen:
        tx = JU.partition_optimizer(tx, params, frozen_prefixes=("backbone",))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    named = _named(params)
    model = torch.nn.Module()
    for m in params:
        sub = torch.nn.Module()
        model.add_module(m, sub)
        for k, v in params[m].items():
            sub.register_parameter(k, dict(named)[f"{m}.{k}"])
    trained, frozen_params = partition_optimizer(model, ("backbone",) if frozen else ())
    opt = TS.make_optimizer(trained, lr=3e-3, weight_decay=1e-2, clip_grad_norm=0.5,
                            total_steps=20)
    for step in range(20):
        scale = 0.05 if step % 3 else 2.0  # below and above the clip
        grads = jax.tree_util.tree_map(
            lambda v: (rng.normal(0, scale, v.shape)).astype(np.float32), params)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(grads[n.split(".")[0]][n.split(".")[1]]) for n, _ in trained])
        for name, p in named:
            m, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {step} {name}")
    if frozen:
        assert [n for n, _ in frozen_params] == ["backbone.w"]
        assert np.array_equal(dict(named)["backbone.w"].detach().numpy(), params["backbone"]["w"])


@pytest.mark.parametrize("total", [1, 3, 4, 20, 57])
def test_one_cycle_schedule_matches_optax(total):
    """The lr of every step, to 1e-6 of the peak (optax computes it in f32);
    below 4 steps both packages keep it constant."""
    opt = TS.make_optimizer([], lr=3e-4, total_steps=total)
    sched = (optax.cosine_onecycle_schedule(transition_steps=total, peak_value=3e-4)
             if total >= 4 else (lambda c: 3e-4))
    for count in range(total + 3):
        want = float(sched(count))
        assert abs(opt.lr(count) - want) <= 1e-6 * 3e-4, (count, opt.lr(count), want)


def test_optimizer_state_round_trips():
    rng = np.random.default_rng(2)
    named = _named(_tree(rng))
    opt = TS.make_optimizer(named, total_steps=10)
    opt.step([torch.ones_like(p) for _, p in named])
    again = TS.make_optimizer(named, total_steps=10)
    again.load_state_dict(opt.state_dict())
    assert again.count == 1
    assert all(torch.equal(a, b) for a, b in zip(again.mu, opt.mu))
    with pytest.raises(ValueError, match="other parameters"):
        TS.make_optimizer(named[:1]).load_state_dict(opt.state_dict())


def test_remat_step_equals_the_plain_step():
    """``remat`` recomputes the forward in the backward through
    ``torch.utils.checkpoint`` (the RCNN's the backbone's alike): the same
    losses and gradients as without it."""
    gt, mask = _gt(2, 6)
    args = (_grids(1), SIZES, gt, mask)
    runs = []
    for remat in (False, True):
        tt = FCOSTrainer(FCOSConfig(dtype="float32", num_convs=1, backbone_type="vgg_AF",
                                    remat=remat, seed=3), device="cpu")
        tt.init_state()
        _, metrics = tt.train_step_fn()(tt.state, *map(torch.from_numpy, args))
        runs.append((metrics, {n: p.grad.clone() for n, p in tt.model.named_parameters()}))
    (m0, g0), (m1, g1) = runs
    assert all(float(m0[k]) == pytest.approx(float(m1[k]), rel=1e-6) for k in m0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6 * float(g0[n].abs().max()))
