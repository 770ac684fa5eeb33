"""Data-parallel detector training over a process group on the CPU: ranks
spawned as processes of ``tests/dist_worker.py`` (gloo, a ``file://`` store,
one thread each, joined with a timeout), which import only torch, numpy and
the port; the JAX side runs here while they run.

For FCOS (AABB and rotated), the rotated anchor RPN and the NeRF-RCNN on
``tests/test_torch_train_step.py``'s inputs (its params' seeds, batch of 2
at 32^3 and keys; the RCNN samples 8 rois a scene, so its mask head runs
on 2 positives a scene), each detector's trunk a toy Swin (embed 24,
depths (2, 2, 2, 2); the trainers' own heads, losses and steps):

- for rotated FCOS, the RPN and the RCNN (one kind of each loss), one
  world-2 f32 step equals the JAX step sharded over
  ``make_mesh(n_data=2)`` to ``tests/test_torch_train_step.py``'s
  tolerances (losses 1e-5, gradients 1e-4 of their largest entry, the mask
  branch 5e-4: its ReLUs flip at f32 rounding, as that file says);
- for every kind, a world-2 step equals the port's one-process step (a
  process of its own, one thread) on the same global batch, in f64
  (the ranks' partial sums add in another order than one process's, which
  moves f32 gradients by 1.5e-5 of their largest entry): losses 1e-6,
  gradients 1e-5 of their largest entry;
- a batch of 3 on world 2 follows ``data_axis_size``: one data rank, rank 1
  idle (row 0 weighted 0), the same numbers as one process on one thread,
  as the ranks run: losses 1e-6, gradients 1e-5 of their largest entry.

A parameter whose largest gradient is below 1e-9 of the step's largest (a
bias ahead of a GroupNorm) is held to that floor.

And ``run_fcos --mode train`` (VGG-AF, f32, one step) on 2 ranks against
one process: the checkpoint's params to 1e-5 of their largest entry where
the gradient is above 1e-3 of its tensor's largest and 100 times Adam's
eps, and to 2 lr everywhere
(Adam's first step moves an entry by lr g / (|g| + eps), about lr times the
sign of its gradient, and a gradient within the ranks' rounding of zero has
either sign, as ``tests/test_torch_fleet.py`` says); its Adam moments to 1e-4 of their
largest entry (floored at 1e-6 of the checkpoint's largest: the biases ahead
of a GroupNorm), because the ranks' f32 partial sums move the VGG trunk's
gradients by up to 1.5e-5 of their largest entry; then the run resumes in
one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.parallel import train_step as JS
from instance_nerf_tpu.parallel.mesh import make_mesh
from instance_nerf_tpu.train import rcnn_trainer as JRC
from instance_nerf_tpu.train.fcos_trainer import FCOSConfig as JFConfig
from instance_nerf_tpu.train.fcos_trainer import FCOSTrainer as JFTrainer
from instance_nerf_tpu.train.rpn_trainer import RPNConfig as JRConfig
from instance_nerf_tpu.train.rpn_trainer import RPNTrainer as JRTrainer
from instance_nerf_tpu_torch.convert import (
    fcos_params_from_jax,
    rcnn_params_from_jax,
    rpn_params_from_jax,
)
from tests import dist_worker as W
from tests.test_torch_fcos import _random_params as fcos_params
from tests.test_torch_rpn import _random_params as random_params
from tests.test_torch_sampling import scene_uniforms
from tests.test_torch_train_step import MASK_BRANCH, SIZES, _grids, _gt, capture

torch.set_num_threads(2)

SHAPE = (32, 32, 32)
KINDS = ["fcos_aabb", "fcos_obb", "rpn_obb", "rcnn"]
# against JAX: one kind of each loss (FCOS AABB differs from OBB in its box
# loss only); FCOS AABB is held to the one-process step, which
# ``tests/test_torch_train_step.py`` holds to the JAX step
JAX_KINDS = ["fcos_obb", "rpn_obb", "rcnn"]
# the trunk of every detector here: a toy Swin (``tests/test_torch_train_step.py``'s
# new-backbone case), so that a step's gradients are 60 MB and not the VGG-EF's 300
SWIN = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))


def _batch3(kind, seed):
    """A global batch of 3 scenes at 32^3 for ``kind`` (port against port):
    grids padded past 24 in H, sizes, gt (and for the RCNN rois, labels and
    voxel masks)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 1, (3, *SHAPE, 4)).astype(np.float32)
    g[..., 24:, :] = 0
    sizes = np.tile(np.array([[32.0, 32.0, 24.0]], np.float32), (3, 1))
    lo = rng.uniform(1, 14, (3, 4, 3))
    gt = np.concatenate([lo, np.minimum(lo + rng.uniform(4, 18, (3, 4, 3)), 24.0)], -1)
    mask = np.ones((3, 4), bool)
    mask[-1, -1] = False
    if kind.endswith("obb"):
        gt = np.concatenate([(gt[..., :3] + gt[..., 3:]) / 2, gt[..., 3:] - gt[..., :3],
                             rng.uniform(-1.2, 1.2, (3, 4, 1))], -1)
    gt = gt.astype(np.float32)
    if kind != "rcnn":
        return (g, sizes, gt, mask)
    return _rcnn_batch(rng, g, sizes, gt, mask)


def _rcnn_batch(rng, grids, sizes, gt, gmask):
    """``tests/test_torch_train_step.py``'s RCNN batch around ``gt``: 16
    jittered rois and 4 labels a scene, voxel masks in the gt boxes."""
    n = gt.shape[0]
    idx = rng.integers(0, 4, (n, 16))
    rois = np.take_along_axis(gt, idx[..., None], 1) + rng.normal(0, 1.5, (n, 16, 6))
    rois[..., 3:] = np.maximum(rois[..., 3:], rois[..., :3] + 1)
    roi_valid = rng.uniform(size=(n, 16)) < 0.9
    labels = rng.integers(1, 11, (n, 4)).astype(np.int32)
    vmasks = np.zeros((n, 4, *SHAPE), np.uint8)
    for i in range(n):
        for j in range(4):
            lo, hi = gt[i, j, :3].astype(int), np.ceil(gt[i, j, 3:]).astype(int)
            vmasks[i, j, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.uniform(
                size=tuple(hi - lo)) < 0.7
    return (grids, sizes, rois.astype(np.float32), roi_valid, gt, labels, gmask, vmasks)


def _jax_trainer(cls, cfg):
    """A JAX trainer whose backbone is the toy Swin (``SWIN``)."""
    from instance_nerf_tpu.models.swin import SwinTransformerFPN
    from instance_nerf_tpu.train import fcos_trainer, rcnn_trainer, rpn_trainer

    with pytest.MonkeyPatch.context() as mp:
        for module in (fcos_trainer, rpn_trainer, rcnn_trainer):
            mp.setattr(module, "build_backbone", lambda *a, **k: SwinTransformerFPN(**SWIN))
        return cls(cfg)


def _inputs(kind, tmp):
    """The inputs of ``tests/test_torch_train_step.py``'s step of ``kind``
    (its params' seeds, batch of 2 and key), on the toy Swin: (the JAX
    step's pieces, the port's kind and config, its params' file, the batch,
    the sampler's uniforms)."""
    key = jax.random.key(9 if kind == "rcnn" else 7)
    u = None
    if kind.startswith("fcos"):
        rotated = kind == "fcos_obb"
        cfg = dict(dtype="float32", rotated_bbox=rotated, num_convs=2, resolution=32)
        jt = _jax_trainer(JFTrainer, JFConfig(**cfg))
        shapes = jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, *SHAPE, 4)))
        params, convert = fcos_params(shapes, 21, cls_scale=3.0), fcos_params_from_jax
        batch = (_grids(1), SIZES, *_gt(2, 7 if rotated else 6))
    elif kind == "rpn_obb":
        cfg = dict(dtype="float32", rotated_bbox=True, resolution=32, batch_size_per_mesh=64)
        jt = _jax_trainer(JRTrainer, JRConfig(**cfg))
        shapes = jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, *SHAPE, 4)))
        params, convert = random_params(shapes, 22, cls_scale=30.0), rpn_params_from_jax
        batch = (_grids(3), SIZES, *_gt(4, 7))
        n_anchors = 13 * sum(s ** 3 for s in (8, 4, 2, 1))
        u = scene_uniforms(key, 2, n_anchors)
    else:
        cfg = dict(dtype="float32", resolution=32, num_classes=11, batch_size_per_image=8)
        jt = _jax_trainer(JRC.RCNNTrainer, JRC.RCNNConfig(**cfg))
        shapes = jax.eval_shape(lambda k, g, r: jt.model.init(k, g, r, with_masks=True),
                                jax.random.key(0), jnp.zeros((1, *SHAPE, 4)),
                                jnp.asarray([[[2.0, 2, 2, 20, 20, 20]]]))
        params, convert = random_params(shapes, 23), rcnn_params_from_jax
        gt, gmask = _gt(6, 6)
        batch = _rcnn_batch(np.random.default_rng(5), _grids(7), SIZES, gt, gmask)
        u = scene_uniforms(jax.random.split(key)[0], 2, 16 + 4)
    path = str(tmp / f"{kind}_params.pt")
    torch.save(convert(jax.tree_util.tree_map(np.asarray, params)), path)
    return (jt, params, key, convert), kind.split("_")[0], cfg, path, batch, u


def _jax_step(kind, jax_parts, batch, tmp):
    """The JAX step of ``kind`` sharded over ``make_mesh(n_data=2)``, its
    gradient kept by the optax transformation ``capture``: (metrics, the
    gradients' file in the port's names)."""
    jt, params, key, convert = jax_parts
    mesh = make_mesh(n_data=2)
    args = tuple(map(jnp.asarray, batch))
    if kind.startswith("fcos"):
        step = JS.make_fcos_train_step(jt.model, capture(), mesh=mesh,
                                       use_obb=kind == "fcos_obb")
        st, jm = step(JS.TrainState(params, capture().init(params), jnp.zeros((), jnp.int32)),
                      *args)
        jgrads = st.opt_state
    elif kind == "rpn_obb":
        step = JS.make_rpn_train_step(jt.model, capture(), jt.cfg, mesh=mesh)
        (_, jgrads, _), jm = step((params, capture().init(params), 0), key, *args)
    else:
        step = JS.make_rcnn_train_step(jt.model, capture(), jt.cfg, mesh)
        _, jgrads, jm = step(params, capture().init(params), key, *args)
    path = str(tmp / f"{kind}_jax_grads.pt")
    torch.save(convert(jax.tree_util.tree_map(np.asarray, jgrads)), path)
    return {k: float(v) for k, v in jm.items()}, path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """2 ranks started on every case (per kind the f64 step of the batch of
    2 and the f32 step of a batch of 3, and for ``JAX_KINDS`` the f32 step
    of the batch of 2) and one process without a process group on the same
    f64 and batch-of-3 steps; meanwhile the JAX steps run here."""
    tmp = tmp_path_factory.mktemp("inputs")
    inputs = {kind: _inputs(kind, tmp) for kind in KINDS}
    cases, one_cases = [], []
    for kind, (_, k, cfg, params, batch, u) in inputs.items():
        u3 = None if u is None else np.random.default_rng(3).uniform(
            size=(3, *u.shape[1:])).astype(np.float32)
        base = dict(kind=k, params=params, swin=SWIN)
        one_cases += [(f"{kind}/f64", "detector_step",
                       dict(base, cfg=dict(cfg, batch_size=2), batch=batch, uniforms=u,
                            dtype="float64")),
                      (f"{kind}/b3", "detector_step",
                       dict(base, cfg=dict(cfg, batch_size=3),
                            batch=_batch3(kind, 10 + KINDS.index(kind)), uniforms=u3))]
        if kind in JAX_KINDS:
            cases.append((f"{kind}/f32", "detector_step",
                          dict(base, cfg=dict(cfg, batch_size=2), batch=batch, uniforms=u)))
        cases += one_cases[-2:]
    ranks = W.start(tmp_path_factory.mktemp("ranks"), 2, cases)
    one = W.start_one(tmp_path_factory.mktemp("one"), one_cases)
    jax_side = {kind: _jax_step(kind, inputs[kind][0], inputs[kind][4], tmp)
                for kind in JAX_KINDS}
    return jax_side, one.wait(timeout=240)[0], ranks.wait(timeout=240)


def _check(got, want, tol, loose=(), skip=lambda n: False, floor=0.0):
    top = max(float(w.abs().max()) for w in want.values())
    n = 0
    for name, w in want.items():
        if skip(name):
            continue
        g = got[name].double()
        w = w.double()
        scale = max(float(w.abs().max()), floor * top)
        t = 5e-4 if name.split(".")[0] in loose else tol
        assert float((g - w).abs().max()) <= t * scale, (name, float((g - w).abs().max()), scale)
        n += 1
    assert n > 10


def _losses(got, want, rtol, keys=None):
    for k in keys or want:
        assert abs(got[k] - want[k]) <= rtol * max(abs(want[k]), 1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_world2_step_matches_jax_sharded_step(kind, runs):
    jax_side, _, ranks = runs
    jm, jg = jax_side[kind]
    (m0, g0), (m1, g1) = ranks[0][f"{kind}/f32"], ranks[1][f"{kind}/f32"]
    assert m0 == m1 and all(W.digest(g0[k]) == g1[k] for k in g0)  # replicas agree
    if "num_pos" in jm:
        assert m0["num_pos"] == jm["num_pos"] > 0
    _losses(m0, jm, 1e-5, [k for k in jm if k.startswith("loss_") or k in ("total", "cls_acc",
                                                                           "fg_cls_acc")])
    want = {k: v for k, v in torch.load(jg, weights_only=True).items() if k in g0}
    _check(g0, want, 1e-4, loose=MASK_BRANCH, floor=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_world2_step_matches_one_process(kind, runs):
    _, one, ranks = runs
    m1, g1 = one[f"{kind}/f64"]
    m2, g2 = ranks[0][f"{kind}/f64"]
    _losses(m2, m1, 1e-6)
    _check(g2, g1, 1e-5, floor=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_batch_of_three_leaves_a_rank_idle(kind, runs):
    _, one, ranks = runs
    m1, g1 = one[f"{kind}/b3"]
    (m2, g2), (m3, g3) = ranks[0][f"{kind}/b3"], ranks[1][f"{kind}/b3"]
    assert m2 == m3
    _losses(m2, m1, 1e-6)
    _check(g2, g1, 1e-5, floor=1e-9)
    assert all(W.digest(g2[k]) == g3[k] for k in g2)


def test_run_fcos_train_on_two_ranks(tmp_path):
    """``run_fcos --mode train`` on 2 ranks (rank 0 evaluates and saves)
    against one process, then ``--resume`` in one process."""
    from instance_nerf_tpu_torch.cli import run_fcos
    from instance_nerf_tpu_torch.data.synthetic import write_dataset
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    data = tmp_path / "data"
    write_dataset(str(data), num_scenes=4, grid_size=(32, 32, 24))

    def argv(out, epochs=1, *extra):
        return ["--mode", "train", "--device", "cpu", "--features_path", f"{data}/features",
                "--boxes_path", f"{data}/metadata", "--dataset_split",
                f"{data}/dataset_split.json", "--save_path", str(out), "--resolution", "32",
                "--batch_size", "2", "--num_epochs", str(epochs), "--backbone_type", "vgg_AF",
                "--dtype", "float32", "--num_convs", "2", *extra]

    (tmp_path / "spawn").mkdir()
    ranks = W.start(tmp_path / "spawn", 2,
                    [("cli", "run_cli", dict(cli="run_fcos", argv=argv(tmp_path / "two")))])
    run_fcos.main(argv(tmp_path / "one"))
    ranks.wait(timeout=240)
    two, _ = CheckpointManager(str(tmp_path / "two")).restore_any()
    one, meta = CheckpointManager(str(tmp_path / "one")).restore_any()
    assert meta["step"] == two["step"] == one["step"] == 1
    lr = 3e-4
    o1, o2 = one["opt_state"], two["opt_state"]
    assert o1["count"] == o2["count"] == one["step"]
    top = {m: max(float(v.abs().max()) for v in o1[m]) for m in ("mu", "nu")}
    for i, name in enumerate(o1["names"]):
        for mom in ("mu", "nu"):
            w, g = o1[mom][i].double(), o2[mom][i].double()
            scale = max(float(w.abs().max()), 1e-6 * top[mom])
            assert float((g - w).abs().max()) <= 1e-4 * scale, (mom, name)
        p1, p2 = one["params"][name].double(), two["params"][name].double()
        grad = o1["mu"][i].double().abs() / 0.1  # mu = (1 - b1) g after the one step
        d = (p1 - p2).abs()
        assert float(d.max()) <= 2 * lr * 1.001, name
        # 60x the f32 sums' spread, and far above Adam's eps (1e-8), where
        # lr g / (|g| + eps) is no longer lr sign(g)
        sure = (grad > 1e-3 * float(grad.max())) & (grad > 1e-6)
        assert not sure.any() or float(d[sure].max()) <= 1e-5 * float(p1.abs().max()), name
    run_fcos.main(argv(tmp_path / "two", 2, "--resume"))
    assert CheckpointManager(str(tmp_path / "two")).latest_step() == 2 * one["step"]
