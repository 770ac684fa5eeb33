"""The slice as a whole: ``InstanceFieldTrainer`` of the port against the JAX
trainer's ``_step_fn``, on a small config with ``pallas_grad=True`` on both
sides (the JAX table gradient in Pallas interpret mode, the port's through
kernel B4's autograd Function and its plain scatter-add).

Both trainers start from the same params (converted with
``ngp_params_from_jax``), see the same ray batches (numpy ``ray_batch``) and
the same stratified draws (JAX's, passed to the port), and share one random
occupancy grid, so the fixed-K compaction really selects.

Tolerances. Losses to 1e-5 relative; gradients to rtol 1e-4, atol 1e-5 (the
JAX package's scatter tolerance) and also to 1e-4 of each tensor's largest
entry. Adam's first step is ``lr * g / (|g| + 1e-15)``: about +-lr for any
g well above eps, but a gradient near eps (or a cancelling sum within
rounding of 0, which may take the other sign) moves its entry by anything
up to 2 lr. Post-step params are held to 1e-6 where ``|g_jax|`` exceeds
FLOOR = 1e-12 (1000 eps: above it the step is +-lr to 0.1%) or is exactly
0; the entries between are held to 2 lr only, and there must be at most
10% of the touched entries of them. On these seeds the floor excludes 13 of
22,376 touched entries in the rgb step and 18 of the instance head's 341 in
the instance step; no gradient changes sign. Across several steps Adam's
update mu / sqrt(nu) also amplifies rounding where the moments cancel, so
the sequence test holds 99.9% of the entries to 1e-6 and all to 2 lr per
step, and a separate test holds the Adam rules exactly on shared gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.data.nerf_dataset import make_synthetic_nerf_scene
from instance_nerf_tpu.models import render as JR
from instance_nerf_tpu.train import ngp_trainer as JT
from instance_nerf_tpu_torch.convert import ngp_params_from_jax
from instance_nerf_tpu_torch.train import ngp_trainer as TT

torch.set_num_threads(2)

CFG = dict(n_levels=4, table_size=2 ** 12, max_res=64, hidden=16, num_instances=5,
           n_rays=256, n_samples=32, k_occupied=8, occ_res=16, pallas_grad=True)
FLOOR = 1e-12


@pytest.fixture(scope="module")
def jax_side():
    scene, _ = make_synthetic_nerf_scene(np.random.default_rng(0), n_views=4, hw=(24, 24),
                                         n_blobs=2)
    jt = JT.InstanceFieldTrainer(JT.NGPConfig(**CFG), seed=0)
    occ = np.where(np.random.default_rng(1).uniform(size=(16,) * 3) < 0.5, 1e3, 0.0)
    jt.occ = jt.occ._replace(grid=jnp.asarray(occ, jnp.float32))
    cfg = jt.cfg

    def loss_fn(p, key, o, d, rgb, inst, stage):
        out = JR.render_rays(jt._apply, p, key, o, d, n_samples=cfg.n_samples,
                             occ=JR.OccupancyGrid(jt.occ.grid, cfg.occ_threshold),
                             with_instance=stage != "rgb", k_occupied=cfg.k_occupied)
        total = jnp.mean((out.rgb - rgb) ** 2) if stage != "instance" else 0.0
        if stage != "rgb":  # the JAX step's instance loss (ngp_trainer.py:216-226)
            logp = jax.nn.log_softmax(out.instance_logits, axis=-1)
            ce = -jnp.take_along_axis(logp, jnp.clip(inst, 0)[:, None], axis=-1)[:, 0]
            w = jnp.where(inst > 0, cfg.instance_fg_weight, 1.0)
            w = jnp.where(inst >= 0, w, 0.0)
            total = total + jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1)
        return total

    grad_fn = jax.jit(jax.grad(loss_fn), static_argnums=6)
    return scene, jt, grad_fn, np.asarray(occ, np.float32)


def _port(jt, occ, **over):
    tt = TT.InstanceFieldTrainer(TT.NGPConfig(**{**CFG, **over}), seed=0, device="cpu")
    tt.load_jax_params(jax.tree.map(np.asarray, jt.params), occ_grid=occ)
    return tt


def _batch(scene, seed):
    v, pix, rgb, inst = scene.ray_batch(np.random.default_rng(seed), CFG["n_rays"])
    o, d = JT.rays_multi(jnp.asarray(scene.poses), v, pix, scene)
    to, td = TT.rays_multi(torch.from_numpy(scene.poses), v, pix, scene)
    np.testing.assert_array_equal(to.numpy(), np.asarray(o))
    np.testing.assert_array_equal(td.numpy(), np.asarray(d))
    return (o, d, jnp.asarray(rgb), jnp.asarray(inst)), (to, td, rgb, inst)


def _as_port(tree):
    return {k: v.numpy() for k, v in ngp_params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _step_both(jax_side, tt, params, opt_state, stage, seed):
    """One step on each side from JAX's ``params`` / ``opt_state`` and the
    port's current state. Returns the new JAX state, both losses and both
    gradient dicts (port names)."""
    scene, jt, grad_fn, _ = jax_side
    jb, tb = _batch(scene, seed)
    key = jax.random.key(seed)
    g_j = _as_port(grad_fn(params, key, *jb, stage))
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (CFG["n_rays"],
                                                                 CFG["n_samples"]))))
    params, opt_state, l_j = jt._step_fn(stage)(params, opt_state, jt.occ.grid, key, *jb)
    l_t, g_t = tt.loss_and_grads(stage, *tb, jitter=draws)
    tt.apply_grads(stage, g_t)
    return params, opt_state, l_j, l_t, g_j, g_t


def _check_losses(l_j, l_t):
    for k, v in l_j.items():
        np.testing.assert_allclose(float(l_t[k]), float(v), rtol=1e-5, err_msg=k)


def _check_grads(g_j, g_t):
    for k, gj in g_j.items():
        gt = g_t[k]
        if gt is None:  # nothing flowed in the port: JAX's gradient is zero too
            assert not gj.any(), k
            continue
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max(), err_msg=k)


def _check_params(p_j, tt, grads_j, lr):
    """Post-step params under the floor rule of the module docstring;
    returns the number of entries held only to 2 lr."""
    p_t = {k: v.detach().numpy() for k, v in tt.params.items()}
    excluded = touched = 0
    for k, pj in _as_port(p_j).items():
        held = np.ones(pj.shape, bool)
        for g in grads_j:
            ag = np.abs(g[k])
            held &= (ag > FLOOR) | (ag == 0)
            touched += int((ag > 0).sum())
        np.testing.assert_allclose(p_t[k][held], pj[held], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(p_t[k], pj, rtol=0, atol=2.01 * lr, err_msg=k)
        excluded += int((~held).sum())
    assert excluded <= 0.1 * touched, (excluded, touched)
    return excluded, touched


def test_rgb_step_matches_jax(jax_side):
    scene, jt, _, occ = jax_side
    tt = _port(jt, occ)
    p, s, l_j, l_t, g_j, g_t = _step_both(jax_side, tt, jt.params, jt.opt_state, "rgb", 3)
    _check_losses(l_j, l_t)
    _check_grads(g_j, g_t)
    assert np.abs(g_j["hash_table"]).max() > 0 and g_t["inst_0.weight"] is None
    _check_params(p, tt, [g_j], jt.cfg.lr)
    # the table moved by about lr wherever its gradient is nonzero
    moved = np.abs(tt.params["hash_table"].detach().numpy() - jt.params["params"]["hash_table"])
    assert np.isclose(moved.max(), jt.cfg.lr, rtol=1e-3)


def test_instance_step_matches_jax(jax_side):
    scene, jt, _, occ = jax_side
    tt = _port(jt, occ)
    before = {k: v.detach().clone() for k, v in tt.params.items()}
    p, s, l_j, l_t, g_j, g_t = _step_both(jax_side, tt, jt.params, jt.opt_state, "instance", 4)
    _check_losses(l_j, l_t)
    _check_grads(g_j, g_t)
    _check_params(p, tt, [g_j], jt.cfg.lr)
    for k, v in tt.params.items():  # frozen NeRF: only inst_* moved
        assert torch.equal(v, before[k]) != k.startswith("inst_"), k
    assert tt.opt_state["count"] == 1


def test_rgb_instance_rgb_sequence(jax_side):
    """Adam across stages: the instance stage decays the NeRF's moments
    without moving it, and the last rgb step moves the instance head by its
    stale momentum although its gradient is zero."""
    scene, jt, _, occ = jax_side
    tt = _port(jt, occ)
    params, opt_state = jt.params, jt.opt_state
    grads, inst_before_last = [], None
    for i, stage in enumerate(("rgb", "instance", "rgb")):
        if i == 2:
            inst_before_last = tt.params["inst_1.weight"].detach().clone()
        params, opt_state, l_j, l_t, g_j, g_t = _step_both(jax_side, tt, params, opt_state,
                                                           stage, 10 + i)
        _check_losses(l_j, l_t)
        _check_grads(g_j, g_t)
        grads.append(g_j)
    assert not grads[2]["inst_1.weight"].any()
    assert not torch.equal(tt.params["inst_1.weight"], inst_before_last)
    assert tt.opt_state["count"] == int(opt_state[0].count) == 3
    off = total = 0
    for k, pj in _as_port(params).items():
        diff = np.abs(tt.params[k].detach().numpy() - pj)
        assert diff.max() <= 3 * 2.01 * jt.cfg.lr, k
        off += int((diff > 1e-6 + 1e-6 * np.abs(pj)).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)


def test_adam_rules_on_shared_gradients(jax_side):
    """The same gradient trees (random, some entries exactly 0 and some near
    Adam's eps) through optax with the JAX step's masks and through the
    port's ``apply_grads``, for rgb -> instance -> rgb: params equal to
    1e-6 everywhere."""
    import optax

    from instance_nerf_tpu.models.fast_encode import mask_to_instance_head

    scene, jt, _, occ = jax_side
    tt = _port(jt, occ)
    params, state = jt.params, jt.tx.init(jt.params)
    rng = np.random.default_rng(20)
    for stage in ("rgb", "instance", "rgb"):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                         * 10.0 ** rng.integers(-16, -3, x.shape), params)
        g = jax.tree.map(lambda x: np.where(rng.uniform(size=x.shape) < 0.3, 0.0, x), g)
        if stage == "rgb":  # the instance head gets no gradient in the rgb stage
            g["params"]["inst_0"] = jax.tree.map(np.zeros_like, g["params"]["inst_0"])
            g["params"]["inst_1"] = jax.tree.map(np.zeros_like, g["params"]["inst_1"])
        gj = mask_to_instance_head(g) if stage == "instance" else g
        upd, state = jt.tx.update(gj, state, params)
        if stage == "instance":
            upd = mask_to_instance_head(upd)
        params = optax.apply_updates(params, upd)
        tt.apply_grads(stage, {k: torch.from_numpy(v) for k, v in _as_port(g).items()})
    for k, pj in _as_port(params).items():
        np.testing.assert_allclose(tt.params[k].detach().numpy(), pj, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_render_image_and_extract_rgbsigma_match_jax(jax_side):
    scene, jt, _, occ = jax_side
    tt = _port(jt, occ)
    want = jt.render_image(scene.poses[1], scene.intrinsics, scene.hw, chunk=256)
    got = tt.render_image(scene.poses[1], scene.intrinsics, scene.hw, chunk=200)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["instance"], want["instance"])
    assert got["acc"].max() > 0.1
    np.testing.assert_allclose(tt.extract_rgbsigma((5, 6, 7)), jt.extract_rgbsigma((5, 6, 7)),
                               rtol=1e-5, atol=1e-5)


def test_train_loop_occupancy_cadence(jax_side):
    """The occupancy grid is refreshed after every ``occ_update_every``-th
    step of a call, outside the instance stage; the loop draws its batches
    from the trainer's numpy stream."""
    scene, jt, _, occ = jax_side
    tt = _port(jt, occ, occ_update_every=2, n_rays=64)
    calls = []
    refresh = tt.update_occupancy
    tt.update_occupancy = lambda: calls.append(refresh())
    out = tt.train(scene, steps=5, stage="rgb", log_every=0)
    assert len(calls) == 2 and set(out) == {"rgb", "psnr"}
    assert not torch.equal(tt.occ.grid, torch.from_numpy(occ))
    out = tt.train(scene, steps=3, stage="instance", log_every=0)
    assert len(calls) == 2 and np.isfinite(out["instance"])
    state = np.random.default_rng(0)
    for _ in range(8):
        scene.ray_batch(state, 64)
    assert tt.np_rng.bit_generator.state == state.bit_generator.state
    with pytest.raises(RuntimeError, match="cuda"):
        tt.benchmark_train(reps=1)
