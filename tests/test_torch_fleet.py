"""The fleet (multi-scene field) of the port against the JAX package at B = 3:
one step of ``make_multiscene_ngp_step`` (rgb and instance), the trainer's
host draws, the subsampled occupancy refresh, ``fleet_params_from_jax``,
and save / restore, with the background save's snapshot taken at call time.

Both sides start from the same stacked params (the JAX fleet's, converted),
see the same rays and, per scene, the same stratified draws (JAX's, from
the per-scene keys its step splits). The port runs ``pallas_grad`` (its
fleet-wide table gradient in the kernel's ``(N, B, L)`` layout, on the CPU
the plain scatter); the JAX side XLA's scatter, the same function.

Tolerances: losses 1e-5 relative; every gradient to 1e-5 of its largest
entry; post-step params to 1e-5 where ``|g_jax|`` exceeds 1e-12 or is 0 (a
gradient within rounding of Adam's eps may move its entry by up to 2 lr,
as ``test_torch_ngp_trainer.py`` explains), all of them to 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instance_nerf_tpu.data.nerf_dataset import make_synthetic_nerf_scene
from instance_nerf_tpu.models.fast_encode import InstanceNGPFast
from instance_nerf_tpu.parallel.mesh import make_mesh
from instance_nerf_tpu.parallel.ngp_train_step import (
    NGPTrainState,
    init_multiscene_params,
    make_multiscene_ngp_step,
)
from instance_nerf_tpu.train import multiscene as JM
from instance_nerf_tpu.train import ngp_trainer as JT
from instance_nerf_tpu_torch.convert import fleet_params_from_jax
from instance_nerf_tpu_torch.models.render import OccupancyGrid
from instance_nerf_tpu_torch.train import multiscene as TM
from instance_nerf_tpu_torch.train import ngp_trainer as TT

torch.set_num_threads(2)

B, R, S = 3, 64, 16
MODEL = dict(n_levels=2, table_size=2 ** 10, n_features=4, base_res=8, max_res=64,
             dense_res=4, dense_features=2, hidden=16, num_instances=4)
CFG = dict(encoding="fast", n_levels=2, table_size=2 ** 10, n_features=4, base_res=8,
           max_res=64, dense_res=4, dense_features=2, hidden=16, num_instances=4,
           n_rays=R, n_samples=S, k_occupied=6, occ_res=16, occ_coarse_res=8, dtype="float32")
STAGES = {"rgb": dict(), "instance": dict(k_buckets=((0.5, 4), (0.5, 8)))}
FLOOR = 1e-12
LR = 1e-2


def _keep_grads():
    """optax Adam that also keeps the gradient it was handed in its state."""
    adam = optax.adam(LR, b1=0.9, b2=0.99, eps=1e-15)

    def init(p):
        return {"adam": adam.init(p), "g": jax.tree.map(jnp.zeros_like, p)}

    def update(g, s, p=None):
        u, a = adam.update(g, s["adam"], p)
        return u, {"adam": a, "g": g}

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(0)
    scenes = [make_synthetic_nerf_scene(rng, n_views=3, hw=(16, 16), n_blobs=2)[0]
              for _ in range(B)]
    model = InstanceNGPFast(**MODEL)
    params = init_multiscene_params(model, B, jax.random.split(jax.random.key(0), B))
    occ = np.where(np.random.default_rng(1).uniform(size=(B, 16, 16, 16)) < 0.15, 1e3, 0.0)
    return scenes, model, jax.tree.map(np.asarray, params), occ.astype(np.float32)


def _rays(scenes, seed):
    rng = np.random.default_rng(seed)
    o, d, rgb, inst = [], [], [], []
    for sc in scenes:
        v, pix, c, m = sc.ray_batch(rng, R)
        oo, dd = JT.rays_multi(jnp.asarray(sc.poses), v, pix, sc)
        o.append(np.asarray(oo))
        d.append(np.asarray(dd))
        rgb.append(c)
        inst.append(m)
    return [np.stack(x).astype(np.float32 if i < 3 else np.int32)
            for i, x in enumerate((o, d, rgb, inst))]


def _port_model(params, **over):
    cfg = TT.NGPConfig(**{**CFG, **over, "pallas_grad": True})
    model = TT.build_model(cfg, n_scenes=B)
    model.load_state_dict(fleet_params_from_jax(params), strict=True)
    return cfg, model


@pytest.mark.parametrize("stage", ["rgb", "instance"])
def test_fleet_step_matches_jax(fleet, stage):
    scenes, model, params, occ = fleet
    over = STAGES[stage]
    jcfg = JT.NGPConfig(**{**CFG, **over})
    tx = _keep_grads()
    step = make_multiscene_ngp_step(lambda p, x, v: model.apply(p, x, v), tx,
                                    make_mesh(n_data=1, n_spatial=1), n_samples=S,
                                    k_occupied=jcfg.k_occupied, stage=stage,
                                    occ_coarse_res=jcfg.occ_coarse_res,
                                    k_buckets=jcfg.k_buckets)
    rays = _rays(scenes, 5 if stage == "rgb" else 6)
    key = jax.random.key(7)
    state, m_j = step(NGPTrainState(params, tx.init(params)), jnp.asarray(occ), key,
                      *map(jnp.asarray, rays))
    draws = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (R, S)))
                                   for k in jax.random.split(key, B)]))

    cfg, tmodel = _port_model(params, **over)
    opt = TT.adam_init(tmodel)
    losses, grads = TT.field_loss_and_grads(
        tmodel, cfg, stage, OccupancyGrid(torch.from_numpy(occ), cfg.occ_threshold),
        *map(torch.from_numpy, rays), jitter=draws)
    TT.adam_update(tmodel, grads, opt, stage, LR)
    for k, v in m_j.items():
        np.testing.assert_allclose(float(losses[k].mean()), float(v), rtol=1e-5, err_msg=k)

    g_j = {k: v.numpy() for k, v in fleet_params_from_jax(
        jax.tree.map(np.asarray, state.opt_state["g"])).items()}
    p_j = {k: v.numpy() for k, v in fleet_params_from_jax(
        jax.tree.map(np.asarray, state.params)).items()}
    for k, gj in g_j.items():
        gt = grads[k]
        if gt is None or (stage == "instance" and not k.startswith("inst_")):
            assert not gj.any(), k  # nothing flowed, or masked out, on both sides
            continue
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5 * np.abs(gj).max(),
                                   err_msg=k)
    assert np.abs(g_j["brick_table"]).max() > 0 or stage == "instance"
    p_t = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    before = {k: v.numpy() for k, v in fleet_params_from_jax(params).items()}
    excluded = touched = 0
    for k, pj in p_j.items():
        ag = np.abs(g_j[k])
        held = (ag > FLOOR) | (ag == 0)
        np.testing.assert_allclose(p_t[k][held], pj[held], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(p_t[k], pj, rtol=0, atol=2.01 * LR, err_msg=k)
        excluded += int((~held).sum())
        touched += int((ag > 0).sum())
        if stage == "instance":  # frozen NeRF: only inst_* moved
            assert np.array_equal(p_t[k], before[k]) != k.startswith("inst_"), k
    assert excluded <= 0.1 * touched, (excluded, touched)


def test_fleet_table_gradient_is_one_launch_layout(fleet):
    """The fleet's table gradient reaches kernel B4 as ONE call over B * L
    levels in the ``(N, B, L)`` layout, and equals the per-scene brick
    gradients stacked."""
    from instance_nerf_tpu_torch.kernels import scatter_cuda
    from instance_nerf_tpu_torch.models import fast_encode as TF

    scenes, _, params, _ = fleet
    cfg, tmodel = _port_model(params)
    calls = []
    orig = scatter_cuda.level_scatter_add_plain

    def spy(idx, upd, n_levels, trailing, rows):
        calls.append((idx.shape[0], n_levels, trailing, rows))
        return orig(idx, upd, n_levels, trailing, rows)

    xyz = torch.rand((B, 200, 3), generator=torch.Generator().manual_seed(3))
    scatter_cuda.level_scatter_add_plain = spy
    try:
        TF.brick_encode(tmodel.brick_table, xyz, tmodel.resolutions,
                        pallas_grad=True).square().sum().backward()
    finally:
        scatter_cuda.level_scatter_add_plain = orig
    assert calls == [(200 * B * 2, B * 2, 1, 2 ** 10)]
    for b in range(B):
        tab = tmodel.brick_table[b].detach().clone().requires_grad_(True)
        TF.brick_encode(tab, xyz[b], tmodel.resolutions).square().sum().backward()
        np.testing.assert_allclose(tmodel.brick_table.grad[b].numpy(), tab.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)


def _jax_trainer(scenes, **over):
    cfg = JT.fast_ngp_config(**{**CFG, **over})
    return JM.MultiSceneFieldTrainer(scenes, cfg, seed=4)


def test_batch_draws_equal_jax(fleet):
    scenes = fleet[0]
    jt = _jax_trainer(scenes)
    tt = TM.MultiSceneFieldTrainer(scenes, TT.fast_ngp_config(**CFG), seed=4, device="cpu")
    for _ in range(2):
        for a, b in zip(jt._batch(), tt._batch()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jt._scan_batch(3), tt._scan_batch(3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a scan call's rays, computed on the device from its draws
    v, pix = tt._scan_batch(2)[:2]
    o, d = tt._rays(v[1], pix[1])
    for i, sc in enumerate(scenes):
        jo, jd = JT.rays_multi(jnp.asarray(sc.poses), np.asarray(v[1, i]),
                               np.asarray(pix[1, i]), sc)
        np.testing.assert_allclose(o[i].numpy(), np.asarray(jo), rtol=0, atol=1e-7)
        np.testing.assert_allclose(d[i].numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("subsample", [0.3, 1.0])
def test_occupancy_refresh_matches_jax(fleet, subsample):
    """The fleet's refresh on the same cells and jitter: dense, and as a
    scatter-max of M random cells (repeats among them) into the 0.95-decayed
    grid."""
    scenes, _, params, occ = fleet
    jt = _jax_trainer(scenes, occ_subsample=subsample)
    jt.state = jt.state._replace(params=jax.tree.map(jnp.asarray, params))
    jt.occ_grids = jnp.asarray(occ)
    key = jax.random.key(11)
    g, m = 16, max(1, int(16 ** 3 * subsample))
    if subsample < 1:
        kc, kj = jax.random.split(key)
        cells = np.array(jax.random.randint(kc, (B, m), 0, g ** 3))
        jitter = np.asarray(jax.random.uniform(kj, (B, m, 3)))
        assert len(np.unique(cells[0])) < m  # repeated cells
    else:
        cells, jitter = None, np.asarray(jax.random.uniform(key, (B, g ** 3, 3)))
    want = np.asarray(jt._occ_update_fn()(jt.state.params, jt.occ_grids, key))
    tt = TM.MultiSceneFieldTrainer(scenes, TT.fast_ngp_config(**CFG, occ_subsample=subsample),
                                   seed=4, device="cpu")
    tt.model.load_state_dict(fleet_params_from_jax(params))
    tt.occ_grids = torch.from_numpy(occ)
    tt.update_occupancy(cells=cells, jitter=torch.tensor(jitter))
    np.testing.assert_allclose(tt.occ_grids.numpy(), want, rtol=1e-5, atol=1e-7)


def test_fleet_params_convert_per_scene(fleet):
    """Scene i of the converted fleet is scene i of the JAX stack, through
    the single-scene conversion; ``scene_params`` hands it back by the
    single-scene field's names."""
    from instance_nerf_tpu_torch.convert import ngp_params_from_jax

    scenes, _, params, _ = fleet
    conv = fleet_params_from_jax(params)
    tt = TM.MultiSceneFieldTrainer(scenes, TT.fast_ngp_config(**CFG), device="cpu")
    tt.model.load_state_dict(conv)
    for i in range(B):
        one = ngp_params_from_jax(jax.tree.map(lambda x: x[i], params))
        got = tt.scene_params(i)
        assert sorted(got) == sorted(one)
        for k in one:
            assert torch.equal(got[k], one[k]), k
    single = TT.InstanceFieldTrainer(TT.fast_ngp_config(**CFG), device="cpu")
    single.model.load_state_dict(tt.scene_params(1), strict=True)


def _state_arrays(tr):
    out = {f"p/{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
    out.update({f"mu/{k}": v.clone() for k, v in tr.opt_state["mu"].items()})
    out.update({f"nu/{k}": v.clone() for k, v in tr.opt_state["nu"].items()})
    out["occ"] = tr.occ_grids.clone()
    return out


def test_save_restore_bit_exact_and_background_snapshot(fleet, tmp_path):
    scenes = fleet[0]
    cfg = TT.fast_ngp_config(**CFG, occ_update_every=3, occ_subsample=0.5, pallas_grad=True)
    tr = TM.MultiSceneFieldTrainer(scenes, cfg, seed=0, device="cpu")
    tr.train(4, stage="rgb", log_every=0)
    want, count = _state_arrays(tr), tr.opt_state["count"]
    tr.save(str(tmp_path / "fleet"), step=4, background=True)
    tr.train(3, stage="rgb", log_every=0)  # moves the live tensors in place
    tr.wait_for_save()
    tr.wait_for_save()  # idempotent
    moved = _state_arrays(tr)
    assert any(not torch.equal(moved[k], want[k]) for k in want)

    tr2 = TM.MultiSceneFieldTrainer(scenes, cfg, seed=9, device="cpu")
    meta = tr2.restore(str(tmp_path / "fleet"))
    assert meta["step"] == 4 and meta["config"] == {"n_scenes": B}
    got = _state_arrays(tr2)
    assert tr2.opt_state["count"] == count == 4
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a foreground save of the moved state restores bit-exact too
    tr.save(str(tmp_path / "fleet"), step=7)
    tr2.restore(str(tmp_path / "fleet"))
    got = _state_arrays(tr2)
    for k in moved:
        assert torch.equal(got[k], moved[k]), k


def test_device_data_store_and_steps_per_call(fleet):
    """The device-resident store holds the scenes' uint8 images and int8
    masks; a call of several steps draws there, and a remainder step on the
    host stream. ``steps_per_call`` keeps the occupancy cadence."""
    scenes = fleet[0]
    cfg = TT.fast_ngp_config(**CFG, occ_update_every=4)
    tr = TM.MultiSceneFieldTrainer(scenes, cfg, seed=0, device="cpu", device_data=True)
    assert tr._imgs_dev.dtype == torch.uint8 and tr._masks_dev.dtype == torch.int8
    assert tuple(tr._imgs_dev.shape) == (B, 3, 256, 3)
    calls = []
    refresh = tr.update_occupancy
    tr.update_occupancy = lambda: calls.append(refresh())
    state = tr.np_rng.bit_generator.state
    out = tr.train(10, stage="rgb", log_every=0, steps_per_call=4)
    assert len(calls) == 2 and np.isfinite(out["rgb"])
    # two device calls of 4, then 2 host steps: the numpy stream moved twice
    ref = np.random.default_rng(0)
    ref.bit_generator.state = state
    for _ in range(2):
        ref.random((B, R))
        ref.integers(0, 256, (B, R))
    assert tr.np_rng.bit_generator.state == ref.bit_generator.state
    assert TM.MultiSceneFieldTrainer.fleet_data_bytes(4, 2, (16, 16)) == 4 * 2 * 256 * 4
    with pytest.raises(RuntimeError, match="cuda"):
        tr.benchmark(steps=1)


@pytest.mark.parametrize("encoding", ["hash", "fast"])
def test_fleet_field_equals_per_scene_fields(encoding):
    """A fleet field (``build_model(cfg, n_scenes=3)``) queried with ``(B, N,
    3)`` points equals each scene's single field on its own points, forward
    and gradient, for both encodings (the fleet's hash layout is ``(N, B, L,
    8)``, trailing 8)."""
    cfg = TT.NGPConfig(encoding=encoding, n_levels=2, table_size=2 ** 9, max_res=32,
                       dense_res=4, dense_features=2, hidden=16, num_instances=4,
                       pallas_grad=True)
    fleet = TT.build_model(cfg, n_scenes=B)
    TT.init_ngp_params(fleet, 5)
    gen = torch.Generator().manual_seed(6)
    xyz, vd = torch.rand((B, 150, 3), generator=gen), torch.randn((B, 150, 3), generator=gen)
    outs = fleet(xyz, vd)
    sum(o.square().sum() for o in outs).backward()
    for b in range(B):
        one = TT.build_model(cfg)
        one.load_state_dict({k: v[b] for k, v in fleet.state_dict().items()})
        want = one(xyz[b], vd[b])
        sum(o.square().sum() for o in want).backward()
        for got, w in zip(outs, want):
            np.testing.assert_allclose(got[b].detach().numpy(), w.detach().numpy(),
                                       rtol=1e-5, atol=1e-6)
        for k, p in one.named_parameters():
            np.testing.assert_allclose(dict(fleet.named_parameters())[k].grad[b].numpy(),
                                       p.grad.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
