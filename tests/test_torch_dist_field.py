"""The instance field over several ranks on the CPU, against the JAX
package's sharded steps: ranks spawned as processes of
``tests/dist_worker.py`` (gloo, a ``file://`` store, one thread each),
which import only torch, numpy and the port; the JAX side runs here.

- ``field_loss_and_grads`` over ``data_group`` on world 2 (each rank its
  block of the rays; with ``k_buckets`` each routes its own) against JAX
  ``make_sharded_ngp_step`` on ``make_mesh(n_data=2)``, unstratified:
  losses 1e-5, gradients 1e-5 of their largest entry.
- The fleet: B = 4 on world 2 (two scenes a rank) and B = 2 on world 4 (a
  scene's rays split over 2 ranks, with and without ``k_buckets``, routed
  over the scene's whole batch) against JAX ``make_multiscene_ngp_step`` on
  the trainer's default meshes, with the same stratified draws (JAX's, from
  the per-scene keys its step splits): the mean losses 1e-5, each rank's
  scenes' gradients 1e-5 of the largest entry (in the instance stage the
  instance head's, the rest masked on both sides; with a scene's rays split,
  the dense grid's, rounded to bf16 on each rank before the sum, to one
  bf16 ulp of its largest entry).
- A fleet trained and saved on world 2 restores bit-identical in one
  process, and on the 2 ranks (each rank its block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.models.fast_encode import InstanceNGPFast
from instance_nerf_tpu.parallel.mesh import make_mesh
from instance_nerf_tpu.parallel.ngp_train_step import (
    NGPTrainState,
    init_multiscene_params,
    make_multiscene_ngp_step,
    make_sharded_ngp_step,
)
from instance_nerf_tpu.train import ngp_trainer as JT
from instance_nerf_tpu_torch.convert import fleet_params_from_jax, ngp_params_from_jax
from tests import dist_worker as W
from tests.test_torch_train_step import capture

torch.set_num_threads(2)

FIELD = dict(n_levels=2, table_size=2 ** 10, max_res=32, hidden=16, num_instances=4,
             n_rays=64, n_samples=16, k_occupied=6, occ_res=16, pallas_grad=True)
FIELD_CASES = {"rgb": ("rgb", None), "rgb_buckets": ("rgb", ((0.5, 4), (0.5, 8))),
               "instance_buckets": ("instance", ((0.5, 4), (0.5, 8)))}
FLEET_MODEL = dict(n_levels=2, table_size=2 ** 10, n_features=4, base_res=8, max_res=64,
                   dense_res=4, dense_features=2, hidden=16, num_instances=4)
FLEET = dict(encoding="fast", **FLEET_MODEL, n_rays=32, n_samples=16, k_occupied=6,
             occ_res=16, occ_coarse_res=8, dtype="float32", pallas_grad=True)
BUCKETS = ((0.5, 4), (0.5, 8))
# (B, world, stage, k_buckets)
FLEET_CASES = {"b4_w2_rgb": (4, 2, "rgb", None), "b4_w2_instance": (4, 2, "instance", BUCKETS),
               "b2_w4_rgb": (2, 4, "rgb", None), "b2_w4_buckets": (2, 4, "rgb", BUCKETS)}


def _rays(rng, lead, r, n_inst):
    o = np.concatenate([rng.uniform(0.1, 0.9, (*lead, r, 2)),
                        np.full((*lead, r, 1), -0.3)], -1)
    d = np.concatenate([rng.normal(0, 0.2, (*lead, r, 2)), np.ones((*lead, r, 1))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [o.astype(np.float32), d.astype(np.float32),
            rng.uniform(0, 1, (*lead, r, 3)).astype(np.float32),
            rng.integers(-1, n_inst, (*lead, r)).astype(np.int32)]


def _jax_field(name):
    """The JAX sharded step's metrics and gradients (port names), and the
    worker's keywords."""
    stage, kb = FIELD_CASES[name]
    # XLA's scatter on the JAX side: its Pallas scatter does not trace under
    # the k_buckets path's shard_map (no varying-axes type on its output);
    # the port runs B3's plain version, the same function
    jt = JT.InstanceFieldTrainer(JT.NGPConfig(**{**FIELD, "pallas_grad": False}), seed=0)
    rng = np.random.default_rng(1)
    occ = np.where(rng.uniform(size=(16,) * 3) < 0.4, 1e3, 0.0).astype(np.float32)
    rays = _rays(rng, (), FIELD["n_rays"], FIELD["num_instances"])
    step = make_sharded_ngp_step(jt._apply, capture(), make_mesh(n_data=2),
                                 n_samples=FIELD["n_samples"], k_occupied=FIELD["k_occupied"],
                                 stage=stage, k_buckets=kb, stratified=False)
    st, m = step(NGPTrainState(jt.params, capture().init(jt.params)), jnp.asarray(occ),
                 jax.random.key(3), *map(jnp.asarray, rays))
    grads = ngp_params_from_jax(jax.tree.map(np.asarray, st.opt_state))
    params = ngp_params_from_jax(jax.tree.map(np.asarray, jt.params))
    kw = dict(cfg=dict(FIELD, k_buckets=kb), params=params, occ=occ, rays=rays, stage=stage)
    return {k: float(v) for k, v in m.items()}, grads, kw


def _jax_fleet(name):
    """The JAX fleet step's mean metrics and gradients (port names, leading
    scene axis) on the trainer's default mesh, and the worker's keywords."""
    b, world, stage, kb = FLEET_CASES[name]
    model = InstanceNGPFast(**FLEET_MODEL)
    params = init_multiscene_params(model, b, jax.random.split(jax.random.key(0), b))
    rng = np.random.default_rng(2)
    occ = np.where(rng.uniform(size=(b, 16, 16, 16)) < 0.4, 1e3, 0.0).astype(np.float32)
    rays = _rays(rng, (b,), FLEET["n_rays"], FLEET_MODEL["num_instances"])
    mesh = make_mesh(n_data=min(b, world), n_spatial=world // min(b, world))
    tx = capture()
    step = make_multiscene_ngp_step(lambda p, x, v: model.apply(p, x, v), tx, mesh,
                                    n_samples=FLEET["n_samples"],
                                    k_occupied=FLEET["k_occupied"], stage=stage,
                                    occ_coarse_res=FLEET["occ_coarse_res"], k_buckets=kb)
    key = jax.random.key(5)
    st, m = step(NGPTrainState(params, tx.init(params)), jnp.asarray(occ), key,
                 *map(jnp.asarray, rays))
    jitter = np.stack([np.asarray(jax.random.uniform(k, (FLEET["n_rays"], FLEET["n_samples"])))
                       for k in jax.random.split(key, b)])
    grads = fleet_params_from_jax(jax.tree.map(np.asarray, st.opt_state))
    kw = dict(cfg=dict(FLEET, k_buckets=kb), stage=stage, occ=occ, rays=rays, jitter=jitter,
              params=fleet_params_from_jax(jax.tree.map(np.asarray, params)))
    return {k: float(v) for k, v in m.items()}, grads, kw


FLEET_SAVE = dict(FLEET, occ_update_every=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_side = {n: _jax_field(n) for n in FIELD_CASES}
    jax_side.update({n: _jax_fleet(n) for n in FLEET_CASES})
    save = tmp_path_factory.mktemp("fleet_ckpt")
    w2 = [(n, "field_step", jax_side[n][2]) for n in FIELD_CASES]
    w2 += [(n, "fleet_step", jax_side[n][2]) for n, c in FLEET_CASES.items() if c[1] == 2]
    w2 += [("save", "fleet_train_save", dict(cfg=FLEET_SAVE, n_scenes=4, steps=3,
                                             path=str(save))),
           ("restore", "fleet_restore", dict(cfg=FLEET_SAVE, n_scenes=4, path=str(save)))]
    w4 = [(n, "fleet_step", jax_side[n][2]) for n, c in FLEET_CASES.items() if c[1] == 4]
    ranks = {2: W.spawn(tmp_path_factory.mktemp("w2"), 2, w2, timeout=240),
             4: W.spawn(tmp_path_factory.mktemp("w4"), 4, w4, timeout=240)}
    return jax_side, ranks, save


def _close(got, want, tol=1e-5, skip=lambda n: False, loose=None):
    """Every gradient of ``want`` to ``tol`` of its largest entry (those in
    ``loose`` to their own tolerance)."""
    n = 0
    for k, w in want.items():
        w = w.double()
        if skip(k):  # masked on the JAX side, by adam_update on the port's
            assert not w.any(), k
            continue
        if got[k] is None:
            assert not w.any(), k
            continue
        scale = max(float(w.abs().max()), 1e-30)
        t = (loose or {}).get(k, tol)
        assert float((got[k].double() - w).abs().max()) <= t * scale, (k, scale)
        n += 1
    assert n > 0


@pytest.mark.parametrize("name", list(FIELD_CASES))
def test_sharded_field_step_matches_jax(name, runs):
    jax_side, ranks, _ = runs
    jm, jg, kw = jax_side[name]
    (m0, g0), (m1, g1) = ranks[2][0][name], ranks[2][1][name]
    assert m0 == m1
    for k, v in jm.items():
        assert abs(m0[k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, m0[k], v)
    frozen = (lambda k: not k.startswith("inst_")) if kw["stage"] == "instance" else (
        lambda k: False)
    _close(g0, jg, skip=frozen)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in
               zip(g0.values(), g1.values()))


@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_split_fleet_step_matches_jax(name, runs):
    jax_side, ranks, _ = runs
    b, world, stage, _ = FLEET_CASES[name]
    jm, jg, _ = jax_side[name]
    per_scene = {}
    for rank in ranks[world]:
        losses, grads, (s0, s1), _ = rank[name]
        for k, v in losses.items():
            per_scene.setdefault(k, np.zeros(b))[s0:s1] = v
        frozen = (lambda k: not k.startswith("inst_")) if stage == "instance" else (
            lambda k: False)
        # the dense grid's gradient is rounded to bf16 after accumulation (the
        # JAX cast's VJP): a scene split over ranks rounds each rank's part
        # before the sum, so it holds to one bf16 ulp of its largest entry
        loose = {"dense_grid": 2.0 ** -7} if world > b else None
        _close(grads, {k: v[s0:s1] for k, v in jg.items()}, skip=frozen, loose=loose)
    for k, v in jm.items():
        assert abs(per_scene[k].mean() - v) <= 1e-5 * max(abs(v), 1e-6), (k, v)


def _same_block(one, block):
    """The one-process fleet ``one`` holds the rank's ``block`` bit for bit."""
    params, moments, occ, (s0, s1) = block
    for k, v in one.model.state_dict().items():
        assert torch.equal(v[s0:s1], params[k]), k
    for m in ("mu", "nu"):
        for k, v in one.opt_state[m].items():
            assert torch.equal(v[s0:s1], moments[m][k]), (m, k)
    assert torch.equal(one.occ_grids[s0:s1], occ)


def _restored_in_one_process(save):
    one = W.fleet(FLEET_SAVE, 4)
    assert one.mesh is None
    meta = one.restore(str(save))
    assert meta["step"] == 3 and one.opt_state["count"] == 3
    return one


def test_fleet_saved_on_two_ranks_restores_in_one_process(runs):
    _, ranks, save = runs
    one = _restored_in_one_process(save)
    for block in (r["save"] for r in ranks[2]):
        _same_block(one, block)


def test_fleet_saved_on_two_ranks_restores_on_two_ranks(runs):
    """Restored on the 2 ranks, each rank's block equals the one-process
    restore's."""
    _, ranks, save = runs
    one = _restored_in_one_process(save)
    blocks = [r["restore"] for r in ranks[2]]
    assert [b[3] for b in blocks] == [(0, 2), (2, 4)]
    for block in blocks:
        _same_block(one, block)


def test_rank_generator_streams():
    """The ray-sharded step's draws on a rank: ``rank_generator(seed, rank)``
    repeats for its ``(seed, rank)`` and differs between ranks and seeds."""
    from instance_nerf_tpu_torch.parallel.ngp_train_step import rank_generator

    draws = [torch.rand(64, generator=rank_generator(s, r, "cpu"))
             for s, r in ((3, 0), (3, 1), (3, 0), (4, 0))]
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[3])
