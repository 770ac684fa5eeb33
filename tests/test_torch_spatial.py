"""The mesh's spatial axis (``parallel/spatial.py``): FCOS training with each
scene's W split over ``sp`` ranks, on the CPU. Ranks are processes of
``tests/dist_worker.py`` (gloo, a ``file://`` store, one thread each),
which import only torch, numpy and the port; the JAX side runs here while
they run.

- The W layout, the halo ranges and the exchange plan as plain functions:
  GSPMD's blocks (5 rows over 4 ranks: 2, 2, 1, 0), the asymmetric SAME pads
  of the k7 s2 stem, the cyclic ranges of the shifted windows, and that
  every row a rank takes is a row another rank sends it.
- One world-2 ``sp = 2`` f32 step of rotated FCOS on the toy Swin of
  ``tests/test_torch_dist_train.py`` equals the JAX step sharded over
  ``make_mesh(n_data=1, n_spatial=2)`` (the stride-32 level's one row on
  rank 0, none on rank 1): losses 1e-5, gradients 1e-4 of their largest
  entry.
- In f64, world-2 steps at W = 40 (levels 10, 5, 3, 2: the 5- and 3-row
  levels split 3 / 2 and 2 / 1) and world-4 steps at W = 48 (levels 12, 6,
  3, 2: ranks with no rows from the second level on) equal the port's
  one-process step, for VGG-EF, VGG-AF, ResNet (one bottleneck a stage) and
  the toy Swin, AABB and OBB (with and without the 2D projection loss),
  with and without ``remat``: losses 1e-6,
  gradients 1e-5 of their largest entry (a parameter's largest gradient
  below 1e-9 of the step's held to that floor). Both sides start from the
  trainer's seeded init, stop at the gradient the optimizer is given and
  keep it in f32 (its rounding is 1e-7 of an entry): a VGG-EF step's f64
  state is otherwise gigabytes a process.
- ``local_rows`` raises where ``sp`` does not divide W, as JAX's
  ``device_put`` on ``grid_sharding`` does.
- ``run_fcos --n_spatial 2 --mode train`` on 2 ranks against one process.
- ``data/native.py`` against its numpy formulas and the JAX package's
  binding, on the same arrays.
"""
import numpy as np
import pytest
import torch

from instance_nerf_tpu.parallel import mesh as JM
from instance_nerf_tpu_torch.parallel import mesh as TM
from instance_nerf_tpu_torch.parallel import spatial as SP
from tests import dist_worker as W
from tests.test_torch_dist_train import SWIN, _check, _inputs, _losses

torch.set_num_threads(2)

RESNET = dict(layers=(1, 1, 1, 1), is_max_pool=True)
# the OBB losses' other terms: the 2D projection loss and the extra L1
PROJ2D = dict(proj2d_loss_weight=0.5, use_additional_l1_loss=True)
# (name, world, W, backbone, obb, remat, other config)
CASES = [("vgg_EF", 2, 40, "vgg_EF", False, False, {}),
         ("vgg_AF_obb", 2, 40, "vgg_AF", True, False, {}),
         ("swin_obb_proj2d", 2, 40, "swin", True, False, PROJ2D),
         ("vgg_AF_remat", 2, 40, "vgg_AF", False, True, {}),
         ("resnet_w4", 4, 48, "resnet", False, False, {}),
         ("swin_w4_remat", 4, 48, "swin", False, True, {})]


def test_blocks_are_gspmd_blocks():
    assert SP.blocks(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert SP.blocks(40, 2) == [(0, 20), (20, 40)]
    assert SP.blocks(3, 2) == [(0, 2), (2, 3)]
    assert SP.blocks(1, 2) == [(0, 1), (1, 1)]
    lay = SP.WLayout(5, 4, 2)
    assert (lay.lo, lay.hi) == (4, 5) and lay.strided(2).owned == [(0, 1), (1, 2), (2, 3),
                                                                     (3, 3)]


def test_window_rows_take_global_same_pads():
    # the k7 s2 stem on 160 pads 2 low and 3 high (flax SAME), from the global size
    assert SP.same_pads(160, 7, 2) == (2, 3)
    out, want = SP.window_rows(SP.WLayout(160, 2, 0), 7, 2)
    assert out.size == 80 and want == (((-2, 83),), ((78, 163),))
    # k3 s1: one halo row each side; rows past the global edges are padding
    _, want = SP.window_rows(SP.WLayout(10, 4, 0), 3, 1)
    assert want == (((-1, 4),), ((2, 7),), ((5, 10),), ((8, 11),))
    # a k3 s2 pool on an odd size pads (1, 1); an output without rows wants none
    _, want = SP.window_rows(SP.WLayout(5, 4, 0), 3, 2)
    assert want == (((-1, 2),), ((1, 4),), ((3, 6),), ())
    # the FPN's extra level keeps the global even rows
    _, want = SP.window_rows(SP.WLayout(10, 2, 0), 1, 2)
    assert want == (((0, 5),), ((6, 9),))


def test_wrapped_ranges():
    assert SP.wrapped(2, 6, 8) == ((2, 6),)
    assert SP.wrapped(6, 10, 8) == ((6, 8), (0, 2))
    assert SP.wrapped(-2, 2, 8) == ((6, 8), (0, 2))
    assert SP.wrapped(3, 3, 8) == ()


@pytest.mark.parametrize("size,parts,kernel,stride", [(5, 4, 3, 2), (40, 2, 7, 2),
                                                       (11, 3, 3, 1), (3, 4, 2, 2)])
def test_exchange_plan_is_symmetric(size, parts, kernel, stride):
    """Every row a rank takes from another rank is one that rank sends it,
    in order; the rest are the rank's own or padding past the edges."""
    lay = SP.WLayout(size, parts, 0)
    _, want = SP.window_rows(lay, kernel, stride)
    plans = [SP._plan(lay.owned, want, size, q) for q in range(parts)]
    for me, (pieces, _) in enumerate(plans):
        assert sum(hi - lo for _, lo, hi in pieces) == sum(b - a for a, b in want[me])
        for q in range(parts):
            taken = [(lo, hi) for r, lo, hi in pieces if r == q]
            if q == me:
                assert all(lay.owned[me][0] <= lo < hi <= lay.owned[me][1] for lo, hi in taken)
            else:
                assert taken == plans[q][1].get(me, [])
        assert all(hi <= 0 or lo >= size for r, lo, hi in pieces if r is None)


@pytest.mark.parametrize("w,sp", [(10, 4), (7, 2), (6, 4)])
def test_local_rows_raise_where_sp_does_not_divide_w(w, sp):
    grids = np.zeros((2, w, 4, 4, 2), np.float32)
    jmesh = JM.make_mesh(n_data=1, n_spatial=sp)
    with pytest.raises(ValueError):
        JM.shard_batch(jmesh, {"grids": grids})
    with pytest.raises(ValueError, match="does not divide"):
        TM.local_rows(TM.Mesh(1, 1, sp, rank=0, world=sp), {"grids": grids})
    with pytest.raises(ValueError, match="does not divide"):
        SP.split_size(w, sp)
    assert TM.local_rows(TM.Mesh(1, 1, sp, rank=sp - 1, world=sp),
                         {"g": np.zeros((2, w * sp, 4, 4, 2))})["g"].shape[1] == w


def _batch(shape, seed, obb):
    """Two scenes of ``shape`` (H padded past ``shape[2] - 4``) with 4 gt
    boxes each, spread along W (the last box of scene 1 masked)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 1, (2, *shape, 4)).astype(np.float32)
    g[:, :, :, shape[2] - 4:] = 0
    sizes = np.tile(np.array([[shape[0], shape[1], shape[2] - 4]], np.float32), (2, 1))
    lo = np.stack([rng.uniform(1, shape[0] * 0.6, (2, 4)), rng.uniform(1, 6, (2, 4)),
                   rng.uniform(1, 5, (2, 4))], -1)
    gt = np.concatenate([lo, np.minimum(lo + rng.uniform(4, 12, (2, 4, 3)),
                                        sizes[:, None])], -1)
    if obb:
        gt = np.concatenate([(gt[..., :3] + gt[..., 3:]) / 2, gt[..., 3:] - gt[..., :3],
                             rng.uniform(-1.2, 1.2, (2, 4, 1))], -1)
    mask = np.ones((2, 4), bool)
    mask[1, -1] = False
    return g, sizes, gt.astype(np.float32), mask


def _cli_argv(data, out, *extra):
    return ["--mode", "train", "--device", "cpu", "--features_path", f"{data}/features",
            "--boxes_path", f"{data}/metadata", "--dataset_split",
            f"{data}/dataset_split.json", "--save_path", str(out), "--resolution", "32",
            "--batch_size", "2", "--num_epochs", "1", "--backbone_type", "vgg_AF",
            "--dtype", "float32", "--num_convs", "2", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every world (2 and 4) on their cases, the one-process
    side in two processes of its own, and meanwhile the JAX sharded step
    here. What they wrote (gradients, checkpoints: gigabytes) goes at the
    module's end."""
    import shutil

    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    tmp = tmp_path_factory.mktemp("inputs")
    dirs = [tmp]
    cases = {2: [], 4: []}
    one = [[], []]
    for i, (name, world, w, bb, obb, remat, other) in enumerate(CASES):
        cfg = dict(dtype="float32", rotated_bbox=obb, num_convs=2, resolution=32,
                   backbone_type=bb, remat=remat, batch_size=2, **other)
        trunk = {"swin": dict(swin=SWIN), "resnet": dict(resnet=RESNET)}.get(bb, {})
        base = dict(kind="fcos", params=None, batch=_batch((w, 16, 16), i, obb),
                    dtype="float64", update=False, grads_dtype="float32", **trunk)
        cases[world].append((name, "detector_step", dict(base, cfg=dict(cfg, n_spatial=world))))
        one[i % 2].append((name, "detector_step", dict(base, cfg=cfg)))
    jax_parts, _, cfg, params, batch, _ = _inputs("fcos_obb", tmp)
    cases[2].append(("jax", "detector_step",
                     dict(kind="fcos", params=params, swin=SWIN, batch=batch,
                          cfg=dict(cfg, batch_size=2, n_spatial=2))))
    data = tmp / "data"
    write_dataset(str(data), num_scenes=4, grid_size=(32, 32, 24))
    cases[2].append(("cli", "run_cli", dict(cli="run_fcos", argv=_cli_argv(
        data, tmp / "two", "--n_spatial", "2"))))
    one[1].append(("cli", "run_cli", dict(cli="run_fcos", argv=_cli_argv(data, tmp / "one"))))
    dirs += [tmp_path_factory.mktemp(f"w{world}") for world in cases]
    dirs += [tmp_path_factory.mktemp(f"one{j}") for j in range(len(one))]
    started = {world: W.start(d, world, c) for d, (world, c) in zip(dirs[1:], cases.items())}
    ones = [W.start_one(d, c) for d, c in zip(dirs[1 + len(cases):], one)]
    jax_side = _jax_step(jax_parts, batch, tmp)
    one_res = [o.wait(timeout=300)[0] for o in ones]
    yield ({name: one_res[j][name] for j, c in enumerate(one) for name, _, _ in c
            if name != "cli"},
           {world: r.wait(timeout=300) for world, r in started.items()}, jax_side, tmp)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _jax_step(jax_parts, batch, tmp):
    """The JAX rotated FCOS step sharded over ``make_mesh(n_data=1,
    n_spatial=2)`` (the grids' W on ``sp``), its gradient kept by
    ``capture``: (metrics, the gradients' file in the port's names)."""
    import jax
    import jax.numpy as jnp

    from instance_nerf_tpu.parallel import train_step as JS
    from tests.test_torch_train_step import capture

    jt, params, _, convert = jax_parts
    step = JS.make_fcos_train_step(jt.model, capture(),
                                   mesh=JM.make_mesh(n_data=1, n_spatial=2), use_obb=True)
    st, jm = step(JS.TrainState(params, capture().init(params), jnp.zeros((), jnp.int32)),
                  *map(jnp.asarray, batch))
    path = str(tmp / "jax_grads.pt")
    torch.save(convert(jax.tree_util.tree_map(np.asarray, st.opt_state)), path)
    return {k: float(v) for k, v in jm.items()}, path


def test_world2_spatial_step_matches_jax_sharded_step(runs):
    _, ranks, (jm, jg), _ = runs
    (m0, g0), (m1, g1) = ranks[2][0]["jax"], ranks[2][1]["jax"]
    assert m0 == m1 and all(W.digest(g0[k]) == g1[k] for k in g0)  # replicas agree
    assert m0["num_pos"] == jm["num_pos"] > 0
    _losses(m0, jm, 1e-5, [k for k in jm if k.startswith("loss_") or k == "total"])
    want = {k: v for k, v in torch.load(jg, weights_only=True).items() if k in g0}
    _check(g0, want, 1e-4, floor=1e-9)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spatial_step_matches_one_process(case, runs):
    one, ranks, _, _ = runs
    name, world = case[:2]
    m1, g1 = one[name]
    m2, g2 = ranks[world][0][name]
    for r in range(1, world):  # every rank takes the same summed step
        mr, gr = ranks[world][r][name]
        assert mr == m2 and all(W.digest(g2[k]) == gr[k] for k in g2)
    assert m2["num_pos"] == m1["num_pos"] > 0
    _losses(m2, m1, 1e-6)
    _check(g2, g1, 1e-5, floor=1e-9)


def test_run_fcos_n_spatial_2_trains_on_two_ranks(runs):
    """``run_fcos --n_spatial 2 --mode train`` (VGG-AF, f32, one step, rank 0
    evaluating on the whole grid and saving) against one process: the
    checkpoints' Adam moments to 1e-4 of their largest entry (floored at
    1e-6 of the largest), the params to 2 lr everywhere and to 1e-5 of their
    largest entry where the gradient is clear of the ranks' f32 rounding
    (``tests/test_torch_dist_train.py`` says why)."""
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    tmp = runs[3]
    two, _ = CheckpointManager(str(tmp / "two")).restore_any()
    one, meta = CheckpointManager(str(tmp / "one")).restore_any()
    assert meta["step"] == two["step"] == one["step"] == 1
    assert (tmp / "two" / "best" / "meta.json").is_file()  # rank 0 evaluated
    o1, o2 = one["opt_state"], two["opt_state"]
    top = {m: max(float(v.abs().max()) for v in o1[m]) for m in ("mu", "nu")}
    for i, name in enumerate(o1["names"]):
        for mom in ("mu", "nu"):
            w, g = o1[mom][i].double(), o2[mom][i].double()
            scale = max(float(w.abs().max()), 1e-6 * top[mom])
            assert float((g - w).abs().max()) <= 1e-4 * scale, (mom, name)
        p1, p2 = one["params"][name].double(), two["params"][name].double()
        grad = o1["mu"][i].double().abs() / 0.1
        d = (p1 - p2).abs()
        assert float(d.max()) <= 2 * 3e-4 * 1.001, name
        sure = (grad > 1e-3 * float(grad.max())) & (grad > 1e-6)
        assert not sure.any() or float(d[sure].max()) <= 1e-5 * float(p1.abs().max()), name


def test_trainer_without_a_process_group_has_no_spatial_axis():
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

    tr = FCOSTrainer(FCOSConfig(n_spatial=2, backbone_type="vgg_AF"), device="cpu")
    assert tr.mesh is None and tr.grid_layout(160) is None


@pytest.mark.parametrize("kind", ["ngp", "ddp_nerf"])
def test_native_density_to_alpha(kind):
    from instance_nerf_tpu.data import native as JN
    from instance_nerf_tpu_torch.data import native as TN

    assert TN.available()
    sigma = np.random.default_rng(0).normal(0, 4, (40, 36, 28)).astype(np.float32)
    sigma[0, 0, :4] = [0.0, -80.0, 80.0, 4.6]
    got = TN.density_to_alpha(sigma, kind)
    assert got.dtype == np.float32 and got.shape == sigma.shape
    np.testing.assert_allclose(got, TN.density_to_alpha_plain(sigma, kind), rtol=0, atol=3e-7)
    np.testing.assert_allclose(got, JN.density_to_alpha(sigma, kind), rtol=0, atol=3e-7)
    assert got.min() >= 0 and got.max() <= 1


def test_native_pad_copy_and_instance_masks():
    from instance_nerf_tpu.data import native as JN
    from instance_nerf_tpu_torch.data import native as TN

    rng = np.random.default_rng(1)
    src = rng.normal(size=(7, 5, 6, 4)).astype(np.float32)
    got = TN.pad_copy(src, (8, 8, 9))
    np.testing.assert_array_equal(got, TN.pad_copy_plain(src, (8, 8, 9)))
    np.testing.assert_array_equal(got, JN.pad_copy(src, (8, 8, 9)))
    grid = rng.integers(0, 6, (9, 7, 5)).astype(np.int64)
    ids = np.array([0, 3, 5, 9], np.int64)
    got = TN.instance_masks(grid, ids)
    assert got.dtype == np.uint8 and got.shape == (4, 9, 7, 5)
    np.testing.assert_array_equal(got, TN.instance_masks_plain(grid, ids))
    np.testing.assert_array_equal(got, JN.instance_masks(grid, ids))


def test_native_build_lands_in_the_port_build_directory():
    import os

    from instance_nerf_tpu_torch.data import native as TN

    assert TN.available()
    path = TN.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == TN.BUILD_DIR
    assert os.sep + "native" + os.sep not in path
