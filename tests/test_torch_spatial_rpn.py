"""The anchor-RPN train step on the mesh's spatial axis: each scene's W split
over ``sp`` ranks (halos in the backbone and the head's k3 convs, each
rank's anchors in global voxel coordinates), the targets taken over the
whole scene (a gt's best anchor quality the MAX over the ranks, the
balanced sampler on the labels gathered from every rank). Ranks are
processes of ``tests/dist_worker.py`` (gloo, a ``file://`` store, one
thread each), one launch a world size; the JAX side runs here meanwhile.

- A world-2 ``sp = 2`` f32 rotated RPN step with the 2D projection loss, on
  the toy Swin of ``tests/test_torch_dist_train.py`` and its inputs (the
  port given the JAX key's uniforms), equals the JAX step sharded over
  ``make_mesh(n_data=1, n_spatial=2)``: losses 1e-5, gradients 1e-4 of
  their largest entry.
- In f64, world-2 steps at W = 40 (levels 10, 5, 3, 2 split unevenly) and
  world-4 steps at W = 48 (levels 12, 6, 3, 2: ranks without rows from the
  second level on, two of them at the stride-32 level), VGG-AF and ResNet,
  AABB and OBB, smooth-L1 and GIoU, with and without the projection loss,
  ``data 2 x sp 2``, equal the port's one-process step on the trainer's
  seeded draws: losses 1e-6, gradients 1e-5 of their largest entry (both
  sides keep the gradient in f32), and the labels and the sampled positive
  and negative masks, the ranks' columns put back in the scene's anchor
  order, exactly equal.
- Edge cases: a gt whose best anchors tie across the rank boundary (both
  matched), a scene with no gt, a rank with no positives.
- ``grid_anchors`` of a rank's rows, the anchor cache over layouts of one
  local shape, the padding mask at a rank boundary; ``gather_over`` and
  ``max_over`` on uneven and empty blocks, and raising off the group;
  ``RPNTrainer.grid_layout`` raising where ``sp`` does not divide W;
  ``RPNTrainer.train_loop`` on an ``sp = 2`` mesh against one process.
"""
import numpy as np
import pytest
import torch

from instance_nerf_tpu.parallel.mesh import make_mesh
from instance_nerf_tpu_torch.models import rpn as TR
from instance_nerf_tpu_torch.parallel import spatial as SP
from tests import dist_worker as W
from tests.test_torch_dist_train import SWIN, _check, _inputs, _losses
from tests.test_torch_spatial import RESNET, _batch

torch.set_num_threads(2)

SHAPES = {2: (40, 16, 16), 4: (48, 16, 16)}
TIE_GT = [14.0, 4.0, 4.0, 22.0, 12.0, 12.0]  # about x = 18: anchors at 16 and 20 tie
# (name, world, n_spatial, backbone, obb, batch kind, other config)
CASES = [("vgg_AF_obb_proj2d", 2, 2, "vgg_AF", True, "spread", {}),
         ("resnet_aabb", 2, 2, "resnet", False, "spread", dict(proj2d_loss_weight=0.0)),
         ("vgg_AF_obb_giou", 2, 2, "vgg_AF", True, "spread",
          dict(reg_loss_type="giou", proj2d_loss_weight=0.0)),
         ("tie_and_empty_scene", 2, 2, "vgg_AF", False, "tie", {}),
         ("rank1_no_positives", 2, 2, "vgg_AF", True, "low_x", {}),
         ("vgg_AF_obb_w4", 4, 4, "vgg_AF", True, "spread", {}),
         ("data2_sp2_resnet", 4, 2, "resnet", False, "spread", {})]


def _rpn_batch(kind, world, seed, obb):
    """Two scenes at ``SHAPES[world]``: ``spread``, four gt along W (one
    masked, ``tests/test_torch_spatial.py``'s); ``tie``, one gt centred
    between rank 0's last and rank 1's first stride-4 row and a second scene
    with none; ``low_x``, small gt in rank 0's rows only."""
    g, sizes, gt, mask = _batch(SHAPES[world], seed, obb)
    if kind == "tie":
        gt[:] = np.asarray(TIE_GT, np.float32)
        mask[:] = False
        mask[0, 0] = True
    elif kind == "low_x":
        rng = np.random.default_rng(seed)
        lo = np.stack([rng.uniform(1, 5, (2, 4)), rng.uniform(1, 6, (2, 4)),
                       rng.uniform(1, 5, (2, 4))], -1)
        box = np.concatenate([lo, lo + rng.uniform(4, 8, (2, 4, 3))], -1)
        if obb:
            box = np.concatenate([(box[..., :3] + box[..., 3:]) / 2, box[..., 3:] - box[..., :3],
                                  rng.uniform(-1.2, 1.2, (2, 4, 1))], -1)
        gt = box.astype(np.float32)
    return g, sizes, gt, mask


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch a world size (2 and 4) on its cases, the one-process side
    in two processes of its own, and meanwhile the JAX sharded step here.
    What they wrote goes at the module's end."""
    import shutil

    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    tmp = tmp_path_factory.mktemp("inputs")
    dirs = [tmp]
    cases = {2: [], 4: []}
    one = [[], []]
    for i, (name, world, n_sp, bb, obb, kind, other) in enumerate(CASES):
        cfg = dict(dtype="float32", rotated_bbox=obb, resolution=32, backbone_type=bb,
                   batch_size=2, batch_size_per_mesh=64, conv_depth=2, **other)
        base = dict(kind="rpn", cfg=cfg, params=None, batch=_rpn_batch(kind, world, i, obb),
                    dtype="float64", update=False, grads_dtype="float32", record=True,
                    **({"resnet": RESNET} if bb == "resnet" else {}))
        cases[world].append((name, "detector_step", dict(base, n_spatial=n_sp)))
        one[i % 2].append((name, "detector_step", base))
    jax_parts, _, cfg, params, batch, u = _inputs("rpn_obb", tmp)
    for dtype in ("float32", "float64"):
        cases[2].append((f"jax/{dtype}", "detector_step",
                         dict(kind="rpn", params=params, swin=SWIN, batch=batch, uniforms=u,
                              cfg=dict(cfg, batch_size=2), n_spatial=2, dtype=dtype)))
    data = tmp / "data"
    write_dataset(str(data), num_scenes=2, grid_size=(32, 32, 24))
    loop = dict(cfg=dict(features_path=f"{data}/features", boxes_path=f"{data}/metadata",
                         resolution=32, batch_size=2, num_epochs=1, backbone_type="vgg_AF",
                         dtype="float32", conv_depth=2))
    cases[2].append(("loop", "rpn_train_loop", dict(loop, n_spatial=2)))
    one[1].append(("loop", "rpn_train_loop", loop))
    for world in cases:
        cases[world].append(("collectives", "spatial_collectives", {}))
    dirs += [tmp_path_factory.mktemp(f"w{world}") for world in cases]
    dirs += [tmp_path_factory.mktemp(f"one{j}") for j in range(len(one))]
    started = {world: W.start(d, world, c) for d, (world, c) in zip(dirs[1:], cases.items())}
    ones = [W.start_one(d, c) for d, c in zip(dirs[1 + len(cases):], one)]
    jax_side = _jax_step(jax_parts, batch)
    one_res = [o.wait(timeout=300)[0] for o in ones]
    yield ({name: one_res[j][name] for j, c in enumerate(one) for name, _, _ in c},
           {world: r.wait(timeout=300) for world, r in started.items()}, jax_side)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _jax_step(jax_parts, batch):
    """The JAX rotated RPN step sharded over ``make_mesh(n_data=1,
    n_spatial=2)`` (the grids' W on ``sp``), its gradient kept by
    ``capture``: (metrics, the gradients in the port's names)."""
    import jax
    import jax.numpy as jnp

    from instance_nerf_tpu.parallel import train_step as JS
    from tests.test_torch_train_step import capture

    jt, params, key, convert = jax_parts
    step = JS.make_rpn_train_step(jt.model, capture(), jt.cfg,
                                  mesh=make_mesh(n_data=1, n_spatial=2))
    (_, jgrads, _), jm = step((params, capture().init(params), 0), key,
                              *map(jnp.asarray, batch))
    return ({k: float(v) for k, v in jm.items()},
            convert(jax.tree_util.tree_map(np.asarray, jgrads)))


def _scene_order(records, key, n_spatial):
    """The ranks' ``key`` (N_local, R_local) put back into each scene's
    anchor order: per data group, level by level, the ``sp`` ranks' rows of
    that level in rank order; the data groups' scenes stacked."""
    groups = [records[d:d + n_spatial] for d in range(0, len(records), n_spatial)]
    out = []
    for grp in groups:
        levels = len(grp[0]["level_counts"])
        cols = []
        for lvl in range(levels):
            for rec in grp:
                c = rec["level_counts"]
                a = sum(c[:lvl])
                cols.append(rec[key][:, a:a + c[lvl]])
        out.append(torch.cat(cols, 1))
    return torch.cat(out, 0)


def _case(runs, name):
    one, ranks, _ = runs
    world, n_sp = next((c[1], c[2]) for c in CASES if c[0] == name)
    return one[name], [ranks[world][r][name] for r in range(world)], n_sp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_world2_spatial_rpn_step_matches_jax_sharded_step(dtype, runs):
    """The losses in f32 and f64, the gradients in f64: in f32 the ranks'
    convs on their halo'd blocks round otherwise than one process's convs
    on the whole grid, and an activation within that rounding of 0 flips a
    ReLU of the head's tower (rank 0's ``conv_2`` output gradient moves by
    0.011 of 0.039 at one element, its weight gradient by 5%), as the VGG
    trunk's do in ``tests/test_torch_train_step.py``."""
    _, ranks, (jm, jg) = runs
    (m0, g0), (m1, g1) = ranks[2][0][f"jax/{dtype}"], ranks[2][1][f"jax/{dtype}"]
    assert m0 == m1 and all(W.digest(g0[k]) == g1[k] for k in g0)  # replicas agree
    assert set(jm) == {"loss_objectness", "loss_rpn_box_reg", "loss_rpn_box_reg_2d", "total"}
    _losses(m0, jm, 1e-5)
    if dtype == "float64":
        _check(g0, {k: v for k, v in jg.items() if k in g0}, 1e-4, floor=1e-9)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_spatial_rpn_step_matches_one_process(name, runs):
    (m1, g1, _), ranks, _ = _case(runs, name)
    m2, g2, _ = ranks[0]
    for mr, gr, _ in ranks[1:]:  # every rank takes the same summed step
        assert mr == m2 and all(W.digest(g2[k]) == gr[k] for k in g2)
    _losses(m2, m1, 1e-6)
    _check(g2, g1, 1e-5, floor=1e-9)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_spatial_rpn_samples_equal_one_process(name, runs):
    (_, _, s1), ranks, n_sp = _case(runs, name)
    records = [r[2] for r in ranks]
    assert sum(records[0]["level_counts"][:1]) < sum(s1["level_counts"][:1])
    for key in ("labels", "pos", "neg"):
        assert torch.equal(_scene_order(records, key, n_sp), s1[key]), key
    assert int(s1["pos"].sum()) > 0 and int(s1["neg"].sum()) > 0


def test_tie_across_the_rank_boundary_matches_every_tied_anchor(runs):
    """The gt's best quality (0.6) is reached by one stride-4 anchor on
    each rank; both are positive (the IoU is below the 0.7 threshold, so
    only the low-quality match makes them so) and sampled."""
    (_, _, s1), ranks, _ = _case(runs, "tie_and_empty_scene")
    anchors = np.concatenate(TR.AnchorGenerator3D().grid_anchors(
        [(10, 4, 4), (5, 2, 2), (3, 1, 1), (2, 1, 1)], [(s,) * 3 for s in (4, 8, 16, 32)]))
    assert len(anchors) == sum(s1["level_counts"])
    tied = [int(np.flatnonzero((anchors == np.asarray(b, np.float32)).all(1))[0])
            for b in ([12, 4, 4, 20, 12, 12], [16, 4, 4, 24, 12, 12])]
    assert tied[0] < 5 * 16 * 13 <= tied[1]  # rank 0's stride-4 rows are 0-4
    assert (s1["labels"][0, tied] == 1).all() and s1["pos"][0, tied].all()
    assert int((s1["labels"][0] == 1).sum()) == 2
    for rec in (r[2] for r in ranks):  # one of them on each rank
        assert int((rec["labels"][0] == 1).sum()) == 1 and int(rec["pos"][0].sum()) == 1


def test_scene_without_gt_is_background(runs):
    (_, _, s1), ranks, _ = _case(runs, "tie_and_empty_scene")
    assert not (s1["labels"][1] == 1).any() and not s1["pos"][1].any()
    assert int(s1["neg"][1].sum()) == 64
    assert all(not (r[2]["labels"][1] == 1).any() for r in ranks)


def test_rank_without_positives(runs):
    (m1, _, _), ranks, _ = _case(runs, "rank1_no_positives")
    r0, r1 = ranks[0][2], ranks[1][2]
    assert int(r0["pos"].sum()) > 0 and not (r1["labels"] == 1).any()
    assert not r1["pos"].any() and int(r1["neg"].sum()) > 0
    assert m1["loss_rpn_box_reg"] > 0 and m1["loss_rpn_box_reg_2d"] > 0


def test_rpn_train_loop_on_sp2_matches_one_process(runs):
    """One step of ``train_loop`` (one epoch of 2 scenes, VGG-AF, in f64:
    in f32 the trunk's ReLUs flip at the ranks' rounding) on ``sp = 2``:
    Adam's first moments to 1e-4 of their largest entry (floored at 1e-6 of
    the largest tensor's), the params to 2 lr everywhere and to 1e-5 of
    their largest entry where the gradient is clear of the f32 rounding of
    the ranks' gradient all-reduce, as ``tests/test_torch_spatial.py``'s
    CLI case."""
    one, ranks, _ = runs
    p1, mu1 = one["loop"]
    p2, mu2 = ranks[2][0]["loop"]
    top = max(float(v.abs().max()) for v in mu1.values())
    for name, w in mu1.items():
        scale = max(float(w.abs().max()), 1e-6 * top)
        assert float((mu2[name].double() - w.double()).abs().max()) <= 1e-4 * scale, name
        a, b = p1[name].double(), p2[name].double()
        d = (a - b).abs()
        assert float(d.max()) <= 2 * 3e-4 * 1.001, name
        grad = w.double().abs() / 0.1
        sure = (grad > 1e-3 * float(grad.max())) & (grad > 1e-6)
        assert not sure.any() or float(d[sure].max()) <= 1e-5 * float(a.abs().max()), name


@pytest.mark.parametrize("world", [2, 4])
def test_gather_over_and_max_over(world, runs):
    _, ranks, _ = runs
    blocks = [torch.arange(2 * n * 3, dtype=torch.float64).reshape(2, n, 3) + 100 * q
              for q, n in enumerate(W.BLOCKS[:world])]
    want = torch.cat(blocks, 1)
    for r in range(world):
        got = ranks[world][r]["collectives"]
        assert torch.equal(got["gathered"], want)
        assert torch.equal(got["gathered_int8"], want.to(torch.int8))
        assert got["max"].tolist() == [world - 1, 0, 3.0 if world > 1 else 0.0]
        assert got["other_rank_raised"] and got["uneven_raised"]
        assert got["layout"] == (48 * world, world, r)


def test_collectives_raise_without_a_group():
    x = torch.zeros(3)
    with pytest.raises(RuntimeError):
        SP.max_over(x, SP.WLayout(8, 2, 0))
    with pytest.raises(RuntimeError):
        SP.gather_over(x, SP.WLayout(8, 2, 1), 0, [2, 3])


@pytest.mark.parametrize("size,parts", [(10, 2), (12, 4), (2, 4), (5, 4)])
def test_grid_anchors_of_a_rank_are_its_rows_of_the_global_anchors(size, parts):
    gen = TR.AnchorGenerator3D()
    shapes, strides = [(size, 3, 2), (size, 2, 2)], [(4,) * 3, (8,) * 3]
    whole = gen.grid_anchors(shapes, strides)
    lay = SP.WLayout(size, parts, 0)
    for q, (lo, hi) in enumerate(lay.owned):
        mine = gen.grid_anchors([(hi - lo, *s[1:]) for s in shapes], strides, [lo, lo])
        for lvl, s in enumerate(shapes):
            row = s[1] * s[2] * 13
            np.testing.assert_array_equal(mine[lvl], whole[lvl][lo * row:hi * row])


class _Trunk(torch.nn.Module):
    def forward(self, x, layout=None):
        raise AssertionError("not called")


def test_anchor_cache_keeps_layouts_of_one_local_shape_apart():
    """At W = 224 over 4 ranks the stride-4 level has 14 rows on every
    rank: the same local shapes, other rows."""
    model = TR.NeRFRegionProposalNetwork(_Trunk(), out_channels=8)
    feats = [torch.zeros(1, w, 3, 2, 8) for w in (14, 7, 4, 2)]  # rank 0's and rank 1's
    lays = [SP.WLayout(224 // 4 // s, 4, 0) for s in (1, 2, 4, 8)]
    first = model.anchors(feats, lays)
    second = model.anchors(feats, [lay._replace(index=1) for lay in lays])
    assert not torch.equal(first[0], second[0])
    assert float(second[0][:, 0].min() - first[0][:, 0].min()) == 14 * 4
    assert len(model._anchors) == 2
    assert torch.equal(model.anchors(feats)[0], first[0])  # rank 0's rows start at 0


@pytest.mark.parametrize("scene_w", [50, 32])
def test_anchor_padding_mask_at_a_rank_boundary(scene_w):
    """The padding mask of a rank's anchors is its columns of the whole
    grid's: scene W 50 ends inside rank 1's stride-4 rows, 32 at the split."""
    gen = TR.AnchorGenerator3D()
    shapes, strides = [(16, 2, 2), (8, 1, 1)], [4, 8]
    whole = [torch.from_numpy(a) for a in gen.grid_anchors(shapes, [(s,) * 3 for s in strides])]
    sizes = torch.tensor([[scene_w, 8.0, 8.0]])
    full = TR.anchor_padding_mask(whole, sizes, strides)
    parts = []
    for lo, hi in ((0, 8), (8, 16)):
        mine = gen.grid_anchors([(hi - lo, 2, 2), ((hi - lo) // 2, 1, 1)],
                                [(s,) * 3 for s in strides], [lo, lo // 2])
        parts.append(TR.anchor_padding_mask([torch.from_numpy(a) for a in mine], sizes,
                                            strides))
    n0 = [8 * 4 * 13, 4 * 13]
    glued = torch.cat([parts[0][:, :n0[0]], parts[1][:, :n0[0]],
                       parts[0][:, n0[0]:], parts[1][:, n0[0]:]], 1)
    assert torch.equal(glued, full)
    assert bool(parts[1].any()) == (scene_w > 32)


def test_flatten_head_outputs_keeps_empty_levels():
    logits = [torch.zeros(2, 3, 2, 2, 13), torch.zeros(2, 0, 1, 1, 13)]
    deltas = [torch.zeros(2, 3, 2, 2, 13, 8), torch.zeros(2, 0, 1, 1, 13, 8)]
    obj, reg = TR.flatten_head_outputs(logits, deltas)
    assert obj.shape == (2, 3 * 4 * 13) and reg.shape == (2, 3 * 4 * 13, 8)


def test_rpn_has_no_spatial_option():
    """The JAX RPN trainer builds a data-only mesh: no config field and no
    CLI flag name a spatial axis."""
    from instance_nerf_tpu_torch.cli import run_rpn
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig

    assert not hasattr(RPNConfig(), "n_spatial")
    with pytest.raises(SystemExit):
        run_rpn.main(["--mode", "train", "--device", "cpu", "--n_spatial", "2"])
