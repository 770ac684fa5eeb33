"""The port's mesh (``parallel/mesh.py``) against the JAX package's on the 8
virtual CPU devices: ``data_axis_size``, the ``(dcn, data, sp)`` order of
the ranks, each rank's ``local_rows`` against the addressable shard of JAX
``shard_batch`` on the device of the same index, an idle rank's share;
``PrefetchLoader``; and the max pool of deterministic mode, which the chip
check's bitwise comparison of a launched rank with one process trains
through. No process group here: ``Mesh`` is built for each rank
of a world of 8 without one, and the collectives are the identity.
"""
import logging

import numpy as np
import pytest
import torch

from instance_nerf_tpu.parallel import mesh as JM
from instance_nerf_tpu_torch.data.prefetch import PrefetchLoader
from instance_nerf_tpu_torch.parallel import mesh as TM

LAYOUTS = [(1, 8, 1), (1, 4, 2), (1, 2, 4), (2, 2, 2), (2, 4, 1), (1, 1, 8), (2, 1, 4)]


@pytest.mark.parametrize("devices", range(1, 9))
def test_data_axis_size_matches_jax(devices, caplog):
    for batch in range(1, 13):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            want = JM.data_axis_size(batch, devices)
            j_warned = bool(caplog.records)
            caplog.clear()
            got = TM.data_axis_size(batch, devices)
            assert got == want, (batch, devices)
            assert bool(caplog.records) == j_warned


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: "x".join(map(str, x)))
def test_rank_coordinates_match_jax_device_order(layout):
    n_dcn, n_data, n_sp = layout
    jmesh = JM.make_mesh(n_data=n_data, n_spatial=n_sp, n_dcn=n_dcn)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(8):
        m = TM.Mesh(n_dcn, n_data, n_sp, rank=r, world=8)
        assert m.active and ids[m.coord] == r
        assert m.data_index == m.coord[0] * n_data + m.coord[1]


def _tree():
    rng = np.random.default_rng(0)
    return {"grids": rng.normal(size=(8, 8, 4, 4, 2)).astype(np.float32),
            "sizes": rng.normal(size=(8, 3)).astype(np.float32),
            "ids": np.arange(8, dtype=np.int32),
            "odd": np.arange(3, dtype=np.float32),
            "scalar": np.float32(2.5)}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: "x".join(map(str, x)))
def test_local_rows_match_jax_shard_batch(layout):
    n_dcn, n_data, n_sp = layout
    jmesh = JM.make_mesh(n_data=n_data, n_spatial=n_sp, n_dcn=n_dcn)
    tree = _tree()
    sharded = JM.shard_batch(jmesh, tree)
    for r in range(8):
        local = TM.local_rows(TM.Mesh(n_dcn, n_data, n_sp, rank=r, world=8), tree)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards if s.device.id == r)
            np.testing.assert_array_equal(np.asarray(local[k]), np.asarray(shard.data),
                                          err_msg=f"{layout} rank {r} {k}")


def test_idle_ranks_and_shards():
    """A layout of fewer ranks than the world leaves the rest idle: no rows
    from ``local_rows``, row 0 with weight 0 from ``shard``; the active
    ranks split a batch in contiguous blocks, torch tensors too."""
    idle = TM.Mesh(1, 1, 1, rank=1, world=2)
    assert not idle.active and idle.shard(3) == TM.Shard(3, 0, 1, 0.0)
    assert TM.local_rows(idle, {"x": np.zeros((3, 2))})["x"].shape == (0, 2)
    x = torch.arange(12.0).reshape(4, 3)
    for r in range(2):
        m = TM.Mesh(1, 2, 1, rank=r, world=2)
        sh = m.shard(4)
        assert (sh.lo, sh.hi, sh.weight) == (2 * r, 2 * r + 2, 1.0)
        assert torch.equal(TM.local_rows(m, x), x[2 * r:2 * r + 2])
        assert torch.equal(sh.take(x), x[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not divide"):
        TM.Mesh(1, 2, 1).shard(3)


def test_one_process_is_the_identity():
    """No process group: a mesh of one on the CPU, sums and all-reduces that
    return their inputs, and a layout of more ranks raises as JAX's does."""
    m = TM.make_mesh(device="cpu")
    assert (m.world, m.used, m.device.type, m.data_group) == (1, 1, "cpu", None)
    ts = [torch.randn(3), torch.randn(2, 2)]
    assert all(a is b for a, b in zip(TM.all_reduce_sum(ts), ts))
    assert torch.equal(TM.forward_sum(ts[0]), ts[0])
    assert TM.batch_shard(m, 4) is None and TM.is_main()
    gen = torch.Generator().manual_seed(3)
    want = torch.rand((4, 2, 5), generator=torch.Generator().manual_seed(3))
    assert torch.equal(TM.Shard(4, 1, 3).rand((2, 5), gen), want[1:3])
    with pytest.raises(ValueError, match="needs 2 devices"):
        TM.make_mesh(n_data=2, device="cpu")


@pytest.mark.parametrize("numels,limit,want", [
    ([3, 4, 1], 8, [[0, 1, 2]]),
    ([3, 4, 2], 8, [[0, 1], [2]]),
    ([9, 1, 8, 8], 8, [[0], [1], [2], [3]]),
    ([2, 9, 2, 2], 8, [[0], [1], [2, 3]]),
    ([], 8, []),
])
def test_all_reduce_buckets(numels, limit, want):
    """``all_reduce_sum``'s buckets: consecutive tensors up to the limit, a
    larger one alone."""
    assert TM.buckets(numels, limit) == want
    assert TM.buckets(numels) == ([list(range(len(numels)))] if numels else [])


def test_prefetch_loader_reraises():
    """Batches arrive in order; an error in ``make_batch`` is raised in the
    consumer after the batches before it (as the JAX loader's test holds)."""
    def make(i):
        if i == 3:
            raise RuntimeError("boom")
        return i

    seen = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in PrefetchLoader(make, 5, lookahead=2):
            seen.append(b)
    assert seen == [0, 1, 2]
    assert list(PrefetchLoader(lambda i: i * i, 4)) == [0, 1, 4, 9]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deterministic_max_pool_matches_the_pool(dtype):
    """The max pool of deterministic mode (``layers._max_pool_by_views``, the
    card's overlapping-window pool whose CUDA backward adds with atomics)
    equals ``F.max_pool3d`` forward and backward, ties included (each window
    hands its gradient to its first maximum)."""
    import torch.nn.functional as F

    from instance_nerf_tpu_torch.models.layers import _max_pool_by_views

    x = torch.round(torch.randn((2, 3, 9, 8, 7), generator=torch.Generator().manual_seed(0))
                    * 2) / 2
    a, b = (x.to(dtype).clone().requires_grad_() for _ in range(2))
    ya, yb = F.max_pool3d(a, 3, 2), _max_pool_by_views(b, 3, 2)
    g = torch.randn(ya.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(ya, yb) and torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("rotated", [False, True], ids=["aabb", "obb"])
def test_rank_rows_take_the_whole_batchs_draws(rotated, tmp_path):
    """``RPNDataset.batch(rows=)``, a rank's share of an augmented batch:
    its rows equal the whole batch's (flip, rot90 and, with OBB boxes, the
    rotate-and-scale draws) and its generator stays in step for the next
    batch, the other rows' draws taken without loading them."""
    from instance_nerf_tpu_torch.data.datasets import RPNDataset
    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path), num_scenes=4, grid_size=(16, 16, 12), style="room" if rotated
                  else "boxes", rotated=rotated)
    boxes = tmp_path / ("boxes_obb" if rotated else "metadata")

    def ds():
        return RPNDataset(features_path=str(tmp_path / "features"), boxes_path=str(boxes),
                          flip_prob=0.5, rotate_prob=0.5, rot_scale_prob=0.5, seed=3)

    whole, rank = ds(), ds()
    box_dim = 7 if rotated else 6
    for idx in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
        full = whole.batch(idx, (16, 16, 16), box_dim=box_dim, augment=True)
        part = rank.batch(idx, (16, 16, 16), box_dim=box_dim, augment=True, rows=(1, 3))
        for f in ("grids", "grid_sizes", "gt_boxes", "gt_mask"):
            np.testing.assert_array_equal(getattr(part, f), getattr(full, f)[1:3], err_msg=f)
    assert whole.rng.random() == rank.rng.random()
