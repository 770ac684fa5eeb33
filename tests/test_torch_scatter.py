"""Parity of the plain versions of kernels B3, B4 (backward) and B5 with the
JAX package's Pallas kernels, run as the JAX package's own tests run them on
the CPU (interpret mode).

Tolerances: the scatter-add sums in another order than the Pallas kernel's
serial walk, so it is held to 1e-5 (2e-4 where ~256 updates collide per
row), as ``tests/test_scatter_pallas.py`` holds the Pallas kernel against
XLA. B5 returns 0/1 values: exact. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.kernels.coarse_occ_pallas import coarse_occ_lookup as j_coarse
from instance_nerf_tpu.kernels.scatter_pallas import (
    ROWS,
    TILE,
    gather_rows_pallas_grad,
    scatter_add_padded,
    scatter_add_pallas,
)
from instance_nerf_tpu_torch.kernels.coarse_occ_cuda import (
    coarse_occ_lookup,
    coarse_occ_lookup_plain,
)
from instance_nerf_tpu_torch.kernels.scatter_cuda import (
    gather_rows_kernel_grad,
    level_scatter_add_plain,
    scatter_add,
    scatter_add_plain,
    scatter_plan,
)
from instance_nerf_tpu_torch.kernels import scatter_cuda

torch.set_num_threads(2)


def _case(seed, n, t, w):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t, n).astype(np.int32)
    upd = rng.normal(size=(n, w)).astype(np.float32)
    return idx, upd


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_plain_matches_pallas_random(replicas):
    idx, upd = _case(0, ROWS * TILE, 1024, 16)
    want = np.asarray(scatter_add_pallas(jnp.asarray(idx), jnp.asarray(upd), 1024,
                                         interpret=True, replicas=replicas))
    got = scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(upd), 1024,
                            replicas=replicas).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_collision_heavy():
    """T = 64: about 256 updates per row."""
    idx, upd = _case(1, ROWS * TILE, 64, 8)
    want = np.asarray(scatter_add_pallas(jnp.asarray(idx), jnp.asarray(upd), 64,
                                         interpret=True))
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_plain_matches_padded_odd_n():
    """N = 1000, not a multiple of the Pallas tiling: no padding contract."""
    idx, upd = _case(2, 1000, 512, 4)
    want = np.asarray(scatter_add_padded(jnp.asarray(idx), jnp.asarray(upd), 512,
                                         interpret=True))
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), 512).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_clamp_lands_in_first_and_last_row():
    """An out-of-range index lands in row 0 or T - 1, as the Pallas kernel's
    clip does (the padded wrapper pads with index 0 / zero rows)."""
    idx = np.array([-5, 0, 3, 7, 8, 1000, -1, 2], np.int32)
    upd = np.arange(16, dtype=np.float32).reshape(8, 2) + 1.0
    want = np.asarray(scatter_add_padded(jnp.asarray(idx), jnp.asarray(upd), 8,
                                         interpret=True))
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], upd[[0, 1, 6]].sum(0))
    np.testing.assert_array_equal(got[7], upd[[3, 4, 5]].sum(0))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("trailing,w", [(8, 2), (1, 32)])
def test_level_gradient_matches_pallas_grad(trailing, w, idx_dtype):
    """B4's backward: the multi-level table gradient of one gather, with the
    hash layout (trailing = 8, W = 2) and the brick layout (trailing = 1,
    W = 32), against ``gather_rows_pallas_grad``'s VJP. Some indices fall
    outside their level: each must stay inside its own level's slab. The
    wrappers take int32 and int64 indices alike."""
    import jax

    rng = np.random.default_rng(3)
    n_levels, t, n = 3, 256, 300
    lvl = np.arange(n_levels)[None, :, None] * t
    local = rng.integers(0, t, (n, n_levels, trailing))
    local[0, :, 0] = -3  # below the level: its row 0
    local[1, :, 0] = t + 9  # above the level: its row T - 1
    flat = (local + lvl).reshape(-1).astype(np.int32)
    table = rng.normal(size=(n_levels * t, w)).astype(np.float32)
    d_rows = rng.normal(size=(flat.shape[0], w)).astype(np.float32)

    _, vjp = jax.vjp(lambda tab: gather_rows_pallas_grad(tab, jnp.asarray(flat), n_levels,
                                                         trailing=trailing), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(d_rows))[0])
    got = level_scatter_add_plain(torch.from_numpy(flat.astype(idx_dtype)),
                                  torch.from_numpy(d_rows), n_levels, trailing, t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # through the autograd Function (its CPU backward is the plain version)
    inside = (np.clip(local, 0, t - 1) + lvl).reshape(-1).astype(np.int32)
    rows_j, vjp = jax.vjp(lambda tab: gather_rows_pallas_grad(
        tab, jnp.asarray(inside), n_levels, trailing=trailing), jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    rows = gather_rows_kernel_grad(tab, torch.from_numpy(inside.astype(idx_dtype)), n_levels,
                                   trailing)
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(rows_j))
    rows.backward(torch.from_numpy(d_rows))
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(vjp(jnp.asarray(d_rows))[0]),
                               rtol=1e-5, atol=1e-5)


def test_b5_plain_matches_pallas():
    """B5 on 4096 points (the Pallas block) inside the grid: exact. The
    Pallas kernel takes cells inside the grid only; the port gives 0 for a
    cell outside it, as the Pallas kernel does where x is outside."""
    rng = np.random.default_rng(4)
    r = 32
    grid = (rng.uniform(size=(r, r, r)) < 0.3).astype(np.float32)
    cells = rng.integers(0, r, (4096, 3)).astype(np.int32)
    cells[:64, 0] = rng.choice([-2, -1, r, r + 3], 64)
    want = np.asarray(j_coarse(jnp.asarray(cells), jnp.asarray(grid), interpret=True))
    got = coarse_occ_lookup(torch.from_numpy(cells), torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:64].any() and 0 < got.sum() < 4096
    outside = cells[64:128].copy()
    outside[:, 1:] = rng.choice([-1, r], (64, 2))
    assert not coarse_occ_lookup_plain(torch.from_numpy(outside),
                                       torch.from_numpy(grid)).any()
    # no block-multiple contract on the port's side
    odd = coarse_occ_lookup_plain(torch.from_numpy(cells[:1001]), torch.from_numpy(grid))
    np.testing.assert_array_equal(odd.numpy(), want[:1001])


def _kernel_cover(n, w, n_levels, trailing, n_sm):
    """How many times ``csrc/scatter_add.cu``'s blocks and threads, under
    the plan, touch each (update, 16-byte chunk of its row): the kernel's
    work split replayed on the host for 16-byte aligned tensors."""
    plan = scatter_plan(n, w, n_levels, trailing, n_sm)
    vec = 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1
    chunks, group = w // vec, n_levels * trailing
    points = -(-n // group)
    slots = scatter_cuda.THREADS // (plan.lanes * trailing)
    per_block = plan.passes * scatter_cuda.RUN * slots
    blocks_per_level = -(-points // per_block)
    hits = np.zeros((n, chunks), np.int64)
    for b in range(n_levels * blocks_per_level):
        lvl = b // blocks_per_level
        p_lo = (b - lvl * blocks_per_level) * per_block
        p_hi = min(points, p_lo + per_block)
        for t in range(scatter_cuda.THREADS):
            c0, rest = t % plan.lanes, t // plan.lanes
            corner, slot = rest % trailing, rest // trailing
            if slot >= slots:
                continue
            first = min(p_hi, p_lo + slot * (per_block // slots))
            u = np.arange(first, min(p_hi, first + per_block // slots)) * group
            u = u + lvl * trailing + corner
            u = u[u < n]
            hits[u[:, None], np.arange(c0, chunks, plan.lanes)[None]] += 1
    return plan, hits


@pytest.mark.parametrize("case", ["hash_layout", "brick_layout_w32", "probe9_w16",
                                  "scalar_w3", "odd_n", "wide_trailing", "several_passes"])
def test_scatter_plan(case):
    """B3's host plan and the kernel's division-free work split: every
    update's every chunk is added by exactly one thread, with up to 8
    threads sharing a row of 16-byte vectors (the brick field's 32 floats:
    8, one float4 each), one thread a row of 2 floats or of an odd width,
    and more runs per thread once the stream outgrows the card."""
    n_sm = 132
    if case == "hash_layout":  # the main field's layout, fewer points
        args, lanes, passes = (4096 * 16 * 8, 2, 16, 8), 1, 1
    elif case == "brick_layout_w32":
        args, lanes, passes = (3000 * 3, 32, 3, 1), 8, 1
    elif case == "probe9_w16":
        args, lanes, passes = (20000, 16, 1, 1), 4, 1
    elif case == "scalar_w3":
        args, lanes, passes = (4099, 3, 1, 1), 1, 1
    elif case == "odd_n":  # N no multiple of L * trailing
        args, lanes, passes = (1001 * 24 - 5, 4, 3, 8), 1, 1
    elif case == "wide_trailing":  # lanes capped by lanes * trailing <= 256
        args, lanes, passes = (500 * 64, 32, 1, 64), 4, 1
    else:
        args, lanes, passes, n_sm = (150000, 2, 1, 1), 1, 9, 2
    plan, hits = _kernel_cover(*args, n_sm)
    assert (plan.lanes, plan.passes) == (lanes, passes)
    assert (hits == 1).all()
    # the main and fast fields' own steps on an H100's 132 SMs
    assert scatter_plan(131072 * 16 * 8, 2, 16, 8) == (1, 1)
    assert scatter_plan(131072 * 3, 32, 3, 1) == (8, 1)


def test_launch_args_are_per_call(monkeypatch):
    """The cached launch arguments are bytes; every launch copies them into
    a struct of its own, so launches from two host threads never write the
    same pointers."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    scatter_cuda._launch_template.cache_clear()
    try:
        tmpl = scatter_cuda._launch_template(131072 * 3, 32, 3, 1, 2 ** 15, 1, 0)
        assert isinstance(tmpl, bytes)
        a = scatter_cuda._LaunchArgs.from_buffer_copy(tmpl)
        b = scatter_cuda._LaunchArgs.from_buffer_copy(tmpl)
        a.idx, a.stream = 4096, 7
        assert b.idx is None and b.stream is None
        assert (b.n, b.w, b.n_levels, b.trailing, b.rows_per_level, b.replicas, b.passes) == (
            131072 * 3, 32, 3, 1, 2 ** 15, 1, scatter_plan(131072 * 3, 32, 3, 1).passes)
        assert scatter_cuda._launch_template(131072 * 3, 32, 3, 1, 2 ** 15, 1, 0) is tmpl
    finally:
        scatter_cuda._launch_template.cache_clear()
