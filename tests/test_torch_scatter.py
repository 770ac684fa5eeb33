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
)

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


@pytest.mark.parametrize("trailing,w", [(8, 2), (1, 32)])
def test_level_gradient_matches_pallas_grad(trailing, w):
    """B4's backward: the multi-level table gradient of one gather, with the
    hash layout (trailing = 8, W = 2) and the brick layout (trailing = 1,
    W = 32), against ``gather_rows_pallas_grad``'s VJP. Some indices fall
    outside their level: each must stay inside its own level's slab."""
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
    got = level_scatter_add_plain(torch.from_numpy(flat), torch.from_numpy(d_rows), n_levels,
                                  trailing, t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # through the autograd Function (its CPU backward is the plain version)
    inside = (np.clip(local, 0, t - 1) + lvl).reshape(-1).astype(np.int32)
    rows_j, vjp = jax.vjp(lambda tab: gather_rows_pallas_grad(
        tab, jnp.asarray(inside), n_levels, trailing=trailing), jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    rows = gather_rows_kernel_grad(tab, torch.from_numpy(inside), n_levels, trailing)
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
