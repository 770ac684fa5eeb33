"""Adaptive-K routing (``k_buckets``) and ``choose_k_buckets`` of the port's
renderer against the JAX package's ``render_rays``, on JAX's jitter draws;
and the renderer's leading scene axis (a fleet) against per-scene calls.

Tolerances: composited outputs to 1e-5 relative and 1e-6 absolute (f32
sums of O(1) terms, as ``test_torch_render.py``); the ladder exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.models import render as JR
from instance_nerf_tpu_torch.models import render as TR

torch.set_num_threads(2)

S = 32


def _rays(seed, n=96):
    """Rays aimed near the cube's center from a sphere of radius 1.5, a few
    of which miss the cube."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 0.5 + 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = np.asarray([0.5, 0.5, 0.5]) - o + 0.15 * rng.normal(size=o.shape)
    d[:5] = -d[:5]  # misses: routed to the cheapest bucket
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _occ(seed, res=16, p=0.3):
    grid = np.where(np.random.default_rng(seed).uniform(size=(res,) * 3) < p, 1e3, 0.0)
    return grid.astype(np.float32)


def _field(seed=5):
    w = np.random.default_rng(seed).normal(size=(3, 9)).astype(np.float32)

    def make(lib, arr):
        wt = arr(w)

        def apply(xyz, vd):
            h = lib.sin(xyz @ wt[:, :3] * 4.0)
            sigma_raw = 3.0 * h[..., 0] + 1.0
            rgb = 0.5 + 0.5 * lib.cos(xyz @ wt[:, 3:6] + vd @ wt[:, 6:9])
            logits = lib.stack([xyz[..., 0], xyz[..., 1], xyz[..., 2], h[..., 1], h[..., 2]], -1)
            return sigma_raw, rgb, logits

        return apply

    return make(jnp, jnp.asarray), make(torch, torch.from_numpy)


LADDERS = [((0.5, 4), (0.25, 8), (0.25, 16)), ((0.625, 2), (0.25, 4), (0.125, 8)),
           ((0.3, 16),)]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("coarse", [None, 8])
@pytest.mark.parametrize("ladder", range(len(LADDERS)))
def test_k_buckets_render_matches_jax(fuse, coarse, ladder):
    buckets = LADDERS[ladder]
    o, d = _rays(1)
    grid = _occ(2, p=0.08 if coarse else 0.3)
    key = jax.random.key(3)
    jf, tf = _field()
    want = JR.render_rays(lambda p, x, v: jf(x, v), None, key, jnp.asarray(o), jnp.asarray(d),
                          n_samples=S, occ=JR.OccupancyGrid(jnp.asarray(grid), 0.01),
                          k_occupied=4, occ_coarse_res=coarse, k_buckets=buckets,
                          fuse_buckets=fuse)
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (o.shape[0], S))))
    got = TR.render_rays(tf, torch.from_numpy(o), torch.from_numpy(d), n_samples=S,
                         occ=TR.OccupancyGrid(torch.from_numpy(grid), 0.01), k_occupied=4,
                         occ_coarse_res=coarse, k_buckets=buckets, fuse_buckets=fuse,
                         jitter=draws)
    for f in JR.RenderOut._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert got.weights.shape == (o.shape[0], max(k for _, k in buckets))
    assert float(got.acc.max()) > 0.1


def test_k_buckets_without_instance_and_with_ties():
    """Without the instance head (logits of width 0) and with every ray's
    hit count tied (an all-occupied grid): the stable sort keeps the
    caller's order within a tie, as ``jnp.argsort`` does."""
    o, d = _rays(4)
    grid = np.full((8, 8, 8), 1e3, np.float32)
    key = jax.random.key(5)
    jf, tf = _field()
    buckets = ((0.5, 4), (0.5, 8))
    want = JR.render_rays(lambda p, x, v: jf(x, v), None, key, jnp.asarray(o), jnp.asarray(d),
                          n_samples=S, occ=JR.OccupancyGrid(jnp.asarray(grid), 0.01),
                          with_instance=False, k_buckets=buckets)
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (o.shape[0], S))))
    got = TR.render_rays(tf, torch.from_numpy(o), torch.from_numpy(d), n_samples=S,
                         occ=TR.OccupancyGrid(torch.from_numpy(grid), 0.01),
                         with_instance=False, k_buckets=buckets, jitter=draws)
    for f in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert got.instance_logits.shape == (o.shape[0], 0)


@pytest.mark.parametrize("quant", [16, 4])
def test_choose_k_buckets_equals_jax(quant):
    rng = np.random.default_rng(6)
    for hits in (rng.integers(0, 12, 500), rng.poisson(1.5, 997), np.zeros(7),
                 np.full(33, 9.0), rng.integers(0, 5, 64).astype(np.float32)):
        for ks in ((2, 4, 8), (4, 16), (8,)):
            assert TR.choose_k_buckets(hits, ks, quant) == JR.choose_k_buckets(hits, ks, quant)
    with pytest.raises(ValueError, match="non-empty"):
        TR.choose_k_buckets(np.zeros(0))


@pytest.mark.parametrize("buckets", [None, ((0.5, 4), (0.5, 8))])
def test_scene_axis_equals_per_scene_renders(buckets):
    """A fleet's batched render (rays (B, R, 3), grids (B, G, G, G), coarse
    selection) equals B single-scene renders on the same draws."""
    b, r = 3, 48
    rays = [_rays(10 + i, r) for i in range(b)]
    grids = np.stack([_occ(20 + i, p=0.05) for i in range(b)])
    draws = torch.rand((b, r, S), generator=torch.Generator().manual_seed(7))
    _, tf = _field()
    o = torch.from_numpy(np.stack([x[0] for x in rays]))
    d = torch.from_numpy(np.stack([x[1] for x in rays]))
    kw = dict(n_samples=S, k_occupied=8, occ_coarse_res=8, k_buckets=buckets)
    got = TR.render_rays(tf, o, d, occ=TR.OccupancyGrid(torch.from_numpy(grids), 0.01),
                         jitter=draws, **kw)
    for i in range(b):
        want = TR.render_rays(tf, o[i], d[i], occ=TR.OccupancyGrid(torch.from_numpy(grids[i]),
                                                                    0.01),
                              jitter=draws[i], **kw)
        for f in TR.RenderOut._fields:
            np.testing.assert_allclose(getattr(got, f)[i].numpy(), getattr(want, f).numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
