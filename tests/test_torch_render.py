"""Parity of the port's renderer (``models/render.py``) and synthetic scene
(``data/nerf_dataset.py``) with the JAX package. JAX's random draws are
passed to the port (threefry streams cannot be reproduced in torch).
Discrete outputs (occupancy, compacted sample ids, instance masks) must be
equal; floats to f32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.data import nerf_dataset as JD
from instance_nerf_tpu.models import render as JR
from instance_nerf_tpu_torch.data import nerf_dataset as TD
from instance_nerf_tpu_torch.models import render as TR

torch.set_num_threads(2)


def _rays(seed, n=64):
    """Rays from a sphere of radius 1.5 aimed near the cube's center, plus
    a few that miss the cube."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 0.5 + 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = np.asarray([0.5, 0.5, 0.5]) - o + 0.1 * rng.normal(size=o.shape)
    d[:4] = -d[:4]  # pointing away: misses
    d[4, :] = [0.0, 0.0, -1.0]  # axis-aligned: the eps guard
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _occ(seed, res=16, p=0.5):
    grid = np.where(np.random.default_rng(seed).uniform(size=(res,) * 3) < p, 1e3, 0.0)
    return grid.astype(np.float32)


def test_ray_aabb_and_camera_rays():
    o, d = _rays(0)
    jn, jf = JR.ray_aabb(jnp.asarray(o), jnp.asarray(d))
    tn, tf = TR.ray_aabb(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal((tf > tn).numpy(), np.asarray(jf > jn))
    assert not bool((tf > tn)[:4].any())

    c2w = JD.look_at_pose([1.8, 0.2, 1.3]).astype(np.float32)
    np.testing.assert_allclose(TD.look_at_pose([1.8, 0.2, 1.3]), JD.look_at_pose([1.8, 0.2, 1.3]))
    intr = (40.0, 41.0, 15.5, 12.0)
    jo, jd = JR.camera_rays(jnp.asarray(c2w), intr, (24, 32))
    to, td = TR.camera_rays(torch.from_numpy(c2w), intr, (24, 32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_occupied_and_coarse_occupancy():
    grid = _occ(1, res=64, p=0.001)
    xyz = np.random.default_rng(2).uniform(-0.1, 1.1, (500, 7, 3)).astype(np.float32)
    xyz[0, 0] = [1.0, 0.5, 0.999999]
    j_occ = JR.OccupancyGrid(jnp.asarray(grid), 0.01)
    t_occ = TR.OccupancyGrid(torch.from_numpy(grid), 0.01)
    np.testing.assert_array_equal(t_occ.occupied(torch.from_numpy(xyz)).numpy(),
                                  np.asarray(j_occ.occupied(jnp.asarray(xyz))))
    for cr in (8, 16):
        want = np.asarray(JR.coarse_occupancy_mxu(j_occ, jnp.asarray(xyz), cr))
        got = TR.coarse_occupancy_mxu(t_occ, torch.from_numpy(xyz), cr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("per_ray", [False, True])
def test_sample_points_with_jax_draws(per_ray):
    o, d = _rays(3)
    near, far = JR.ray_aabb(jnp.asarray(o), jnp.asarray(d))
    far = jnp.maximum(far, near + 1e-4)
    key = jax.random.key(7)
    s = 49  # not a power of two: the bin edges must match jnp.linspace bit for bit
    jxyz, jt, jdt = JR.sample_points(key, jnp.asarray(o), jnp.asarray(d), s, near, far,
                                     per_ray_jitter=per_ray)
    draws = np.asarray(jax.random.uniform(key, (64, 1) if per_ray else (64, s)))
    txyz, tt, tdt = TR.sample_points(torch.from_numpy(o), torch.from_numpy(d), s,
                                     torch.tensor(np.asarray(near)),
                                     torch.tensor(np.asarray(far)),
                                     per_ray_jitter=per_ray, jitter=torch.from_numpy(draws))
    # XLA fuses near + tt * span into one rounding: t to an ulp
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=3e-7, atol=0)
    np.testing.assert_array_equal(tdt.numpy(), np.asarray(jdt))
    np.testing.assert_allclose(txyz.numpy(), np.asarray(jxyz), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TR.bin_edges(s, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, s + 1)))


def test_composite_with_instance_logits():
    rng = np.random.default_rng(4)
    r, s, i = 32, 24, 5
    sigma_raw = rng.normal(1.0, 2.0, (r, s)).astype(np.float32)
    rgb = rng.uniform(size=(r, s, 3)).astype(np.float32)
    logits = rng.normal(size=(r, s, i)).astype(np.float32)
    t = np.sort(rng.uniform(0.5, 2.0, (r, s)), axis=1).astype(np.float32)
    dt = np.full((r, s), 0.06, np.float32)
    occ = (rng.uniform(size=(r, s)) < 0.7).astype(np.float32)
    valid = (rng.uniform(size=r) < 0.9).astype(np.float32)
    want = JR.composite(*map(jnp.asarray, (sigma_raw, rgb, logits, t, dt, occ, valid)))
    got = TR.composite(*map(torch.from_numpy, (sigma_raw, rgb, logits, t, dt, occ, valid)))
    for f in JR.RenderOut._fields:  # sums of O(1) terms: atol 1e-5
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    none = TR.composite(*map(torch.from_numpy, (sigma_raw, rgb)), None,
                        *map(torch.from_numpy, (t, dt)))
    assert none.instance_logits.shape == (r, 0)


def _field(seed=5):
    """A small analytic field, the same in both packages: density and color
    from fixed trig features, instance logits from the position."""
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


@pytest.mark.parametrize("coarse,p", [(None, 0.3), (8, 0.08)])
def test_fixed_k_render_rays(coarse, p):
    """The compacted sample ids are identical (not just close), and the
    composited outputs agree. Rays hit fewer and more than K occupied
    candidates."""
    o, d = _rays(6)
    grid = _occ(7, res=16, p=p)
    key = jax.random.key(8)
    s, k = 32, 8
    jf, tf = _field()
    j_occ = JR.OccupancyGrid(jnp.asarray(grid), 0.01)
    want = JR.render_rays(lambda p, x, v: jf(x, v), None, key, jnp.asarray(o), jnp.asarray(d),
                          n_samples=s, occ=j_occ, k_occupied=k, occ_coarse_res=coarse)
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (64, s))))
    t_occ = TR.OccupancyGrid(torch.from_numpy(grid), 0.01)
    got = TR.render_rays(tf, torch.from_numpy(o), torch.from_numpy(d), n_samples=s, occ=t_occ,
                         k_occupied=k, occ_coarse_res=coarse, jitter=draws)
    for f in JR.RenderOut._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)

    # the sample ids the compaction selects, against lax.top_k's
    near, far = TR.ray_aabb(torch.from_numpy(o), torch.from_numpy(d))
    far = torch.maximum(far, near + 1e-4)
    xyz, t, dt = TR.sample_points(torch.from_numpy(o), torch.from_numpy(d), s, near, far,
                                  jitter=draws)
    xyz_c = torch.clamp(xyz, 0, 1)
    occ_all = (TR.coarse_occupancy_mxu(t_occ, xyz_c, coarse) if coarse
               else t_occ.occupied(xyz_c))
    *_, s_idx = TR._compact_inputs(torch.from_numpy(o), torch.from_numpy(d), t, dt, occ_all,
                                   t_occ, k, coarse is not None)
    key_j = jnp.where(jnp.asarray(occ_all.numpy()) > 0, 0, s) + jnp.arange(s)[None]
    vals = -jax.lax.top_k(-key_j, k)[0]
    ids_j = np.asarray(jnp.where(vals < s, vals, vals - s))
    np.testing.assert_array_equal(s_idx.numpy(), ids_j)
    hits = (occ_all > 0).sum(-1)
    assert bool((hits < k).any()) and bool((hits > k).any())


def test_dense_render_rays_and_k_buckets_raise():
    o, d = _rays(9)
    jf, tf = _field(10)
    grid = _occ(11)
    key = jax.random.key(1)
    want = JR.render_rays(lambda p, x, v: jf(x, v), None, key, jnp.asarray(o), jnp.asarray(d),
                          n_samples=16, occ=JR.OccupancyGrid(jnp.asarray(grid), 0.01),
                          stratified=False)
    t_occ = TR.OccupancyGrid(torch.from_numpy(grid), 0.01)
    got = TR.render_rays(tf, torch.from_numpy(o), torch.from_numpy(d), n_samples=16, occ=t_occ,
                         stratified=False)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.instance_logits.numpy(), np.asarray(want.instance_logits),
                               rtol=1e-5, atol=1e-5)
    # a bad k_buckets ladder raises up front, with the JAX package's messages
    for ladder, msg in ((((0.75, 4), (0.5, 8)), "fractions sum to 1.2500 > 1"),
                        (((0.5, 4), (0.5, 200)), r"K values \[200\] exceed n_samples=16")):
        for mod, args in ((JR, (lambda p, x, v: jf(x, v), None, key, jnp.asarray(o),
                                jnp.asarray(d))),
                          (TR, (tf, torch.from_numpy(o), torch.from_numpy(d)))):
            occ = (JR.OccupancyGrid(jnp.asarray(grid), 0.01) if mod is JR else t_occ)
            with pytest.raises(ValueError, match=msg):
                mod.render_rays(*args, n_samples=16, occ=occ, k_buckets=ladder)


def test_update_occupancy_with_jax_jitter():
    grid = _occ(12, res=8)
    key = jax.random.key(2)

    def j_sigma(x):
        return jnp.exp(jnp.sin(7.0 * x[:, 0]) + jnp.cos(5.0 * x[:, 1]) * x[:, 2]) - 0.9

    def t_sigma(x):
        return torch.exp(torch.sin(7.0 * x[:, 0]) + torch.cos(5.0 * x[:, 1]) * x[:, 2]) - 0.9

    want = JR.update_occupancy(JR.OccupancyGrid(jnp.asarray(grid * 1e-3), 0.01), j_sigma, key,
                               chunk=100)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (8 ** 3, 3))))
    got = TR.update_occupancy(TR.OccupancyGrid(torch.from_numpy(grid * 1e-3), 0.01), t_sigma,
                              jitter=jitter, chunk=100)
    np.testing.assert_allclose(got.grid.numpy(), np.asarray(want.grid), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(TR.occupancy_cells(8, "cpu").numpy(),
                                  np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                                           -1).reshape(-1, 3))


def test_synthetic_scene_matches():
    """The same numpy seed gives the same scene: images to f32 rounding,
    instance masks identical, and the same ray batches."""
    js, jb = JD.make_synthetic_nerf_scene(np.random.default_rng(0), n_views=3, hw=(20, 20),
                                          n_blobs=2)
    ts, tb = TD.make_synthetic_nerf_scene(np.random.default_rng(0), n_views=3, hw=(20, 20),
                                          n_blobs=2)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(ts.images, js.images, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.masks, js.masks)
    np.testing.assert_array_equal(ts.poses, js.poses)
    assert ts.masks.max() == 2 and ts.intrinsics == js.intrinsics
    for a, b in zip(ts.ray_batch(np.random.default_rng(3), 50),
                    js.ray_batch(np.random.default_rng(3), 50)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_nerf_scene_matches(tmp_path, downscale):
    """An instant-ngp directory written by the JAX package loads the same in
    both: images, poses mapped into the unit cube, intrinsics and masks."""
    scene, _ = JD.make_synthetic_nerf_scene(np.random.default_rng(4), n_views=2, hw=(16, 20),
                                            n_blobs=1)
    JD.write_nerf_scene(str(tmp_path), scene)
    kw = dict(masks_dir=str(tmp_path / "masks"), downscale=downscale)
    want = JD.load_nerf_scene(str(tmp_path), **kw)
    got = TD.load_nerf_scene(str(tmp_path), **kw)
    for f in ("images", "poses", "masks"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.intrinsics == want.intrinsics and got.hw == want.hw
    assert got.images.shape == (2, 16 // downscale, 20 // downscale, 3)
