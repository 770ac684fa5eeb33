"""Parity of the port's hash-grid field (``models/hashgrid.py``) with the JAX
package: the uint32 hash, the encoding's forward and its table gradient
through kernel B4's autograd Function (``pallas_grad=True`` on both sides,
the JAX side in Pallas interpret mode), and ``InstanceNGP`` after
``ngp_params_from_jax``. f32 throughout; tolerances are f32 rounding of
sums taken in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.models import hashgrid as JH
from instance_nerf_tpu_torch.convert import ngp_params_from_jax
from instance_nerf_tpu_torch.models import hashgrid as TH

torch.set_num_threads(2)

# 4 levels at T = 2^9: resolution 4 is dense (64 <= 512), 10, 25 and 64 hash
L, T, F = 4, 2 ** 9, 2
RES = JH.ngp_resolutions(L, 4, 64)


def _points(seed, n=300):
    xyz = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    xyz[0] = 1.0  # the +1 corner is clamped (weight 0)
    xyz[1] = 0.0
    xyz[2] = [1.0, 0.5, 0.0]
    return xyz


def test_levels_are_dense_and_hashed():
    assert list(RES ** 3 <= T) == [True, False, False, False]
    np.testing.assert_array_equal(TH.ngp_resolutions(16, 16, 1024),
                                  JH.ngp_resolutions(16, 16, 1024))


def test_hash_matches_uint32_wraparound():
    """Corner coordinates up to the main config's res 1024 at T = 2^19."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1024, (4096, 1, 3)).astype(np.uint32)
    res = np.array([1024])
    h = (c[..., 0] * JH.HASH_PRIMES[0]) ^ (c[..., 1] * JH.HASH_PRIMES[1]) ^ (
        c[..., 2] * JH.HASH_PRIMES[2])
    want = (h % np.uint32(2 ** 19)).astype(np.int64)
    got = TH.hash_cells(torch.from_numpy(c.astype(np.int64)), res, 2 ** 19).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pallas_grad", [True, False])
def test_hash_encode_forward_and_table_grad(pallas_grad):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(L, T, F)).astype(np.float32)
    xyz = _points(2)
    tgt = rng.normal(size=(xyz.shape[0], L * F)).astype(np.float32)

    def loss(tab):
        out = JH.hash_encode(tab, jnp.asarray(xyz), RES, pallas_grad=pallas_grad)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    out_t = TH.hash_encode(tab, torch.from_numpy(xyz), RES, pallas_grad=pallas_grad)
    ((out_t - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(tab.grad.numpy(), g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())
    assert (g_j != 0).sum() > 1000  # many rows touched on every level


def test_encode_keeps_leading_shape():
    table = torch.from_numpy(np.random.default_rng(3).normal(size=(L, T, F)).astype(np.float32))
    xyz = torch.from_numpy(_points(4, 24).reshape(4, 6, 3))
    out = TH.hash_encode(table, xyz, RES)
    assert out.shape == (4, 6, L * F)
    np.testing.assert_allclose(out.reshape(24, -1).numpy(),
                               TH.hash_encode(table, xyz.reshape(24, 3), RES).numpy())


def test_sh_and_density_activation():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(TH.sh_encode_deg2(torch.from_numpy(d)).numpy(),
                               np.asarray(JH.sh_encode_deg2(jnp.asarray(d))), rtol=1e-6,
                               atol=1e-7)
    s = np.array([-30.0, -15.0, 0.0, 3.0, 15.0, 40.0], np.float32)
    np.testing.assert_allclose(TH.density_activation(torch.from_numpy(s)).numpy(),
                               np.asarray(JH.density_activation(jnp.asarray(s))), rtol=1e-6)


def jax_ngp(seed=0, **kw):
    """A flax InstanceNGP with ``pallas_grad`` and a table of unit-scale
    values (the init's +-1e-4 would hide the encoding)."""
    model = JH.InstanceNGP(n_levels=L, table_size=T, n_features=F, base_res=4, max_res=64,
                           hidden=16, num_instances=5, pallas_grad=True, **kw)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 3)), jnp.asarray([[0.0, 0.0, 1.0]]))
    params = jax.tree.map(np.asarray, params)
    params["params"]["hash_table"] = np.random.default_rng(seed).normal(
        size=(L, T, F)).astype(np.float32)
    return model, params


def test_instance_ngp_forward_after_conversion():
    model, params = jax_ngp()
    rng = np.random.default_rng(6)
    xyz = _points(7, 200)
    vd = rng.normal(size=(200, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    want = model.apply(params, jnp.asarray(xyz), jnp.asarray(vd))

    port = TH.InstanceNGP(n_levels=L, table_size=T, n_features=F, base_res=4, max_res=64,
                          hidden=16, num_instances=5, pallas_grad=True)
    port.load_state_dict(ngp_params_from_jax(params), strict=True)
    got = port(torch.from_numpy(xyz), torch.from_numpy(vd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    sigma, rgb, logits = port(torch.from_numpy(xyz), torch.from_numpy(vd), with_instance=False)
    assert logits is None and torch.equal(rgb, got[1])
