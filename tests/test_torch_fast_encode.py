"""Parity of the port's fast encoding (``models/fast_encode.py``) with the JAX
package: the brick encoding's forward and table gradient through kernel B4's
autograd Function (trailing = 1; ``pallas_grad=True`` on both sides, the JAX
side in Pallas interpret mode), the dense base grid (bf16-rounded x
contraction), the positional encoding, the instance-head mask and
``InstanceNGPFast`` after ``ngp_params_from_jax``, in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_nerf_tpu.models import fast_encode as JF
from instance_nerf_tpu_torch.convert import ngp_params_from_jax
from instance_nerf_tpu_torch.models import fast_encode as TF

torch.set_num_threads(2)

# 3 brick levels at T = 2^8: resolution 4 is dense (64 <= 256), 8 and 16 hash
L, T, F = 3, 2 ** 8, 2
RES = np.array([4, 8, 16])


def _points(seed, n=257):
    xyz = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    xyz[0] = 1.0
    xyz[1] = 0.0
    return xyz


@pytest.mark.parametrize("pallas_grad", [True, False])
def test_brick_encode_forward_and_table_grad(pallas_grad):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(L, T, 8, F)).astype(np.float32)
    xyz = _points(1)
    tgt = rng.normal(size=(xyz.shape[0], L * F)).astype(np.float32)

    def loss(tab):
        out = JF.brick_encode(tab, jnp.asarray(xyz), RES, pallas_grad=pallas_grad)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    out_t = TF.brick_encode(tab, torch.from_numpy(xyz), RES, pallas_grad=pallas_grad)
    ((out_t - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(tab.grad.numpy(), g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())


def test_pallas_replicas_change_nothing():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(L, T, 8, F)).astype(np.float32))
    xyz = torch.from_numpy(_points(3))
    grads = []
    for replicas in (1, 4):
        tab = table.clone().requires_grad_(True)
        TF.brick_encode(tab, xyz, RES, pallas_grad=True, pallas_replicas=replicas).sum().backward()
        grads.append(tab.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_dense_trilinear_forward_and_grad():
    """The JAX package rounds the grid and the x tent weights to bf16 in its
    first contraction: the port applies the same roundings, and rounds the
    grid's gradient to bf16 once as the cast's VJP does."""
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    xyz = _points(5, 300)
    tgt = rng.normal(size=(300, 4)).astype(np.float32)

    def loss(g):
        out = JF.dense_trilinear(g, jnp.asarray(xyz))
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(grid))
    g_t = torch.from_numpy(grid).requires_grad_(True)
    out_t = TF.dense_trilinear(g_t, torch.from_numpy(xyz))
    ((out_t - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    # the gradient is rounded to bf16: one bf16 ulp (2^-8) where the f32 sums
    # before the rounding differ
    np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(g_j), rtol=1e-2, atol=1e-5)


def test_pe_encode():
    xyz = _points(6, 50)
    np.testing.assert_allclose(TF.pe_encode(torch.from_numpy(xyz)).numpy(),
                               np.asarray(JF.pe_encode(jnp.asarray(xyz))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TF.brick_resolutions(3, 32, 1024),
                                  JF.brick_resolutions(3, 32, 1024))


def test_mask_to_instance_head():
    tree = {"brick_table": torch.ones(2), "inst_0.weight": torch.ones(3),
            "inst_1.bias": torch.ones(1), "sigma_0.weight": torch.ones(2)}
    out = TF.mask_to_instance_head(tree)
    assert [float(v.sum()) for v in out.values()] == [0.0, 3.0, 1.0, 0.0]


def test_table_dtype_waits_for_a_later_slice():
    """``table_dtype`` is ported: "bfloat16" reads the brick table in bf16,
    any other value in f32 (the JAX module's mapping); the table stays f32."""
    assert TF.InstanceNGPFast(n_levels=2, table_size=64,
                              table_dtype="bfloat16").table_cast == torch.bfloat16
    for td in (None, "float32"):
        assert TF.InstanceNGPFast(n_levels=2, table_size=64, table_dtype=td).table_cast is None
    assert TF.InstanceNGPFast(n_levels=2, table_size=64,
                              table_dtype="bfloat16").brick_table.dtype == torch.float32


def _bf16_representable(a):
    a = np.array(a, np.float32)
    return np.array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("pallas_grad", [True, False])
def test_brick_encode_bf16_table_matches_jax(pallas_grad):
    """The bf16 table read: the forward to 1e-5; the f32 master table's
    gradient through B3 (``pallas_grad``) is the f32 sum of the bf16 row
    gradients on both sides (to 1e-5 of its max, not rounded to bf16);
    without it both sides scatter in bf16, so every entry is
    bf16-representable and the two agree to bf16 rounding of the sums."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(L, T, 8, F)).astype(np.float32)
    xyz = _points(5)
    tgt = rng.normal(size=(xyz.shape[0], L * F)).astype(np.float32)

    def loss(tab):
        out = JF.brick_encode(tab, jnp.asarray(xyz), RES, pallas_grad=pallas_grad,
                              table_cast=jnp.bfloat16)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    out_t = TF.brick_encode(tab, torch.from_numpy(xyz), RES, pallas_grad=pallas_grad,
                            table_cast=torch.bfloat16)
    ((out_t - torch.from_numpy(tgt)) ** 2).sum().backward()
    assert out_t.dtype == torch.float32 and tab.grad.dtype == torch.float32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    g_j, g_t = np.asarray(g_j), tab.grad.numpy()
    scale = np.abs(g_j).max()
    if pallas_grad:
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-5 * scale)
        assert not _bf16_representable(g_j) and not _bf16_representable(g_t)
    else:
        assert _bf16_representable(g_j) and _bf16_representable(g_t)
        np.testing.assert_allclose(g_t, g_j, rtol=2 ** -6, atol=2 ** -8 * scale)


def test_instance_ngp_fast_forward_after_conversion():
    kw = dict(n_levels=L, table_size=T, n_features=F, base_res=4, max_res=16, dense_res=8,
              dense_features=4, hidden=16, num_instances=5, pallas_grad=True)
    model = JF.InstanceNGPFast(**kw)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 3)),
                                                 jnp.asarray([[0.0, 0.0, 1.0]])))
    rng = np.random.default_rng(7)
    params["params"]["brick_table"] = rng.normal(size=(L, T, 8, F)).astype(np.float32)
    params["params"]["dense_grid"] = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    xyz = _points(8, 200)
    vd = rng.normal(size=(200, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    want = model.apply(params, jnp.asarray(xyz), jnp.asarray(vd))

    port = TF.InstanceNGPFast(**kw)
    port.load_state_dict(ngp_params_from_jax(params), strict=True)
    got = port(torch.from_numpy(xyz), torch.from_numpy(vd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
