"""Parity of the port's 3D Swin Transformer (``models/swin.py``) with the JAX
package's, in f32 on the CPU, with weights carried over by ``convert.py``.

A toy Swin (embed 24, depths (2, 2, 2, 2), heads (1, 2, 2, 4)) on a 32^3
grid: stage 0 is 8^3 tokens, two windows an axis, so its odd blocks run the
shifted windows with the seam mask; the later stages fit in one window,
where the shift is dropped. Its JAX init and forward are compiled once
(``swin`` fixture, on random params); each submodule is then run on its own slice of those
params. The host constants agree exactly; every output to 1e-5 of its
largest entry.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from instance_nerf_tpu.models import swin as JS
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax
from instance_nerf_tpu_torch.models import swin as TS
from instance_nerf_tpu_torch.models.backbones import build_backbone

torch.set_num_threads(2)

TOY = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


def random_params(shapes, seed):
    """numpy weights over a flax params tree of ShapeDtypeStructs (no JAX
    init to compile): kernels normal(sqrt(1 / fan_in)), biases and bias
    tables normal(0.1) and normal(0.5), norm scales in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "rel_pos_bias_table"):
            return rng.normal(0, 0.1 if name == "bias" else 0.5, s.shape).astype(np.float32)
        return rng.normal(0, np.sqrt(1.0 / np.prod(s.shape[:-1])), s.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes["params"])}


@pytest.fixture(scope="module")
def swin():
    """(flax params, torch model with them, input, JAX pyramid)."""
    x = np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 32, 4)).astype(np.float32)
    jm = JS.SwinTransformerFPN(**TOY)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    params = random_params(shapes, 1)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = TS.SwinTransformerFPN(**TOY)
    tm.load_state_dict(rcnn_params_from_jax(params), strict=True)
    return params["params"], tm, x, want


@pytest.mark.parametrize("window", [(4, 4, 4), (2, 3, 4)])
def test_relative_position_index_exact(window):
    np.testing.assert_array_equal(TS.relative_position_index(window),
                                  JS.relative_position_index(window))


@pytest.mark.parametrize("spatial,window,shift", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
    ((8, 4, 8), (4, 4, 4), (2, 0, 2)),
    ((12, 8, 4), (4, 2, 4), (2, 1, 0)),
])
def test_shift_attention_mask_exact(spatial, window, shift):
    got = TS.shift_attention_mask(spatial, window, shift)
    want = JS.shift_attention_mask(spatial, window, shift)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_constants_are_built_once_per_geometry():
    dev = torch.device("cpu")
    a = TS._shift_mask((8, 8, 8), (4, 4, 4), (2, 2, 2), dev)
    assert TS._shift_mask((8, 8, 8), (4, 4, 4), (2, 2, 2), dev) is a
    assert TS._rel_index((4, 4, 4), dev) is TS._rel_index((4, 4, 4), dev)
    assert a.device == dev and a.shape == (8, 64, 64)


def test_constants_made_in_inference_mode_serve_training():
    """A train step after an eval (the train loops evaluate between epochs):
    the cached constants the eval built under ``torch.inference_mode`` must
    be usable by autograd."""
    TS._rel_index.cache_clear()
    TS._shift_mask.cache_clear()
    blk = TS.ShiftedWindowAttention3D(8, (4, 4, 4), (2, 2, 2), 2)
    x = torch.randn(1, 8, 8, 12, 8)
    with torch.inference_mode():
        blk(x)
    blk(x).sum().backward()
    assert blk.rel_pos_bias_table.grad is not None


@pytest.mark.parametrize("block,shape", [
    ("stage0_block0", (2, 8, 8, 8)),  # unshifted
    ("stage0_block1", (2, 8, 8, 8)),  # shifted, with the seam mask
    ("stage0_block1", (1, 7, 9, 6)),  # padded to 8 x 12 x 8, then shifted
    ("stage1_block1", (1, 4, 4, 3)),  # one window: the shift is dropped
])
def test_window_attention_matches_jax(swin, block, shape):
    params, tm, _, _ = swin
    mod = getattr(tm, block).attn
    c = mod.qkv.weight.shape[1]
    x = np.random.default_rng(2).normal(size=(*shape, c)).astype(np.float32)
    jm = JS.ShiftedWindowAttention3D(c, mod.window, mod.shift, mod.num_heads)
    want = jm.apply({"params": params[block]["attn"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("block", ["stage0_block1", "stage2_block0"])
def test_swin_block_matches_jax(swin, block):
    params, tm, _, _ = swin
    mod = getattr(tm, block)
    c = mod.Dense_1.weight.shape[0]
    x = np.random.default_rng(3).normal(size=(1, 7, 6, 5, c)).astype(np.float32)
    a = mod.attn
    jm = JS.SwinBlock(c, a.num_heads, a.window, a.shift)
    want = jm.apply({"params": params[block]}, jnp.asarray(x))
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), want)


def test_patch_merging_matches_jax(swin):
    """Odd sizes: padded to even before the 8-way concat."""
    params, tm, _, _ = swin
    x = np.random.default_rng(4).normal(size=(2, 7, 4, 5, 24)).astype(np.float32)
    want = JS.PatchMerging3D(48).apply({"params": params["merge_1"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.merge_1(torch.from_numpy(x))
    assert got.shape == (2, 4, 2, 3, 48)
    _close(got, want)


def test_swin_fpn_matches_jax(swin):
    _, tm, x, want = swin
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape[1:]) for g in got] == [(8, 8, 8, 256), (4, 4, 4, 256),
                                                 (2, 2, 2, 256), (1, 1, 1, 256)]
    for g, w in zip(got, want):
        _close(g, w)


def test_drop_path_draws_from_the_generator(swin):
    """Stochastic depth acts only with ``deterministic=False``: each example's
    residual branch is kept where its uniform from ``generator`` is below
    ``1 - rate``, and rescaled by it."""
    _, tm, _, _ = swin
    blk = tm.stage3_block1
    assert blk.drop_path == pytest.approx(0.1)  # the last of 8 blocks
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(16, 1, 1, 1, 192))
                         .astype(np.float32))

    def branches(y, keep=None):
        h = blk.attn(blk.LayerNorm_0(y))
        y = y + (h if keep is None else h * keep[0] / 0.9)
        h = blk.Dense_1(F.gelu(blk.Dense_0(blk.LayerNorm_1(y)), approximate="tanh"))
        return y + (h if keep is None else h * keep[1] / 0.9)

    with torch.no_grad():
        got = blk(x, deterministic=False, generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        keep = [(torch.rand((16, 1, 1, 1, 1), generator=gen) < 0.9).float() for _ in range(2)]
        assert 0 < int((keep[0] == 0).sum() + (keep[1] == 0).sum())
        assert torch.equal(got, branches(x, keep))
        assert torch.equal(blk(x), branches(x))


def test_build_backbone_swin_variants():
    for name, cfg in JS.SWIN_CONFIGS.items():
        m = build_backbone(name)
        assert isinstance(m, TS.SwinTransformerFPN) and m.out_channels == 256
        assert m.depths == cfg["depths"]
        assert m.patch_embed.weight.shape == (cfg["embed_dim"], 4, 4, 4, 4)
        heads = [getattr(m, f"stage{i}_block0").attn.num_heads for i in range(4)]
        assert heads == list(cfg["num_heads"])
        assert m.stage0_block1.attn.shift == (2, 2, 2) and m.stage0_block0.attn.shift == (0,) * 3
        assert m.fpn.lateral_3.weight.shape[1] == cfg["embed_dim"] * 8
        assert TS.swin_config(name) == cfg and TS.swin_config(name) is not TS.SWIN_CONFIGS[name]
