"""Parity of the port's 3D layers, FPN and VGG-FPN backbone with the JAX
package, in f32 with weights converted by ``convert.py``; relative
tolerance 1e-4 (conv sums run in another order).

Grid sizes are odd downstream so the flax ``SAME`` padding is asymmetric:
the k7 s2 stem pads 2 low and 3 high, a k2 s2 pool on an odd size pads 0
low and 1 high.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import layers as JL
from instance_nerf_tpu.models.backbones import VGG_FPN as JVGG
from instance_nerf_tpu.models.fpn import FPN as JFPN
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax
from instance_nerf_tpu_torch.models import layers as TL
from instance_nerf_tpu_torch.models.backbones import VGG_FPN, build_backbone
from instance_nerf_tpu_torch.models.fpn import FPN
from instance_nerf_tpu_torch.models.layers import same_pads

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_same_pads_are_flax_asymmetric():
    assert same_pads(200, 7, 2) == (2, 3)
    assert same_pads(132, 7, 2) == (2, 3)
    assert same_pads(25, 2, 2) == (0, 1)
    assert same_pads(24, 2, 2) == (0, 0)
    assert same_pads(33, 3, 2) == (1, 1)
    assert same_pads(13, 3, 1) == (1, 1)


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (1, 2)])
def test_max_pool_3d_same_odd_sizes(window, stride):
    x = np.random.default_rng(0).normal(size=(2, 25, 13, 9, 3)).astype(np.float32)
    want = JL.max_pool_3d(jnp.asarray(x), window=window, stride=stride)
    got = TL.max_pool_3d(torch.from_numpy(x), window=window, stride=stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upsample_nearest_to():
    x = np.random.default_rng(1).normal(size=(1, 4, 3, 2, 5)).astype(np.float32)
    for target in ((7, 5, 3), (8, 6, 4), (13, 9, 5)):
        want = JL.upsample_nearest_to(jnp.asarray(x), target)
        got = TL.upsample_nearest_to(torch.from_numpy(x), target)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_block_k7_s2_odd_size():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1, 17, 13, 11, 4)).astype(np.float32)
    jm = JL.ConvBlock(64, kernel=7, stride=2)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = TL.ConvBlock(4, 64, kernel=7, stride=2)
    tm.load_state_dict(rcnn_params_from_jax(_np(params)))
    got = tm(torch.from_numpy(x))
    assert got.shape == (1, 9, 7, 6, 64)
    _close(got, want)


def test_fpn_matches_jax():
    rng = np.random.default_rng(3)
    shapes = [((9, 7, 5), 16), ((5, 4, 3), 32), ((3, 2, 2), 32)]
    xs = [rng.normal(size=(1, *s, c)).astype(np.float32) for s, c in shapes]
    jm = JFPN(out_channels=24, num_outs=4)
    params = jm.init(jax.random.key(1), [jnp.asarray(x) for x in xs])
    want = jm.apply(params, [jnp.asarray(x) for x in xs])
    tm = FPN([16, 32, 32], out_channels=24, num_outs=4)
    tm.load_state_dict(rcnn_params_from_jax(_np(params)))
    got = tm([torch.from_numpy(x) for x in xs])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_vgg_fpn_ef_matches_jax():
    x = np.random.default_rng(4).uniform(0, 1, (1, 48, 40, 36, 4)).astype(np.float32)
    jm = JVGG(cfg="EF", input_size=160)
    params = jm.init(jax.random.key(2), jnp.asarray(x[:, :16, :16, :16]))
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = VGG_FPN(cfg="EF", input_size=160)
    tm.load_state_dict(rcnn_params_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    # 48x40x36 -> stem 24x20x18 -> pool 12x10x9 -> 6x5x5 -> 3x3x3 -> 2x2x2
    assert [tuple(g.shape[1:4]) for g in got] == [(12, 10, 9), (6, 5, 5),
                                                  (3, 3, 3), (2, 2, 2)]
    for g, w in zip(got, want):
        _close(g, w)


def test_build_backbone_names_later_slices():
    """The factory returns every backbone the JAX package's does, with the
    hyperparameters of the JAX configs: VGG (with ``conv_at_start``), the
    ResNet-FPN of ``resnet`` and the four Swin variants; none raises."""
    from instance_nerf_tpu.models.backbones import build_backbone as j_build
    from instance_nerf_tpu_torch.models.backbones import ResNet_FPN_256
    from instance_nerf_tpu_torch.models.swin import SwinTransformerFPN

    for name in ("vgg_AF", "vgg_DF", "vgg_EF"):
        m = build_backbone(name, conv_at_start=True)
        assert isinstance(m, VGG_FPN) and m.conv_at_start
        assert m.ds_proj.conv.weight.shape[:2] == (128, 32)
    for size in (64, 160):
        j, t = j_build("resnet", input_size=size), build_backbone("resnet", input_size=size)
        assert isinstance(t, ResNet_FPN_256)
        assert (t.layers, t.is_max_pool) == (tuple(j.layers), j.is_max_pool)
    for name in ("swin_t", "swin_s", "swin_b", "swin_l"):
        j, t = j_build(name), build_backbone(name)
        assert isinstance(t, SwinTransformerFPN)
        assert t.depths == tuple(j.depths) and t.out_channels == j.out_channels == 256
        assert t.patch_embed.weight.shape[0] == j.embed_dim
        assert [getattr(t, f"stage{i}_block0").attn.num_heads for i in range(4)] == list(
            j.num_heads)
    with pytest.raises(ValueError, match="Unknown backbone"):
        build_backbone("densenet")
