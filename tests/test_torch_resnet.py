"""Parity of the port's ResNet backbones (``Bottleneck``, ``ResNet_FPN_256``
with and without ``is_max_pool``, ``ResNet_FPN_64``, ``ResNetSimplified``)
and of ``VGG_FPN(conv_at_start=True)`` with the JAX package's, in f32 on
the CPU, weights carried over by ``convert.py``: every level to 1e-5 of its
largest entry. Toy sizes: one or two bottlenecks a stage, ``in_planes`` 8,
odd grids (asymmetric ``SAME`` pads); each JAX init and forward is compiled
once.

In f32 the GroupNorm statistics round differently in XLA and torch, and
ReLU inputs within rounding of 0 fall on either side (as in the VGG trunk,
``test_torch_train_step.py``): the toy ResNet-FPNs read 1.05e-5 to 1.1e-5 of
their largest entry apart in f32. So the ResNet forwards (but the single
``Bottleneck``, held in f32) and the trunk's backward are held in f64 (JAX's
x64 mode), to the same 1e-5 (forward) and 1e-6 (gradients); the VGG with
``conv_at_start`` stays in f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_nerf_tpu.models import backbones as JB
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax
from instance_nerf_tpu_torch.models import backbones as TB

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


def _grid(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, (1, *shape, 4)).astype(np.float32)


def random_params(shapes, seed):
    """numpy weights over a flax params tree of ShapeDtypeStructs (no JAX
    init to compile): kernels normal(sqrt(2 / fan_in)), biases normal(0.1),
    norm scales in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes["params"])}


def _pair(jm, tm, x, f64=False):
    """Random params, the JAX forward (compiled), the params loaded into
    ``tm``: (flax params, the JAX outputs, the port's outputs). ``f64`` runs
    both forwards in f64 (JAX's x64 mode)."""
    params = random_params(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x)), 0)
    tm.load_state_dict(rcnn_params_from_jax(params), strict=True)
    if f64:
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
            want = [np.asarray(w) for w in jax.jit(jm.apply)(p64, jnp.asarray(x, jnp.float64))]
        tm = tm.double()
        x = x.astype(np.float64)
    else:
        want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return params["params"], want, got


@pytest.fixture(scope="module")
def resnet256():
    kw = dict(layers=(1, 2, 1, 1), in_planes=8, is_max_pool=True)
    return _pair(JB.ResNet_FPN_256(**kw), TB.ResNet_FPN_256(**kw), _grid((33, 30, 28), 0),
                 f64=True)


def test_resnet_fpn_256_max_pool_matches_jax(resnet256):
    _, want, got = resnet256
    # stem s2 17x15x14, pool 9x8x7, then strides 1, 2, 2, 2
    assert [tuple(g.shape[1:4]) for g in got] == [(9, 8, 7), (5, 4, 4), (3, 2, 2), (2, 1, 1)]
    for g, w in zip(got, want):
        _close(g, w)


def test_resnet_fpn_256_without_max_pool_matches_jax():
    kw = dict(layers=(1, 1, 1, 1), in_planes=8, is_max_pool=False)
    _, want, got = _pair(JB.ResNet_FPN_256(**kw), TB.ResNet_FPN_256(**kw),
                         _grid((17, 16, 15), 1), f64=True)
    assert [tuple(g.shape[1:4]) for g in got] == [(9, 8, 8), (5, 4, 4), (3, 2, 2), (2, 1, 1)]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("block", ["layer1_block0", "layer1_block1"],
                         ids=["downsample", "identity"])
def test_bottleneck_matches_jax(resnet256, block):
    """The first block of a stage strides 2 and projects its input
    (``downsample``); the next adds its input as it is."""
    params, _, _ = resnet256
    stride = 2 if block.endswith("0") else 1
    in_ch = 32 if stride == 2 else 64
    x = np.random.default_rng(2).normal(size=(2, 5, 4, 3, in_ch)).astype(np.float32)
    want = JB.Bottleneck(16, stride=stride).apply({"params": params[block]}, jnp.asarray(x))
    tm = TB.Bottleneck(in_ch, 16, stride=stride)
    assert (tm.downsample is None) == (stride == 1)
    tm.load_state_dict(rcnn_params_from_jax({"params": params[block]}), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)


def test_resnet_fpn_64_matches_jax():
    """The stride-1 stem; its 16-channel GroupNorms take 16 groups."""
    jm, tm = JB.ResNet_FPN_64(layers=(1, 1, 1, 1)), TB.ResNet_FPN_64(layers=(1, 1, 1, 1))
    assert tm.stem.norm.num_groups == 16 and tm.out_channels == 64
    _, want, got = _pair(jm, tm, _grid((17, 16, 15), 3), f64=True)
    assert [tuple(g.shape[1:]) for g in got] == [(17, 16, 15, 64), (9, 8, 8, 64),
                                                 (5, 4, 4, 64), (3, 2, 2, 64)]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("downsample", [False, True])
def test_resnet_simplified_matches_jax(downsample):
    kw = dict(out_channels=16, num_residuals=2, downsample=downsample)
    _, want, got = _pair(JB.ResNetSimplified(**kw), TB.ResNetSimplified(**kw),
                         _grid((13, 11, 9), 4), f64=True)
    assert len(got) == 1
    _close(got[0], want[0])


def test_vgg_fpn_conv_at_start_matches_jax():
    """Two 32-channel convs ahead of the stem, and the stride-4 branch's
    128-channel projection added to the first tap."""
    kw = dict(cfg="AF", input_size=160, conv_at_start=True)
    _, want, got = _pair(JB.VGG_FPN(**kw), TB.VGG_FPN(**kw), _grid((29, 24, 21), 5))
    assert [tuple(g.shape[1:4]) for g in got] == [(8, 6, 6), (4, 3, 3), (2, 2, 2), (1, 1, 1)]
    for g, w in zip(got, want):
        _close(g, w)


def test_resnet_gradients_match_jax_in_f64():
    """``ResNet_FPN_256``'s backward in f64: the gradient of every parameter
    under a random cotangent on the 4 levels, to 1e-6 of its largest entry
    (or of 1e-9 of the largest gradient in the model: a conv bias ahead of a
    GroupNorm has a zero gradient, read as about 1e-13 in both)."""
    jm = JB.ResNet_FPN_256(layers=(1, 1, 1, 1), in_planes=8, is_max_pool=True)
    x = np.random.default_rng(6).uniform(0, 1, (1, 20, 18, 16, 4))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros(x.shape, jnp.float32))
    params = random_params(shapes, 25)
    rng = np.random.default_rng(7)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        cot = [rng.normal(size=f.shape) for f in jm.apply(p64, jnp.asarray(x))]

        def loss(p):
            return sum(jnp.sum(f * c) for f, c in zip(jm.apply(p, jnp.asarray(x)), cot))

        want = rcnn_params_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.jit(jax.grad(loss))(p64)))
    tm = TB.ResNet_FPN_256(layers=(1, 1, 1, 1), in_planes=8, is_max_pool=True).double()
    tm.load_state_dict(rcnn_params_from_jax(params))
    sum((f * torch.from_numpy(c)).sum() for f, c in zip(tm(torch.from_numpy(x)), cot)).backward()
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        w = want[name].double()
        scale = max(float(w.abs().max()), 1e-9 * top)
        assert float((p.grad - w).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("input_size", [64, 160])
def test_build_backbone_resnet(input_size):
    """``resnet``: ``ResNet_FPN_256`` (3, 4, 6, 3) from 64 planes, its stem
    max-pooled from ``input_size`` 160 up (strides 4..32; 2..16 below)."""
    m = TB.build_backbone("resnet", input_size=input_size, in_channels=3)
    assert isinstance(m, TB.ResNet_FPN_256) and m.out_channels == 256
    assert m.layers == (3, 4, 6, 3) and m.is_max_pool == (input_size >= 160)
    assert m.stem.conv.weight.shape == (64, 3, 7, 7, 7)
    assert m.lat_0.weight.shape[:2] == (256, 2048) and m.lat_3.weight.shape[:2] == (256, 256)
    assert m.layer3_block0.downsample.conv.stride == 2 and m.layer0_block1.downsample is None
