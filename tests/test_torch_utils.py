"""The port's FLOP counter, memory and step statistics, profiling helpers and
metrics logger against the JAX package's ``utils/``.

``count_flops`` must equal the JAX jaxpr count exactly: on the cases of
``tests/test_flops_pool.py`` (a dot, a conv, a grouped conv, a gradient =
2 x the forward), on strided and transposed convolutions and their
gradients (where the JAX rule differs from ``FlopCounterMode``'s own), on
the VGG-AF FPN at 32^3 (forward and gradient), and on a whole FCOS and RCNN
train step (the count ``compiled_step_stats`` reports as
``flops_per_step``: its ``count_flops`` of the step, taken here without the
compile)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from instance_nerf_tpu.utils.flops import count_flops as j_count
from instance_nerf_tpu_torch.utils import hbm, profiling
from instance_nerf_tpu_torch.utils.flops import count_flops

torch.set_num_threads(2)


def _jconv(x, k, stride=1, groups=1, padding="SAME"):
    return jax.lax.conv_general_dilated(x, k, (stride,) * 3, padding, feature_group_count=groups,
                                        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def test_count_flops_dot_and_conv():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    assert count_flops(lambda: a @ b) == j_count(lambda x, y: x @ y, jnp.zeros((64, 128)),
                                                 jnp.zeros((128, 32))) == 2 * 64 * 128 * 32
    x = torch.zeros(2, 8, 16, 16)
    k = torch.zeros(4, 8, 3, 3)

    def jconv2d(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = j_count(jconv2d, jnp.zeros((2, 16, 16, 8)), jnp.zeros((3, 3, 8, 4)))
    assert count_flops(lambda: F.conv2d(x, k, padding=1)) == want == 2 * 2 * 16 * 16 * 4 * 8 * 9


def test_count_flops_grouped_conv_and_grad():
    x = torch.zeros(1, 16, 8, 8)
    k = torch.zeros(16, 4, 3, 3)  # groups 4

    def jconv(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME", feature_group_count=4,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = j_count(jconv, jnp.zeros((1, 8, 8, 16)), jnp.zeros((3, 3, 4, 16)))
    assert count_flops(lambda: F.conv2d(x, k, padding=1, groups=4)) == want
    assert want == 2 * 1 * 8 * 8 * 16 * 4 * 9
    # the gradient with respect to the kernel only: the forward and the
    # weight-gradient convolution, 2x the forward
    kk = torch.zeros(4, 8, 3, 3, requires_grad=True)
    xx = torch.zeros(2, 8, 16, 16)
    one = count_flops(lambda: F.conv2d(xx, kk, padding=1))
    assert count_flops(
        lambda: torch.autograd.grad((F.conv2d(xx, kk, padding=1) ** 2).sum(), kk)) == 2 * one


@pytest.mark.parametrize("stride", [1, 2])
def test_count_flops_strided_conv_gradients_match_jax(stride):
    """A strided conv's input gradient counts over the input's size, as the
    JAX rule does (``FlopCounterMode``'s own rule counts the output's)."""
    x = np.zeros((2, 12, 10, 8, 6), np.float32)
    k = np.zeros((3, 3, 3, 6, 5), np.float32)

    def jloss(x, k):
        return jnp.sum(_jconv(x, k, stride) ** 2)

    want_f = j_count(lambda x, k: _jconv(x, k, stride), jnp.asarray(x), jnp.asarray(k))
    want_g = j_count(jax.grad(jloss, argnums=(0, 1)), jnp.asarray(x), jnp.asarray(k))
    tx = torch.zeros(2, 6, 12, 10, 8, requires_grad=True)
    tk = torch.zeros(5, 6, 3, 3, 3, requires_grad=True)
    assert count_flops(lambda: F.conv3d(tx, tk, stride=stride, padding=1)) == want_f
    got_g = count_flops(lambda: torch.autograd.grad(
        (F.conv3d(tx, tk, stride=stride, padding=1) ** 2).sum(), (tx, tk)))
    assert got_g == want_g


def test_count_flops_transposed_conv_matches_flax():
    """flax's ``ConvTranspose`` (k2 s2, the RCNN mask head's ``conv5_mask``)
    counts over its upsampled output with the whole kernel; its input
    gradient over the input, its weight gradient over the output."""
    import flax.linen as nn

    m = nn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2), padding="SAME")
    x = jnp.zeros((1, 5, 5, 5, 8))
    params = m.init(jax.random.key(0), x)
    want_f = j_count(lambda p, x: m.apply(p, x), params, x)
    want_g = j_count(jax.grad(lambda p, x: jnp.sum(m.apply(p, x)), argnums=(0, 1)), params, x)
    assert want_f == 2 * 10 ** 3 * 4 * 8 * 8
    tx = torch.zeros(1, 8, 5, 5, 5, requires_grad=True)
    tw = torch.zeros(8, 4, 2, 2, 2, requires_grad=True)
    assert count_flops(lambda: F.conv_transpose3d(tx, tw, stride=2)) == want_f
    assert count_flops(lambda: torch.autograd.grad(
        F.conv_transpose3d(tx, tw, stride=2).sum(), (tx, tw))) == want_g


def test_count_flops_vgg_af_fpn_matches_flax():
    from instance_nerf_tpu.models.backbones import VGG_FPN as JVGG
    from instance_nerf_tpu_torch.models.backbones import VGG_FPN

    x = jnp.zeros((1, 32, 32, 32, 4))
    jm = JVGG(cfg="AF", input_size=32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x)
    want_f = j_count(lambda p: jm.apply(p, x), shapes)
    want_g = j_count(jax.grad(lambda p: sum(jnp.sum(o) for o in jm.apply(p, x))), shapes)
    tm = VGG_FPN(cfg="AF", input_size=32)
    for p in tm.parameters():
        torch.nn.init.normal_(p)
    tx = torch.zeros(1, 32, 32, 32, 4)
    assert count_flops(lambda: tm(tx)) == want_f > 0
    assert count_flops(lambda: torch.autograd.grad(
        sum(o.sum() for o in tm(tx)), list(tm.parameters()), allow_unused=True)) == want_g


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _fcos_step(batch, shape):
    """(JAX count, port step) of one FCOS AABB train step at VGG-AF."""
    from instance_nerf_tpu.parallel import train_step as JS
    from instance_nerf_tpu.train.fcos_trainer import FCOSConfig as JConfig
    from instance_nerf_tpu.train.fcos_trainer import FCOSTrainer as JTrainer
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
    from instance_nerf_tpu_torch.train.loop import synthetic_batch

    kw = dict(dtype="float32", num_convs=2, resolution=shape[0], backbone_type="vgg_AF",
              max_gt=8)
    jt = JTrainer(JConfig(**kw))
    cfg = jt.cfg
    pshapes = jax.eval_shape(jt.model.init, jax.random.key(0), jnp.zeros((1, *shape, 4)))
    tx = optax.adam(1e-3)
    raw = JS.make_fcos_train_step(
        jt.model, tx, reg_loss_weight=cfg.reg_loss_weight,
        center_sampling_radius=cfg.center_sampling_radius, iou_loss_type=cfg.iou_loss_type,
        use_obb=cfg.rotated_bbox, use_additional_l1_loss=cfg.use_additional_l1_loss,
        proj2d_loss_weight=cfg.proj2d_loss_weight, jit_step=False)
    state = JS.TrainState(pshapes, jax.eval_shape(tx.init, pshapes), _sds((), jnp.int32))
    want = j_count(raw, state, _sds((batch, *shape, 4)), _sds((batch, 3)),
                   _sds((batch, cfg.max_gt, 6)), _sds((batch, cfg.max_gt), jnp.bool_))
    tt = FCOSTrainer(FCOSConfig(**kw), device="cpu")
    tt.init_state()
    args = [torch.as_tensor(a) for a in synthetic_batch(batch, shape, cfg.max_gt, 6, 4)]
    fn = tt.train_step_fn()

    def step():
        tt.state, metrics = fn(tt.state, *args)
        return metrics

    return want, step


def _rcnn_step(batch, shape):
    """(JAX count, port step) of one NeRF-RCNN train step at VGG-AF."""
    from instance_nerf_tpu.train import rcnn_trainer as JRC
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer

    kw = dict(dtype="float32", resolution=shape[0], num_classes=11, batch_size_per_image=16,
              backbone_type="vgg_AF", max_rois=16, max_gt=4)
    jt = JRC.RCNNTrainer(JRC.RCNNConfig(**kw))
    pshapes = jax.eval_shape(lambda k, g, r: jt.model.init(k, g, r, with_masks=True),
                             jax.random.key(0), jnp.zeros((1, *shape, 4)),
                             jnp.asarray([[[2.0, 2, 2, 20, 20, 20]]]))
    tx = optax.adam(1e-3)
    raw = JRC.make_rcnn_step_fn(jt.model, tx, jt.cfg, jt.mask_slots)
    p, k = jt.cfg.max_rois, jt.cfg.max_gt
    want = j_count(raw, pshapes, jax.eval_shape(tx.init, pshapes), jax.random.key(0),
                   _sds((batch, *shape, 4)), _sds((batch, 3)), _sds((batch, p, 6)),
                   _sds((batch, p), jnp.bool_), _sds((batch, k, 6)), _sds((batch, k), jnp.int32),
                   _sds((batch, k), jnp.bool_), _sds((batch, k, *shape), jnp.uint8))
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, shape[0] * 0.5, (batch, p + k, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(4, shape[0] * 0.4, lo.shape)], -1)
    args = [torch.as_tensor(a) for a in (
        rng.uniform(0, 1, (batch, *shape, 4)).astype(np.float32),
        np.full((batch, 3), float(shape[0]), np.float32), boxes[:, :p].astype(np.float32),
        np.ones((batch, p), bool), boxes[:, p:].astype(np.float32),
        rng.integers(1, 11, (batch, k)).astype(np.int32), np.ones((batch, k), bool),
        (rng.uniform(size=(batch, k, *shape)) < 0.1).astype(np.uint8))]
    tt = RCNNTrainer(RCNNConfig(**kw), device="cpu")
    tt.init_state()
    fn = tt.train_step_fn()

    def step():
        tt.state, metrics = fn(tt.state, *args, generator=tt.gen)
        return metrics

    return want, step


@pytest.mark.parametrize("make", [_fcos_step, _rcnn_step], ids=["fcos", "rcnn"])
def test_train_step_flops_and_benchmark_keys(make, monkeypatch):
    """A train step's FLOPs equal the JAX step's count, and the trainers'
    benchmark adds the JAX trainers' keys: the timing needs the card, so a
    stand-in takes ``benchmark_steps``' place here (it runs no step)."""
    from instance_nerf_tpu_torch.train import timing

    want, step = make(1, (32, 32, 32))

    def fake_steps(step, device, batch, reps=18, warmup=3):
        return {"median_ms": 250.0, "peak_mem_bytes": 3 << 30}

    monkeypatch.setattr(timing, "benchmark_steps", fake_steps)
    out = timing.benchmark_train_steps(step, "cpu", 1)
    assert out["flops_per_step"] == want > 0
    assert out["tflops_per_step"] == want / 1e12
    assert out["achieved_tflops"] == want / 0.25 / 1e12
    assert out["mfu"] == want / 0.25 / hbm.H100_SXM_PEAK_BF16_FLOPS
    assert out["peak_hbm_gib"] == 3.0


def test_step_stats_per_call():
    a = torch.zeros(16, 16)
    st = hbm.step_stats(lambda: [a @ a for _ in range(4)], steps_per_call=4)
    assert st == {"flops_per_step": 2 * 16 ** 3, "tflops_per_step": 2 * 16 ** 3 / 1e12}


def test_memory_stats_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hbm.memory_stats(lambda: None)


def test_step_timer_summary_matches_jax():
    from instance_nerf_tpu.utils.profiling import StepTimer as JStepTimer

    timers = [profiling.StepTimer(warmup=2), JStepTimer(warmup=2)]
    for t in timers:
        for _ in range(5):
            with t:
                pass
    got, want = (t.summary() for t in timers)
    assert set(got) == set(want) == {"mean_ms", "std_ms", "n"}
    assert got["n"] == want["n"] == 3
    assert profiling.StepTimer().summary() == JStepTimer().summary()


def test_chained_latency_and_trace(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.dispatch_overhead_ms()
    x = torch.ones(64, 64)
    ms = profiling.chained_latency_ms(lambda c, m: c + (m @ m).sum() * 0 + 1, (x,), reps=3,
                                      device="cpu")
    assert ms > 0 and profiling.dispatch_overhead_ms(reps=3, device="cpu") > 0
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    data = json.load(open(tmp_path / "trace" / profiling.TRACE_FILE))
    assert data["traceEvents"]


def test_metrics_logger_files_equal_jax(tmp_path, monkeypatch):
    import time

    from instance_nerf_tpu.utils.logging import MetricsLogger as JLogger
    from instance_nerf_tpu_torch.utils.logging import MetricsLogger

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    for name, cls in (("port", MetricsLogger), ("jax", JLogger)):
        # wandb is absent here: both go on without it
        log = cls(str(tmp_path / name), use_wandb=True, config={"lr": 1e-3})
        assert log._wandb is None
        log.log({"loss": np.float32(0.5), "lr": 1e-3}, step=3)
        log.log({"loss": 0.25})
        log.close()
    assert ((tmp_path / "port" / "metrics.jsonl").read_bytes()
            == (tmp_path / "jax" / "metrics.jsonl").read_bytes())
