"""Kernel B9's host side (``kernels/composite_cuda.py``) on the CPU: the
routing of ``models/render.py:composite`` (CPU tensors run the plain chain
and count no launch; anything else goes to B9, which refuses what it does
not take), the launch arguments, and ``composite_rays_plain`` /
``composite_rays_grad_plain``, the kernels' per-ray arithmetic in their
order, held to the plain chain and its autograd: in f32, and with bf16
``sigma_raw``, ``rgb`` and logits rounded where the chain rounds them; at K
= 1, 16 and 32, a fleet's leading axis and the head's strided
``sigma_raw``; every case holds a saturated ray (``sigma_raw`` = 15, where
the transmittance underflows to 0), a fully masked ray and rays with
``valid`` 0. The kernel itself is held to the plain chain on the card by the
last tests here (bit for bit) and by ``chip_smoke.py``
(``kernel_composite``).

No JAX here: the card tests run on a machine without it
(``python -m pytest --noconftest tests/test_torch_composite_kernel.py``).

Tolerances: f32 outputs within K f32 eps of their largest magnitude (the
chain's CPU ``cumprod`` and ``cumsum`` accumulate in f64 and its sums add in
another order; each of the mirror's K products or sums a ray errs by at most
half an ulp), the backward's within 2K (it walks the samples twice); a bf16
gradient within one bf16 ulp of the chain's for each place it is rounded to
bf16 (its f32 value may sit on the other side of a rounding boundary: rgb
and the logits are rounded once, sigma_raw's gradient before and after the
exp's backward, so a flip at the first carries into the second) plus that
f32 bound (where a ray's transmittance is all but 0, the two terms of a
density's gradient cancel to values of 1e-30 and less, whose bf16 ulps are
far below the f32 error of the terms).
"""
import ctypes
import warnings

import numpy as np
import pytest
import torch

from instance_nerf_tpu_torch.kernels import composite_cuda as C
from instance_nerf_tpu_torch.models import render as TR
from instance_nerf_tpu_torch.train import timing

torch.set_num_threads(2)

EPS = float(np.finfo(np.float32).eps)
HEAD = 16  # the heads' sigma_1 width (1 + geo_feat_dim): sigma_raw is h[..., 0]
# id: (lead, K, classes, bf16, strided sigma_raw, the outputs given a gradient)
CASES = {
    "field_k32_rgb": ((64,), 32, 0, False, True, ("rgb",)),
    "k1_instance": ((20,), 1, 3, False, False, ("rgb", "inst")),
    "k16_logits_only": ((50,), 16, 5, False, False, ("inst",)),
    "fleet_k16_bf16_rgb": ((3, 40), 16, 0, True, True, ("rgb",)),
    "fleet_k16_bf16_instance": ((3, 40), 16, 5, True, True, ("rgb", "inst")),
    "weights_only": ((40,), 16, 0, False, False, ("weights",)),
    "depth_only": ((40,), 16, 0, False, True, ("depth",)),
    "fleet_k32_acc_bf16": ((2, 24), 32, 0, True, False, ("acc", "rgb")),
}
OUTPUTS = ("rgb", "depth", "acc", "inst", "weights")
# the places a bf16 gradient is rounded to bf16
ROUNDINGS = {"sigma_raw": 2, "rgb": 1, "logits": 1}


def _inputs(lead, k, classes, bf16, seed=0):
    """numpy inputs of ``composite``: densities from -8 to 9 and a
    saturated ray (``sigma_raw`` = 15 throughout), a ray whose every sample
    is masked, 10% of rays with ``valid`` 0, t sorted in [near, near + span]
    and dt the ray's span / K (the renderer's expanded constant)."""
    rng = np.random.default_rng(seed)
    shape = (*lead, k)
    raw = rng.normal(0.5, 3.0, shape).astype(np.float32)
    raw.reshape(-1, k)[0] = 15.0
    rgb = rng.uniform(size=(*shape, 3)).astype(np.float32)
    logits = rng.normal(size=(*shape, classes)).astype(np.float32) if classes else None
    near = rng.uniform(0.1, 0.5, lead).astype(np.float32)
    span = rng.uniform(0.5, 1.2, lead).astype(np.float32)
    dt = np.broadcast_to((span / np.float32(k))[..., None], shape).astype(np.float32)
    t = (near[..., None] + np.sort(rng.uniform(size=shape), -1).astype(np.float32)
         * span[..., None]).astype(np.float32)
    mask = (rng.uniform(size=shape) < 0.7).astype(np.float32)
    mask.reshape(-1, k)[1] = 0.0
    valid = (rng.uniform(size=lead) < 0.9).astype(np.float32)
    valid.reshape(-1)[2] = 0.0
    if bf16:
        raw, rgb = C.round_bf16(raw), C.round_bf16(rgb)
        logits = None if logits is None else C.round_bf16(logits)
    return raw, rgb, logits, t, dt, mask, valid


def _torch_inputs(raw, rgb, logits, t, dt, mask, valid, bf16, strided, device="cpu"):
    """Torch tensors as the renderer hands them over: ``sigma_raw`` the
    column ``h[..., 0]`` of a head output where ``strided``, dt the expanded
    ``dt[..., :1]``; the field's tensors want a gradient."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    sig = torch.from_numpy(raw).to(device, dtype)
    if strided:
        h = torch.zeros((*raw.shape, HEAD), dtype=dtype, device=device)
        h[..., 0] = sig
        h.requires_grad_(True)
        sig = h[..., 0]
    else:
        sig.requires_grad_(True)
    col = torch.from_numpy(rgb).to(device, dtype).requires_grad_(True)
    lg = None if logits is None else torch.from_numpy(logits).to(device, dtype).requires_grad_(
        True)
    f32 = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (t, mask, valid)]
    dt_t = torch.from_numpy(np.ascontiguousarray(dt[..., :1])).to(device).expand(raw.shape)
    return sig, col, lg, f32[0], dt_t, f32[1], f32[2]


def _grads(lead, k, classes, given, seed=1):
    """The outputs' gradients ``{name: array}`` for the outputs ``given``."""
    rng = np.random.default_rng(seed)
    shapes = {"rgb": (*lead, 3), "depth": lead, "acc": lead, "inst": (*lead, classes),
              "weights": (*lead, k)}
    return {n: rng.normal(size=shapes[n]).astype(np.float32) for n in given}


def _chain(case):
    """The plain chain on the CPU at ``case``: its outputs and the gradients
    of sigma_raw, rgb and the logits (None where none reaches them), with the
    mirror's inputs."""
    lead, k, classes, bf16, strided, given = CASES[case]
    raw, rgb, logits, t, dt, mask, valid = _inputs(lead, k, classes, bf16)
    sig, col, lg, t_t, dt_t, mask_t, valid_t = _torch_inputs(raw, rgb, logits, t, dt, mask,
                                                             valid, bf16, strided)
    out = TR.composite_plain(sig, col, lg, t_t, dt_t, mask_t, valid_t)
    g = _grads(lead, k, classes, given)
    named = dict(zip(OUTPUTS, out))
    wrt = [x for x in (sig, col, lg) if x is not None]
    grads = torch.autograd.grad([named[n] for n in given], wrt,
                                [torch.from_numpy(g[n]) for n in given], allow_unused=True)
    grads = list(grads) + [None] * (3 - len(grads))
    return (raw, rgb, logits, t, dt, mask, valid), out, g, grads


def _close(got, want, bound, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound * scale, f"{what}: {err} > {bound} x {scale}"


def _bf16_close(got, want, bound, what, ulps=1):
    """bf16 values within ``ulps`` bf16 ulps of ``want`` (2^16 f32 spacings
    each) plus ``bound`` times its largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if not want.size:
        return
    room = np.spacing(np.abs(want)) * np.float32(ulps * 2 ** 16) + bound * np.abs(want).max()
    bad = np.abs(got - want) > room
    assert not bad.any(), f"{what}: {int(bad.sum())} beyond a bf16 ulp, e.g. {got[bad][:3]} " \
                          f"against {want[bad][:3]}"


@pytest.mark.parametrize("case", CASES)
def test_forward_mirror_is_the_chain(case):
    (raw, rgb, logits, t, dt, mask, valid), out, _, _ = _chain(case)
    k, bf16 = CASES[case][1], CASES[case][3]
    mine = C.composite_rays_plain(raw, rgb, logits, t, dt, mask, valid, bf16)
    for name, want, got in zip(OUTPUTS, out, mine):
        _close(got, want.detach().float().numpy(), k * EPS, name)
    assert mine[3].shape[-1] == CASES[case][2]
    # the saturated ray's transmittance underflows to 0 within its samples
    if k > 4:
        assert mine[5].reshape(-1, k)[0, -1] == 0.0


@pytest.mark.parametrize("case", CASES)
def test_backward_mirror_is_the_chains_autograd(case):
    (raw, rgb, logits, t, dt, mask, valid), _, g, grads = _chain(case)
    k, bf16, given = CASES[case][1], CASES[case][3], CASES[case][5]
    trans = C.composite_rays_plain(raw, rgb, logits, t, dt, mask, valid, bf16)[5]
    mine = C.composite_rays_grad_plain(raw, rgb, t, dt, mask, valid, trans,
                                       **{f"g_{n}": v for n, v in g.items()}, bf16=bf16)
    for name, want, got in zip(("sigma_raw", "rgb", "logits"), grads, mine):
        assert (want is None) == (got is None), name
        if want is None:
            continue
        want = want.float().numpy()
        if bf16:
            _bf16_close(got, want, 2 * k * EPS, name, ROUNDINGS[name])
        else:
            _close(got, want, 2 * k * EPS, name)
    if "inst" in given and len(given) == 1:  # the logits' path: nothing reaches the field
        assert mine[0] is None and mine[1] is None


def test_mirror_without_mask_or_valid_is_the_chain():
    raw, rgb, _, t, dt, _, _ = _inputs((30,), 16, 0, False)
    sig = torch.from_numpy(raw).requires_grad_(True)
    out = TR.composite_plain(sig, torch.from_numpy(rgb), None, torch.from_numpy(t),
                             torch.from_numpy(dt))
    g = _grads((30,), 16, 0, ("rgb",))["rgb"]
    (want,) = torch.autograd.grad(out.rgb, sig, torch.from_numpy(g))
    mine = C.composite_rays_plain(raw, rgb, None, t, dt)
    for name, w, m in zip(OUTPUTS, out, mine):
        _close(m, w.detach().numpy(), 16 * EPS, name)
    d_sigma, _, _ = C.composite_rays_grad_plain(raw, rgb, t, dt, None, None, mine[5], g_rgb=g)
    _close(d_sigma, want.numpy(), 32 * EPS, "sigma_raw")


def test_round_bf16_is_torchs():
    x = np.random.default_rng(3).normal(0, 100, 4096).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 3.0e38, 1e-40]
    want = torch.from_numpy(x).bfloat16().float().numpy()
    assert np.array_equal(C.round_bf16(x), want)
    assert np.isnan(C.round_bf16(np.float32(np.nan)))


def test_cpu_tensors_run_the_plain_chain_without_a_launch(monkeypatch):
    calls = []
    real = TR.composite_plain
    monkeypatch.setattr(TR, "composite_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = (C.launches, C.grad_launches)
    raw, rgb, logits, t, dt, mask, valid = _inputs((8,), 4, 2, False)
    ins = _torch_inputs(raw, rgb, logits, t, dt, mask, valid, False, True)
    out = TR.composite(*ins)
    (out.rgb.sum() + out.instance_logits.sum()).backward()
    assert calls == [1] and out.weights.shape == (8, 4)
    assert (C.launches, C.grad_launches) == before


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_b9_refuses_a_device_other_than_cuda(device):
    """Tensors off the CPU go to B9 (no fallback to the chain), which runs
    on CUDA alone; the wrapper itself refuses CPU tensors too."""
    sig, t, dt = (torch.zeros((5, 4), device=device) for _ in range(3))
    rgb = torch.zeros((5, 4, 3), device=device)
    if device != "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            TR.composite(sig, rgb, None, t, dt)
    with pytest.raises(ValueError, match="CUDA"):
        C.composite(sig, rgb, None, t, dt)


MISUSES = {
    "sigma_f64": TypeError, "rgb_other_type": TypeError, "t_bf16": TypeError,
    "valid_f64": TypeError, "sigma_one_axis": ValueError, "rgb_not_three": ValueError,
    "logits_other_samples": ValueError, "valid_per_sample": ValueError,
    "dt_other_shape": ValueError, "t_wants_grad": ValueError, "dt_wants_grad": ValueError,
    "mask_wants_grad": ValueError, "valid_wants_grad": ValueError,
}


@pytest.mark.parametrize("misuse", MISUSES)
def test_check_refuses_what_b9_does_not_take(misuse):
    ins = dict(sigma_raw=torch.zeros((6, 4)), rgb=torch.zeros((6, 4, 3)),
               logits=torch.zeros((6, 4, 5)), t=torch.zeros((6, 4)), dt=torch.zeros((6, 4)),
               occ_mask=torch.zeros((6, 4)), valid=torch.zeros(6))
    C.check(**ins)  # sound: no error
    C.check(**{**ins, "logits": None, "occ_mask": None, "valid": None})
    name = misuse.split("_")[0]
    key = {"sigma": "sigma_raw", "mask": "occ_mask"}.get(name, name)
    x = ins[key]
    bad = {"sigma_f64": x.double(), "rgb_other_type": x.bfloat16(), "t_bf16": x.bfloat16(),
           "valid_f64": x.double(), "sigma_one_axis": torch.zeros(6),
           "rgb_not_three": torch.zeros((6, 4, 4)), "logits_other_samples": torch.zeros((6, 3, 5)),
           "valid_per_sample": torch.zeros((6, 4)), "dt_other_shape": torch.zeros((6, 1)),
           }.get(misuse)
    if bad is None:  # wants a gradient
        bad = x.clone().requires_grad_(True)
    with pytest.raises(MISUSES[misuse]):
        C.check(**{**ins, key: bad})


def test_launch_arguments_mirror_the_kernel():
    """``_Args`` is ``csrc/composite.cu``'s ``CompositeArgs``: 22 pointers,
    S and R, 22 strides, K, I, the type and PyTorch's orders; the views fold
    a fleet's scene axis and read the head's column, the expanded dt and a
    sliced bucket in place."""
    assert ctypes.sizeof(C._Args) == 400
    assert C._Args.n_scenes.offset == 176 and C._Args.sigma_stride.offset == 192
    assert C._Args.n_samples.offset == 368 and C._Args.inst_lanes.offset == 392
    b, r, k = 3, 10, 4
    h = torch.zeros((b, r, k, HEAD), dtype=torch.bfloat16)
    t_all = torch.zeros((b, r, 8))  # a bucket's first K of Kmax = 8 columns
    dt = torch.zeros((b, r, 1)).expand(b, r, k)
    x = C._Inputs(h[..., 0], torch.zeros((b, r, k, 3), dtype=torch.bfloat16),
                  torch.zeros((b, r, k, 7), dtype=torch.bfloat16), t_all[..., :k], dt, None,
                  torch.zeros((b, r)))
    a = x.args()
    assert (a.n_scenes, a.n_rays, a.n_samples, a.n_classes, a.bf16) == (b, r, k, 7, 1)
    assert (a.scan_log_threads, a.sum_lanes, a.sum_vectorized, a.inst_lanes) == (4, 4, 0, 1)
    assert list(a.sigma_stride) == [r * k * HEAD, k * HEAD, HEAD]
    assert list(a.t_stride) == [r * 8, 8, 1] and list(a.dt_stride) == [r, 1, 0]
    assert list(a.rgb_stride) == [r * k * 3, k * 3, 3, 1]
    assert list(a.logits_stride) == [r * k * 7, k * 7, 7, 1]
    assert list(a.valid_stride) == [r, 1] and a.mask is None and a.sigma == h.data_ptr()
    one = C._Inputs(torch.zeros((r, k)), torch.zeros((r, k, 3)), None, torch.zeros((r, k)),
                    torch.zeros((r, k)), torch.zeros((r, k)), None).args()
    assert (one.n_scenes, one.n_classes, one.bf16, one.logits, one.valid) == (1, 0, 0, None,
                                                                              None)
    # two scene axes that do not fold into one: refused, not copied
    odd = torch.zeros((2, 3, r, k)).transpose(0, 1)
    with pytest.raises(ValueError, match="in place"):
        C._Inputs(odd, torch.zeros((3, 2, r, k, 3)), None, odd, odd, None, None)


@pytest.mark.parametrize("rows, k, want", [
    (32 * 1024, 16, 9),  # the fleet: the rows outnumber the columns 2^11 to 1,
    (4096, 32, 4),       # and PyTorch's uint32 arithmetic wraps to 512 threads
    (64, 32, 4), (16384, 96, 4), (1, 1, 4), (2, 1024, 9), (8, 256, 7),
])
def test_scan_threads_are_pytorchs(rows, k, want):
    assert C.scan_log_threads(rows, k) == want


@pytest.mark.parametrize("k, rows, want", [
    (16, 32 * 1024, (16, False)), (32, 4096, (32, False)), (24, 4096, (16, False)),
    (96, 4096, (32, False)), (96, 8, (64, False)), (128, 4096, (32, True)), (3, 10, (2, False)),
])
def test_sum_lanes_are_pytorchs(k, rows, want):
    assert C.sum_lanes(k, rows) == want


def test_outer_sums_split_only_vectors_of_many_samples():
    assert C.outer_sum_lanes(16, 32 * 1024, 3) == 1  # the colours, every K B9 takes
    assert C.outer_sum_lanes(128, 4096, 33) == 1  # 33 classes: one output a lane
    assert C.outer_sum_lanes(32, 4096, 4) == 1
    assert C.outer_sum_lanes(64, 4096, 4) == 4  # 4 classes: split over 4 warps


def test_mirror_scan_and_sum_are_a_scan_and_a_sum():
    x = np.random.default_rng(2).uniform(0.5, 1.5, (7, 100)).astype(np.float32)
    for lt in (4, 5, 9):  # chunks of 32 and 64 columns carried over, and one chunk
        np.testing.assert_allclose(C._scan(x, lt, mul=False), np.cumsum(x, -1), rtol=1e-5)
        np.testing.assert_allclose(C._scan(x, lt, mul=True), np.cumprod(x, -1), rtol=1e-5)
    for lanes, vec in ((1, False), (16, False), (64, False), (16, True)):
        np.testing.assert_allclose(C._sum(x, lanes, vec), x.sum(-1), rtol=1e-5)


# -- on the card ----------------------------------------------------------------

# the benchmark's cells: the field's 4096 rays at K = 32 in f32, the fleet's
# 32 scenes of 1024 rays at K = 16 in bf16 (instant-ngp's 33 classes in the
# instance stage)
CARD_CASES = {"field": ((4096,), 32, False), "fleet": ((32, 1024), 16, True)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on a machine with one "
                    "(python -m pytest --noconftest tests/test_torch_composite_kernel.py)")


@pytest.mark.parametrize("cell", CARD_CASES)
@pytest.mark.parametrize("stage", ["rgb", "instance"])
def test_b9_on_the_card_equals_the_plain_chain(cell, stage):
    """On a card, at the benchmark's shapes: B9's outputs and gradients
    equal the plain chain's run on the card bit for bit (the kernels follow
    the order of PyTorch's CUDA scan and sums on the chain's tensors); one
    launch each way."""
    _card()
    lead, k, bf16 = CARD_CASES[cell]
    classes = 33 if stage == "instance" else 0
    given = ("inst",) if stage == "instance" else ("rgb",)
    arrays = _inputs(lead, k, classes, bf16, seed=7)
    g = {n: torch.from_numpy(v).cuda() for n, v in _grads(lead, k, classes, given).items()}
    results = []
    for kernel in (True, False):
        ins = _torch_inputs(*arrays, bf16, True, "cuda")
        before = (C.launches, C.grad_launches)
        out = (TR.composite if kernel else TR.composite_plain)(*ins)
        named = dict(zip(OUTPUTS, out))
        wrt = [x for x in ins[:3] if x is not None]
        grads = torch.autograd.grad([named[n] for n in given], wrt, [g[n] for n in given],
                                    allow_unused=True)
        torch.cuda.synchronize()
        if kernel:
            assert (C.launches - before[0], C.grad_launches - before[1]) == (1, 1)
        results.append(([o.detach().float() for o in out],
                        [None if x is None else x.float() for x in grads]))
    (k_out, k_grads), (p_out, p_grads) = results
    for name, got, want in zip(OUTPUTS, k_out, p_out):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"{cell} {name}"
    for name, got, want in zip(("sigma_raw", "rgb", "logits"), k_grads, p_grads):
        assert (got is None) == (want is None), name
        if got is not None:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"{cell} {name}"
    with torch.no_grad():  # no gradient: the forward alone, one launch
        before = (C.launches, C.grad_launches)
        TR.composite(*_torch_inputs(*arrays, bf16, True, "cuda"))
        assert (C.launches - before[0], C.grad_launches - before[1]) == (1, 0)


def test_fleet_call_synchronises_only_at_the_read_back(monkeypatch):
    """On a card, a tiny fleet's call of 4 rgb steps (its kernels built by a
    first call) synchronises only inside ``Stages.read_back``, the metrics'
    ``float``: B9's backward reads nothing back; 4 launches each way."""
    _card()
    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig

    steps = 4
    cfg = NGPConfig(encoding="hash", n_levels=4, table_size=2 ** 10, n_features=2,
                    base_res=4, max_res=64, hidden=16, num_instances=4,
                    occ_update_every=steps, pallas_grad=True, n_rays=32, n_samples=8,
                    k_occupied=4, occ_res=8, occ_coarse_res=4, occ_subsample=0.25,
                    ray_jitter=True, dtype="bfloat16")
    rng = np.random.default_rng(0)
    scenes = [make_synthetic_nerf_scene(rng, n_views=3, hw=(16, 16), n_blobs=2)[0]
              for _ in range(2)]
    tr = MultiSceneFieldTrainer(scenes, cfg, seed=0, device_data=True, device="cuda")
    tr.train(steps, log_every=0)
    torch.cuda.synchronize()
    inside = []
    real = timing.Stages.read_back

    def read_back(self, values):
        inside.append(True)
        try:
            return real(self, values)
        finally:
            inside.pop()

    monkeypatch.setattr(timing.Stages, "read_back", read_back)
    syncs = []
    before = (C.launches, C.grad_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        monkeypatch.setattr(warnings, "showwarning", lambda message, *a, **k: syncs.append(
            (str(message), bool(inside))))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train(steps, log_every=0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [s for s in syncs if "called a synchronizing CUDA operation" in s[0]]
    assert syncs and all(at_read_back for _, at_read_back in syncs), syncs
    assert (C.launches - before[0], C.grad_launches - before[1]) == (steps, steps)
