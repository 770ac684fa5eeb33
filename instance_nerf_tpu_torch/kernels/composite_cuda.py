"""Volume compositing on the card: CUDA kernel B9 (``csrc/composite.cu``),
and the plain arithmetic its per-ray order is held to.

``composite`` computes what ``models/render.py:composite_plain`` does, the
weights of every sample and each ray's rgb, depth, opacity and instance
logits, in ONE launch that walks each ray's samples in depth order; a
fleet's leading scene axis and the head's strided ``sigma_raw`` column are
read in place. B9 replaces no TPU kernel (the JAX package's compositing is
plain jnp that XLA fuses); it exists because the plain chain is about twenty
launches each way and its ``cumprod``'s backward reads back to the host
whether any factor is 0, once a step (see the source).

Its gradient (``_Composite``, an autograd Function) is a second launch that
walks each ray's samples in reverse from the forward's saved transmittance
and returns the gradients of ``sigma_raw``, ``rgb`` and the logits, each in
its input's type; the logits' flows through the weights without gradient,
and none flows to ``t``, ``dt``, the mask or ``valid``, which must not need
one.

The kernels take their products and sums in the order of PyTorch's CUDA
kernels on the plain chain's tensors (its inner-dimension scan and its
reductions, whose configurations ``scan_log_threads``, ``sum_lanes`` and
``outer_sum_lanes`` compute from the shapes as PyTorch does), so that on the
card B9 equals the plain chain bit for bit, in bf16 too.

``composite_rays_plain`` and ``composite_rays_grad_plain`` are the kernels'
per-ray arithmetic in numpy, in their order: the CPU tests hold them to the
plain chain and its autograd, and the card tests hold the kernel to the
plain chain run there. ``launches`` and ``grad_launches`` count the
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from instance_nerf_tpu_torch.kernels import build

launches = 0
grad_launches = 0

_POINTERS = ("sigma", "rgb", "logits", "t", "dt", "mask", "valid", "out_rgb", "depth", "acc",
             "inst", "weights", "trans", "g_rgb", "g_depth", "g_acc", "g_weights", "g_inst",
             "d_sigma", "d_rgb", "d_logits", "stream")
_STRIDES = (("sigma", 3), ("rgb", 4), ("logits", 4), ("t", 3), ("dt", 3), ("mask", 3),
            ("valid", 2))


# the most samples a ray B9 takes (csrc/composite.cu: a ray's samples in a
# thread's registers or local memory)
MAX_SAMPLES = 128


class _Args(ctypes.Structure):
    """``csrc/composite.cu``'s ``CompositeArgs``."""
    _fields_ = [(f, ctypes.c_void_p) for f in _POINTERS] + [
        ("n_scenes", ctypes.c_longlong), ("n_rays", ctypes.c_longlong)] + [
        (f"{name}_stride", ctypes.c_longlong * n) for name, n in _STRIDES] + [
        (f, ctypes.c_int) for f in ("n_samples", "n_classes", "bf16", "scan_log_threads",
                                    "sum_lanes", "sum_vectorized", "inst_lanes")]


# -- the order of PyTorch's CUDA kernels on the plain version's tensors ---------

def _ceil_log2(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def _last_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def scan_log_threads(rows: int, k: int) -> int:
    """log2 of the threads a row of PyTorch's CUDA scan over the inner
    dimension of ``rows`` rows of ``k`` (``ScanUtils.cuh:
    get_log_num_threads_x_inner_scan``, in its uint32 arithmetic, which wraps
    where the rows outnumber the columns by more than 2^9): the scan runs
    over chunks of twice as many columns."""
    diff = (_ceil_log2(k) - _ceil_log2(rows)) & 0xFFFFFFFF
    return min(max(4, ((9 + diff) & 0xFFFFFFFF) // 2), 9)


def _block(dim0: int, dim1: int, threads: int = 512) -> tuple[int, int]:
    """``Reduce.cuh: ReduceConfig::set_block_dimension``: (width, height)."""
    d0 = _last_pow2(dim0) if dim0 < threads else threads
    d1 = _last_pow2(dim1) if dim1 < threads else threads
    width = min(d0, 32)
    height = min(d1, threads // width)
    return min(d0, threads // height), height


def sum_lanes(k: int, rows: int) -> tuple[int, bool]:
    """PyTorch's CUDA sum over the inner dimension of ``rows`` contiguous rows
    of ``k`` (``Reduce.cuh: setReduceConfig``): the lanes that share a row,
    and whether they load 4-sample vectors (rows of 128 or more)."""
    vectorized = k >= 128
    width, _ = _block(k // 4 if vectorized else k, rows)
    return width, vectorized


def outer_sum_lanes(k: int, rows: int, inner: int) -> int:
    """PyTorch's CUDA sum over the samples of ``rows`` contiguous ``(k,
    inner)`` blocks: the lanes that share an output (1 unless the samples
    are split across warps, which takes a vector of 4 outputs and 64
    samples or more)."""
    vec = 4 if inner % 4 == 0 else 2 if inner % 2 == 0 else 1
    _, height = _block(rows * inner // vec, k, 512 // vec)
    return height if k >= min(height * 16, 256) else 1


def check(sigma_raw, rgb, logits, t, dt, occ_mask=None, valid=None) -> None:
    """Refuse what B9 does not take: ``sigma_raw (..., R, K)`` (K at most
    ``MAX_SAMPLES``), ``rgb (..., R, K, 3)`` and ``logits (..., R, K, I)``
    (or None) of one type, f32 or bf16; ``t``, ``dt`` and ``occ_mask`` (or
    None) f32 of ``sigma_raw``'s shape, ``valid`` (or None) f32 ``(...,
    R)``; all on one device; a gradient wanted for ``t``, ``dt``, the mask
    or ``valid``."""
    if sigma_raw.dim() < 2 or not 0 < sigma_raw.shape[-1] <= MAX_SAMPLES:
        raise ValueError(f"composite: sigma_raw (..., R, K) with 0 < K <= {MAX_SAMPLES}, got "
                         f"{tuple(sigma_raw.shape)}")
    lead = tuple(sigma_raw.shape)
    dtype = sigma_raw.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"composite: sigma_raw must be float32 or bfloat16, got {dtype}")
    fields = {"rgb": rgb, "logits": logits}
    for name, x in fields.items():
        if x is not None and x.dtype != dtype:
            raise TypeError(f"composite: {name} is {x.dtype}, sigma_raw {dtype}: one type")
    exact = {"t": t, "dt": dt, "occ_mask": occ_mask, "valid": valid}
    for name, x in exact.items():
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"composite: {name} must be float32, got {x.dtype}")
    shapes = {"rgb": (rgb, (*lead, 3)), "t": (t, lead), "dt": (dt, lead),
              "occ_mask": (occ_mask, lead), "valid": (valid, lead[:-1])}
    for name, (x, want) in shapes.items():
        if x is not None and tuple(x.shape) != want:
            raise ValueError(f"composite: {name} {tuple(x.shape)}, want {want}")
    if logits is not None and (logits.dim() != len(lead) + 1 or tuple(logits.shape[:-1]) != lead):
        raise ValueError(f"composite: logits {tuple(logits.shape)}, want {lead} + (I,)")
    for name, x in {**fields, **exact}.items():
        if x is not None and x.device != sigma_raw.device:
            raise ValueError(f"composite: {name} on {x.device}, sigma_raw on {sigma_raw.device}")
    for name, x in exact.items():
        if x is not None and x.requires_grad:
            raise ValueError(f"composite: kernel B9 gives no gradient to {name}")


def _view(x: torch.Tensor, scenes: int, rays: int, k: int, *rest) -> torch.Tensor:
    """``x`` as ``(S, R, K, *rest)`` without a copy, or raise."""
    try:
        return x.view(scenes, rays, k, *rest)
    except RuntimeError as err:
        raise ValueError(f"composite: a {tuple(x.shape)} tensor of strides {x.stride()} does "
                         f"not fold to (scenes, rays, samples) in place") from err


class _Inputs:
    """The inputs' ``(S, R, K)`` views (``valid`` ``(S, R)``); ``classes``
    gives the backward I without the logits."""

    def __init__(self, sigma_raw, rgb, logits, t, dt, occ_mask, valid, classes=None):
        *scene_dims, self.rays, self.k = sigma_raw.shape
        self.lead = tuple(sigma_raw.shape[:-1])
        self.scenes = math.prod(scene_dims)
        s, r, k = self.scenes, self.rays, self.k
        self.sigma = _view(sigma_raw, s, r, k)
        self.rgb = _view(rgb, s, r, k, 3)
        self.logits = None if logits is None else _view(logits, s, r, k, logits.shape[-1])
        self.classes = (0 if logits is None else logits.shape[-1]) if classes is None else classes
        self.t, self.dt = _view(t, s, r, k), _view(dt, s, r, k)
        self.mask = None if occ_mask is None else _view(occ_mask, s, r, k)
        self.valid = None if valid is None else valid.view(s, r)
        self.dtype = sigma_raw.dtype
        self.device = sigma_raw.device

    def args(self) -> _Args:
        rows = self.scenes * self.rays
        lanes, vectorized = sum_lanes(self.k, rows)
        a = _Args(n_scenes=self.scenes, n_rays=self.rays, n_samples=self.k,
                  n_classes=self.classes, bf16=int(self.dtype == torch.bfloat16),
                  scan_log_threads=scan_log_threads(rows, self.k), sum_lanes=lanes,
                  sum_vectorized=int(vectorized),
                  inst_lanes=outer_sum_lanes(self.k, rows, max(self.classes, 1)))
        for name, _ in _STRIDES:
            x = getattr(self, name)
            if x is not None:
                setattr(a, name, x.data_ptr())
                getattr(a, f"{name}_stride")[:] = list(x.stride())
        return a


def _run(name: str, a: _Args, device: torch.device, what: str) -> None:
    err = build.call_on_stream(_call, device.index, _launch_fn(name), a)
    if err != 0:
        raise RuntimeError(f"composite {what} launch failed: CUDA error {err}")


def _call(fn, a, stream):
    a.stream = stream
    return fn(ctypes.byref(a))


def _forward(x: _Inputs, keep_trans: bool):
    """The forward's launch: ``(rgb, depth, acc, instance logits, weights)``
    in the caller's shapes, and the transmittance ``(S * R, K)`` where
    ``keep_trans``."""
    global launches
    f32 = dict(dtype=torch.float32, device=x.device)
    rgb = torch.empty((*x.lead, 3), **f32)
    depth = torch.empty(x.lead, **f32)
    acc = torch.empty(x.lead, **f32)
    inst = torch.empty((*x.lead, x.classes), **f32)
    weights = torch.empty((*x.lead, x.k), **f32)
    trans = torch.empty((*x.lead, x.k), **f32) if keep_trans else None
    a = x.args()
    a.out_rgb, a.depth, a.acc, a.weights = (
        rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), weights.data_ptr())
    if x.logits is not None:
        a.inst = inst.data_ptr()
    if trans is not None:
        a.trans = trans.data_ptr()
    _run("composite_launch", a, x.device, "forward")
    launches += 1
    return (rgb, depth, acc, inst, weights), trans


def _contiguous_f32(g):
    """A gradient that arrived, contiguous f32, or None."""
    return None if g is None else g.to(torch.float32).contiguous()


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma_raw, rgb, logits, t, dt, occ_mask, valid):
        ctx.set_materialize_grads(False)
        x = _Inputs(sigma_raw, rgb, logits, t, dt, occ_mask, valid)
        outs, trans = _forward(x, keep_trans=True)
        ctx.save_for_backward(sigma_raw, rgb, t, dt, occ_mask, valid, trans)
        ctx.classes = x.classes
        if logits is None:
            ctx.mark_non_differentiable(outs[3])
        return outs

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc, g_inst, g_weights):
        global grad_launches
        sigma_raw, rgb, t, dt, occ_mask, valid, trans = ctx.saved_tensors
        x = _Inputs(sigma_raw, rgb, None, t, dt, occ_mask, valid, ctx.classes)
        want = ctx.needs_input_grad
        to_weights = (g_rgb, g_depth, g_acc, g_weights)
        d_sigma = d_rgb = d_logits = None
        like = dict(dtype=x.dtype, device=x.device)
        if want[0] and any(g is not None for g in to_weights):
            d_sigma = torch.empty((*x.lead, x.k), **like)
        if want[1] and g_rgb is not None:
            d_rgb = torch.empty((*x.lead, x.k, 3), **like)
        if want[2] and g_inst is not None:
            d_logits = torch.empty((*x.lead, x.k, x.classes), **like)
        if d_sigma is None and d_rgb is None and d_logits is None:
            return (None,) * 7
        a = x.args()
        a.trans = trans.data_ptr()
        grads = [_contiguous_f32(g) for g in (g_rgb, g_depth, g_acc, g_weights, g_inst)]
        for name, g in zip(("g_rgb", "g_depth", "g_acc", "g_weights", "g_inst"), grads):
            if g is not None:
                setattr(a, name, g.data_ptr())
        for name, d in (("d_sigma", d_sigma), ("d_rgb", d_rgb), ("d_logits", d_logits)):
            if d is not None:
                setattr(a, name, d.data_ptr())
        _run("composite_grad_launch", a, x.device, "backward")
        grad_launches += 1
        return d_sigma, d_rgb, d_logits, None, None, None, None


def composite(sigma_raw, rgb, logits, t, dt, occ_mask=None, valid=None):
    """``models/render.py:composite`` on the card: ``(rgb (..., R, 3), depth
    (..., R), acc (..., R), instance logits (..., R, I), weights (..., R,
    K))`` from ``sigma_raw (..., R, K)``, kernel B9. With a gradient to take
    (``sigma_raw``, ``rgb`` or ``logits`` needing one), the backward is B9's
    second launch. Anything ``check`` refuses raises: no fallback."""
    if sigma_raw.device.type != "cuda":
        raise ValueError(f"composite: kernel B9 runs on a CUDA device, not {sigma_raw.device}")
    check(sigma_raw, rgb, logits, t, dt, occ_mask, valid)
    diff = (sigma_raw, rgb) if logits is None else (sigma_raw, rgb, logits)
    if torch.is_grad_enabled() and any(v.requires_grad for v in diff):
        return _Composite.apply(sigma_raw, rgb, logits, t, dt, occ_mask, valid)
    return _forward(_Inputs(sigma_raw, rgb, logits, t, dt, occ_mask, valid), False)[0]


@functools.lru_cache(maxsize=None)
def _launch_fn(name: str):
    """``csrc/composite.cu``'s launch function ``name``, typed (built on
    first use)."""
    return build.typed("composite", name, [ctypes.POINTER(_Args)])


# -- the kernels' arithmetic in numpy ------------------------------------------

def round_bf16(x) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32; NaN
    kept."""
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    r = (((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, r)


def _sample(raw, mask, dt, bf16: bool):
    """``csrc/composite.cu:sample``: (sigma, e, alpha) of f32 arrays."""
    rnd = round_bf16 if bf16 else np.float32
    with np.errstate(over="ignore", invalid="ignore"):
        sigma = rnd(np.exp(np.clip(raw, np.float32(-15), np.float32(15))))
        e = np.exp(-(sigma * mask) * dt)
    return sigma, e, np.float32(1) - e


def _factor(alpha):
    return (np.float32(1) - alpha) + np.float32(1e-10)


def _f32(x, shape):
    return np.broadcast_to(np.ones((), np.float32) if x is None
                           else np.asarray(x, np.float32), shape)


def _scan(x, log_threads: int, mul: bool) -> np.ndarray:
    """``csrc/composite.cu:scan`` along the last axis of ``x`` (a copy)."""
    x = np.array(x, np.float32)
    k, width = x.shape[-1], 2 << log_threads
    op = np.multiply if mul else np.add
    total = None
    for c0 in range(0, k, width):
        if total is not None:
            x[..., c0] = op(x[..., c0], total)
        s = 1
        while s < width:
            for t in range(s, min(width, k - c0)):
                if t & s:
                    x[..., c0 + t] = op(x[..., c0 + t], x[..., c0 + ((t & ~(2 * s - 1)) | (s - 1))])
            s <<= 1
        if c0 + width <= k:
            total = x[..., c0 + width - 1].copy()
    return x


def _sum(x, lanes: int, vectorized: bool) -> np.ndarray:
    """``csrc/composite.cu:sum`` over the last axis of ``x``."""
    x = np.asarray(x, np.float32)
    k = x.shape[-1]
    lane = []
    for l in range(lanes):
        acc = [np.zeros(x.shape[:-1], np.float32) for _ in range(4)]
        if vectorized:
            for e in range(4 * l, k - 3, 4 * lanes):
                for q in range(4):
                    acc[q] = acc[q] + x[..., e + q]
        else:
            for j, e in enumerate(range(l, k, lanes)):
                acc[j & 3] = acc[j & 3] + x[..., e]
        lane.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = lanes >> 1
    while off:
        for l in range(off):
            lane[l] = lane[l] + lane[l + off]
        off >>= 1
    return lane[0]


def _orders(shape, classes: int = 1):
    """The scan's and the sums' configurations for inputs of ``shape``
    ``(..., R, K)``, as ``_Inputs.args`` gives them to the kernels."""
    rows, k = int(np.prod(shape[:-1])), shape[-1]
    return (scan_log_threads(rows, k), *sum_lanes(k, rows),
            outer_sum_lanes(k, rows, max(classes, 1)))


def composite_rays_plain(sigma_raw, rgb, logits, t, dt, mask=None, valid=None,
                         bf16: bool = False):
    """B9's forward in numpy, in its order: ``sigma_raw``, ``t``, ``dt`` and
    ``mask`` ``(..., R, K)``, ``rgb (..., R, K, 3)``, ``logits (..., R, K,
    I)`` or None, ``valid (..., R)`` or None, f32 arrays (``bf16``: the
    inputs hold bf16 values and the activation is rounded to bf16). Returns
    ``(rgb, depth, acc, instance logits, weights, trans)``, ``trans`` the
    exclusive transmittance the backward reads."""
    raw = np.asarray(sigma_raw, np.float32)
    shape = raw.shape
    n = 0 if logits is None else np.shape(logits)[-1]
    log_threads, lanes, vectorized, inst_lanes = _orders(shape, n)
    mask, dt, t = _f32(mask, shape), _f32(dt, shape), _f32(t, shape)
    v = _f32(valid, shape[:-1])
    rgb = np.asarray(rgb, np.float32)
    _, _, alpha = _sample(raw, mask, dt, bf16)
    prod = _scan(_factor(alpha), log_threads, mul=True)
    trans = np.concatenate([np.ones((*shape[:-1], 1), np.float32), prod[..., :-1]], -1)
    weights = (alpha * trans) * v[..., None]
    out = np.stack([_sum(weights * rgb[..., c], 1, False) for c in range(3)], -1)
    depth = _sum(weights * t, lanes, vectorized)
    acc = _sum(weights, lanes, vectorized)
    inst = np.zeros((*shape[:-1], n), np.float32)
    if logits is not None:
        logits = np.asarray(logits, np.float32)
        res = np.float32(1) - acc
        bg = np.where(np.isnan(res), res, np.maximum(res, np.float32(0)))
        for c in range(n):
            inst[..., c] = (_sum(weights * logits[..., c], inst_lanes, False)
                            + bg * np.float32(10 if c == 0 else 0))
    return out, depth, acc, inst, weights, trans


def composite_rays_grad_plain(sigma_raw, rgb, t, dt, mask, valid, trans, g_rgb=None,
                              g_depth=None, g_acc=None, g_weights=None, g_inst=None,
                              bf16: bool = False):
    """B9's backward in numpy, in its order: the forward's inputs (``mask``,
    ``valid`` or None), its ``trans`` and the outputs' gradients that
    arrived (None for the rest) -> ``(d_sigma, d_rgb, d_logits)``, each None
    where no gradient reaches it, rounded to bf16 with ``bf16``."""
    raw = np.asarray(sigma_raw, np.float32)
    shape, k = raw.shape, raw.shape[-1]
    log_threads = _orders(shape)[0]
    mask, dt, t = _f32(mask, shape), _f32(dt, shape), _f32(t, shape)
    v = _f32(valid, shape[:-1])[..., None]
    rgb = np.asarray(rgb, np.float32)
    trans = np.asarray(trans, np.float32)
    rnd = round_bf16 if bf16 else np.float32
    sigma, e, alpha = _sample(raw, mask, dt, bf16)
    w = (alpha * trans) * v
    d_rgb = None if g_rgb is None else rnd(np.asarray(g_rgb, np.float32)[..., None, :]
                                           * w[..., None])
    d_logits = None if g_inst is None else rnd(np.asarray(g_inst, np.float32)[..., None, :]
                                               * w[..., None])
    if all(g is None for g in (g_rgb, g_depth, g_acc, g_weights)):
        return None, d_rgb, d_logits
    dw = np.zeros(shape, np.float32)
    if g_rgb is not None:
        g = np.asarray(g_rgb, np.float32)[..., None, :]
        dw = (g[..., 0] * rgb[..., 0] + g[..., 2] * rgb[..., 2]) + g[..., 1] * rgb[..., 1]
    if g_depth is not None:
        dw = dw + np.asarray(g_depth, np.float32)[..., None] * t
    if g_acc is not None:
        dw = dw + np.asarray(g_acc, np.float32)[..., None]
    if g_weights is not None:
        dw = dw + np.asarray(g_weights, np.float32)
    dw0 = dw * v
    f = _factor(alpha)
    last = trans[..., -1:] * f[..., -1:]
    prod = np.concatenate([trans[..., 1:], last], -1)  # P[k] = T[k + 1]
    dprod = np.concatenate([(dw0 * alpha)[..., 1:], np.zeros_like(last)], -1)
    rev = _scan((prod * dprod)[..., ::-1], log_threads, mul=False)[..., ::-1]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        dalpha = dw0 * trans - rev / f
        dsm = -((-dalpha * e) * dt)
    dc = rnd(rnd(dsm * mask) * sigma)
    d_sigma = np.where((raw >= -15) & (raw <= 15), dc, np.float32(0))
    return d_sigma, d_rgb, d_logits
