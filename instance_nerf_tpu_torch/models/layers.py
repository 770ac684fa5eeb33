"""Shared 3D building blocks (PyTorch counterpart of
``instance_nerf_tpu.models.layers``).

Public tensors are channels-last ``(N, W, L, H, C)`` as in the JAX package.
A conv views its input as NCDHW with channels-last strides
(``permute(0, 4, 1, 2, 3)``, no copy), which cuDNN takes directly, and
hands its output back the same way.

Dtype policy (``models/layers.py`` of the JAX package): params stay f32;
with ``dtype`` set (bf16 on the card by default) each layer casts its
input, weight and bias to it, as flax's ``promote_dtype`` does. GroupNorm
takes its statistics in f32 (flax ``force_float32_reductions``).

flax ``padding="SAME"`` pads ``lo = total // 2`` and ``hi = total - lo``
with ``total = max((out - 1) * s + k - n, 0)``: asymmetric at stride 2
(the k7 s2 stem on 200 pads 2 low and 3 high). Uneven pads go through an
explicit ``F.pad``.

Given a ``layout`` (``parallel/spatial.py:WLayout``), a tensor's W axis is
this rank's block of a global W split over the mesh's ``sp`` ranks: the
convs and pools take their W pads from the global size and fetch the rows
their output rows need from the neighbouring ranks (padding only past the
global edges), GroupNorm sums its statistics over the ranks, and the
nearest upsample reads its global source rows.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.parallel.spatial import (
    empty_rows,
    exchange,
    same_pads,
    sum_over,
    window_rows,
)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _cast(t, dtype):
    return t if dtype is None or t is None else t.to(dtype)


class Conv3d(nn.Module):
    """flax ``nn.Conv`` on NDHWC with ``padding="SAME"``.

    ``weight`` is OIDHW (torch layout), ``bias`` (O,)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, layout=None) -> torch.Tensor:
        x = _cast(x, self.dtype)
        weight, bias = _cast(self.weight, self.dtype), _cast(self.bias, self.dtype)
        pads = [same_pads(n, self.kernel, self.stride) for n in x.shape[1:4]]
        if layout is not None:
            # W: this rank's input rows with their halo, padded past the
            # global edges only
            out, want = window_rows(layout, self.kernel, self.stride)
            if any(w != (((lo, hi),) if hi > lo else ())
                   for w, (lo, hi) in zip(want, layout.owned)):
                x = exchange(x, layout, want)  # a pointwise conv takes no rows
            pads[0] = (0, 0)
            if out.hi == out.lo:
                shape = (x.shape[0], 0, *[-(-n // self.stride) for n in x.shape[2:4]],
                         weight.shape[0])
                return empty_rows(shape, x, x, weight, bias)
        x = to_ncdhw(x)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            # F.pad lists the last dim first
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        y = F.conv3d(x, weight, bias, stride=self.stride, padding=padding)
        return to_ndhwc(y)


class Linear(nn.Module):
    """flax ``nn.Dense``; ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        return F.linear(_cast(x, self.dtype), _cast(self.weight, self.dtype),
                        _cast(self.bias, self.dtype))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on channels-last input: eps 1e-6, stats in f32
    or wider (flax's ``force_float32_reductions``) with ``var = E[x^2] -
    E[x]^2`` clipped at 0."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, layout=None) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(n, math.prod(x.shape[1:-1]), g, c // g)
        if layout is None:
            mean = xg.mean(dim=(1, 3))  # (N, G)
            mean2 = (xg * xg).mean(dim=(1, 3))
        else:
            # the sums over the ranks' rows, then the global means
            sums = sum_over(torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))]),
                            layout)
            count = layout.size * math.prod(x.shape[2:-1]) * (c // g)
            mean, mean2 = sums[0] / count, sums[1] / count
        var = (mean2 - mean * mean).clamp_min(0.0)
        shape = (n,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(c // g, dim=1).reshape(shape)
        var = var.repeat_interleave(c // g, dim=1).reshape(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype or x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, as ``GroupNorm`` computes
    it: statistics in f32 or wider, ``var = E[x^2] - E[x]^2`` clipped at 0;
    the output in ``dtype``, else in the promoted type."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype or y.dtype)


class ConvBlock(nn.Module):
    """Conv3D -> GroupNorm -> ReLU (the ReLU left out with ``use_relu=False``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 32, use_relu: bool = True,
                 dtype=None):
        super().__init__()
        self.use_relu = use_relu
        self.conv = Conv3d(in_ch, features, kernel, stride, dtype=dtype)
        self.norm = GroupNorm(min(groups, features), features, dtype=dtype)

    def forward(self, x, layout=None):
        """``layout``: the input's (the output's is ``layout.strided(stride)``)."""
        out = None if layout is None else layout.strided(self.conv.stride)
        x = self.norm(self.conv(x, layout), out)
        return F.relu(x) if self.use_relu else x


def max_pool_3d(x: torch.Tensor, window: int = 2, stride: int = 2,
                padding: str = "SAME", layout=None) -> torch.Tensor:
    """3D max pool on NDHWC; ``SAME`` pads with -inf as flax does (a k2 s2
    pool on an odd size pads 0 low and 1 high). With a ``layout`` the W
    rows come with their halo, -inf past the global edges only."""
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    pads = [same_pads(n, window, stride) for n in x.shape[1:4]]
    if layout is not None:
        out, want = window_rows(layout, window, stride)
        x = exchange(x, layout, want, fill=-math.inf)
        pads[0] = (0, 0)
        if out.hi == out.lo:
            shape = (x.shape[0], 0, *[-(-n // stride) for n in x.shape[2:4]], x.shape[-1])
            return empty_rows(shape, x, x)
    xc = to_ncdhw(x)
    if any(lo or hi for lo, hi in pads):
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi],
                   value=-math.inf)
    if stride < window and xc.is_cuda and torch.are_deterministic_algorithms_enabled():
        return to_ndhwc(_max_pool_by_views(xc, window, stride))
    return to_ndhwc(F.max_pool3d(xc, window, stride))


def _max_pool_by_views(xc: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``F.max_pool3d(xc, window, stride)`` as the max over the window's
    strided views, for deterministic mode: the CUDA pool's backward adds
    overlapping windows' gradients with atomics, in no fixed order; here each
    window's gradient goes to its first maximum (the pool's choice, the views
    taken in its d, h, w scan order) and the views' gradients add in a fixed
    order."""
    out = [(n - window) // stride + 1 for n in xc.shape[2:]]
    views = [xc[:, :, i:i + stride * (out[0] - 1) + 1:stride,
                j:j + stride * (out[1] - 1) + 1:stride,
                k:k + stride * (out[2] - 1) + 1:stride]
             for i in range(window) for j in range(window) for k in range(window)]
    return torch.stack(views).max(dim=0).values


def upsample_nearest_to(x: torch.Tensor, target_spatial: Sequence[int], layout=None,
                        target=None) -> torch.Tensor:
    """Nearest upsample NDHWC to ``target_spatial`` as repeat by the ceil
    factor then crop (not ``F.interpolate(mode="nearest")``, whose index
    rule differs). With ``layout`` (the input's) and ``target`` (the
    output's) the W axis is split: output row ``i`` of the global
    ``target.size`` reads global source row ``i // factor``."""
    _, w, l, h, _ = x.shape
    tw, tl, th = target_spatial
    if layout is not None:
        f = -(-target.size // layout.size)
        lo, hi = target.lo, target.hi
        a = lo // f
        x = exchange(x, layout, [((q_lo // f, (q_hi - 1) // f + 1),) if q_hi > q_lo else ()
                                 for q_lo, q_hi in target.owned])
        x = x.repeat_interleave(f, dim=1)[:, lo - a * f:hi - a * f]
    else:
        x = x.repeat_interleave(-(-tw // w), dim=1)[:, :tw]
    x = x.repeat_interleave(-(-tl // l), dim=2)[:, :, :tl]
    x = x.repeat_interleave(-(-th // h), dim=3)[:, :, :, :th]
    return x
