"""3D Swin Transformer backbone + FPN (PyTorch counterpart of
``instance_nerf_tpu.models.swin``), channels-last ``(N, W, L, H, C)``.

Patch embed (a k4 s4 conv), four stages of shifted-window attention blocks
with 8-way patch merging between them, and the FPN neck: four 256-channel
levels at strides {4, 8, 16, 32}. Variants ``swin_t`` / ``swin_s`` /
``swin_b`` / ``swin_l`` (patch 4^3, window 4^3).

Attention is plain torch: einsum -> relative-position bias and shift mask
-> softmax -> einsum, as the JAX package leaves it to XLA. The bias table
is an f32 parameter added to the scores, so with a bf16 ``dtype`` the
scores are promoted to f32 there and the mask, the softmax and ``attn @ v``
run in f32, as JAX promotes them; ``proj`` casts back. The relative
position index and the shift mask are host constants, built once per
(padded spatial size, window, shift) on the tensor's device and cached.

Stochastic depth (``drop_path``) acts only with ``deterministic=False``;
its per-example keep mask is drawn from the explicit ``generator``.

With a W layout (``parallel/spatial.py``) the grid's W axis is split over
the mesh's ``sp`` ranks. The patch embed and the FPN are the layers' split
convs; the window attention gathers whole windows of the cyclically
shifted, padded global W (``blocks`` of the windows, so a rank's windows
are contiguous), the wrap from the last row to the first included, takes
the shift mask's rows of those windows, and sends the outputs back to the
rows' owners un-shifted; patch merging fetches its input's pairs of rows.
The window size, the pad and "no shift where the window covers the axis"
follow the global W.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.fpn import FPN
from instance_nerf_tpu_torch.models.layers import Conv3d, LayerNorm, Linear
from instance_nerf_tpu_torch.parallel.spatial import blocks, exchange, wrapped

SWIN_CONFIGS = {
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


def swin_config(name: str) -> dict:
    return dict(SWIN_CONFIGS[name])


def relative_position_index(window: Sequence[int]) -> np.ndarray:
    """(N, N) index into the (2w0-1)(2w1-1)(2w2-1)-row bias table."""
    coords = np.stack(
        np.meshgrid(*[np.arange(w) for w in window], indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)  # (N, N, 3)
    rel[..., 0] += window[0] - 1
    rel[..., 1] += window[1] - 1
    rel[..., 2] += window[2] - 1
    rel[..., 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[..., 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def shift_attention_mask(spatial, window, shift) -> np.ndarray:
    """(nW, N, N) additive f32 mask: -100 between tokens of a window that
    come from different regions of the cyclic shift, else 0."""
    w_, l_, h_ = spatial
    region = np.zeros(spatial, np.int32)
    count = 0

    def slices(ws, ss):
        if not ss:
            return (slice(None),)
        return slice(0, -ws), slice(-ws, -ss), slice(-ss, None)

    for hs in slices(window[0], shift[0]):
        for ws in slices(window[1], shift[1]):
            for ds in slices(window[2], shift[2]):
                region[hs, ws, ds] = count
                count += 1
    r = region.reshape(
        w_ // window[0], window[0], l_ // window[1], window[1], h_ // window[2], window[2]
    ).transpose(0, 2, 4, 1, 3, 5).reshape(-1, window[0] * window[1] * window[2])
    diff = r[:, None, :] - r[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# Bounded: a shift mask is (nW, N, N) f32 on the card (16 MB at 160^3's
# first stage), one per padded scene size an eval meets. Built outside
# inference mode, so that a constant first made by an eval serves a later
# train step's autograd.
@functools.lru_cache(maxsize=16)
def _rel_index(window: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(relative_position_index(window).reshape(-1), device=device)


@functools.lru_cache(maxsize=16)
def _shift_mask(spatial: tuple, window: tuple, shift: tuple,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(shift_attention_mask(spatial, window, shift), device=device)


def _drop_path(res, rate: float, deterministic: bool, generator):
    """Per-example stochastic depth: keep with probability ``1 - rate``
    (a uniform draw below it) and rescale by it."""
    if rate == 0.0 or deterministic:
        return res
    keep = 1.0 - rate
    u = torch.rand((res.shape[0],) + (1,) * (res.dim() - 1), generator=generator,
                   device=res.device)
    return res * (u < keep).to(res.dtype) / keep


class ShiftedWindowAttention3D(nn.Module):
    def __init__(self, dim: int, window: Sequence[int], shift: Sequence[int],
                 num_heads: int, dtype=None):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        w = self.window
        self.rel_pos_bias_table = nn.Parameter(
            torch.zeros((2 * w[0] - 1) * (2 * w[1] - 1) * (2 * w[2] - 1), num_heads))

    def forward(self, x, layout=None):
        b, w_, l_, h_, c = x.shape
        win, heads = self.window, self.num_heads
        if layout is not None:
            w_ = layout.size
        # pad to window multiples (F.pad lists the last dim first); a split
        # W is padded by the fetch below, past the global end only
        x = F.pad(x, (0, 0, 0, (-h_) % win[2], 0, (-l_) % win[1],
                      0, 0 if layout is not None else (-w_) % win[0]))
        W = w_ + (-w_) % win[0]
        L, H = x.shape[2:4]
        # no shift along an axis the window covers whole
        shift = tuple(0 if win[i] >= (W, L, H)[i] else self.shift[i] for i in range(3))
        shifted = sum(shift) > 0
        wlo, whi = 0, W // win[0]  # this rank's windows along W
        if layout is not None:
            # whole windows of the shifted axis: window row j is global row
            # (j + shift) mod W, zero at and past the global end
            wins = blocks(W // win[0], layout.parts)
            wlo, whi = wins[layout.index]
            x = exchange(x, layout, [wrapped(lo * win[0] + shift[0], hi * win[0] + shift[0], W)
                                     for lo, hi in wins])
            x = torch.roll(x, (-shift[1], -shift[2]), dims=(2, 3)) if shifted else x
        elif shifted:
            x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
        nww = whi - wlo
        nw = nww * (L // win[1]) * (H // win[2])
        n = win[0] * win[1] * win[2]
        xw = x.reshape(b, nww, win[0], L // win[1], win[1], H // win[2], win[2], c)
        xw = xw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b * nw, n, c)

        qkv = self.qkv(xw).reshape(b * nw, n, 3, heads, c // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B*nW, N, h, d)
        q = q * (c // heads) ** -0.5
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        bias = self.rel_pos_bias_table[_rel_index(win, x.device)].reshape(n, n, heads)
        # the f32 bias promotes the scores (and all below) to f32
        attn = attn + bias.permute(2, 0, 1)[None]
        if shifted:
            mask = _shift_mask((W, L, H), win, shift, x.device)
            # the rows of this rank's windows (the mask is W-window-major)
            mask = mask.reshape(W // win[0], -1, n, n)[wlo:whi].reshape(nw, n, n)
            attn = attn.reshape(b, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(b * nw, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(attn.dtype)).reshape(b * nw, n, c)
        out = self.proj(out)

        out = out.reshape(b, nww, L // win[1], H // win[2], win[0], win[1], win[2], c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, nww * win[0], L, H, c)
        if layout is not None:
            out = torch.roll(out, shift[1:], dims=(2, 3)) if shifted else out
            # global row i is window row (i - shift) mod W
            out = exchange(out, layout, [wrapped(lo - shift[0], hi - shift[0], W)
                                         for lo, hi in layout.owned],
                           owned=[(lo * win[0], hi * win[0]) for lo, hi in wins], size=W)
            return out[:, :, :l_, :h_]
        if shifted:
            out = torch.roll(out, shift, dims=(1, 2, 3))
        return out[:, :w_, :l_, :h_]


class SwinBlock(nn.Module):
    """LN -> window attention -> residual; LN -> MLP (tanh GELU, flax's
    ``nn.gelu``) -> residual; each residual branch through stochastic depth."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int],
                 shift: Sequence[int], mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype=None):
        super().__init__()
        self.drop_path = drop_path
        hidden = int(dim * mlp_ratio)
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.attn = ShiftedWindowAttention3D(dim, window, shift, num_heads, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)
        self.Dense_0 = Linear(dim, hidden, dtype)
        self.Dense_1 = Linear(hidden, dim, dtype)

    def forward(self, x, deterministic: bool = True, generator=None, layout=None):
        h = self.attn(self.LayerNorm_0(x), layout)
        x = x + _drop_path(h, self.drop_path, deterministic, generator)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        h = self.Dense_1(h)
        return x + _drop_path(h, self.drop_path, deterministic, generator)


class PatchMerging3D(nn.Module):
    """8-way 2x downsample: odd sizes padded, the 2^3 sub-lattices
    concatenated (dx, dy, dz over (0, 1)), LN, a linear map without bias."""

    def __init__(self, in_dim: int, out_dim: int, dtype=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(8 * in_dim, dtype=dtype)
        self.Dense_0 = Linear(8 * in_dim, out_dim, dtype, bias=False)

    def forward(self, x, layout=None):
        _, w, l, h, _ = x.shape
        if layout is not None:
            # global rows 2i and 2i + 1 of each output row i, zero past the end
            x = exchange(x, layout, [((2 * lo, 2 * hi),) if hi > lo else ()
                                     for lo, hi in layout.strided(2).owned])
            w = 0
        x = F.pad(x, (0, 0, 0, h % 2, 0, l % 2, 0, w % 2))
        parts = [x[:, dx::2, dy::2, dz::2, :]
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        return self.Dense_0(self.LayerNorm_0(torch.cat(parts, dim=-1)))


class SwinTransformerFPN(nn.Module):
    """Patch embed + 4 Swin stages + FPN neck -> four ``out_channels``
    levels at strides {4, 8, 16, 32}."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 patch_size: Sequence[int] = (4, 4, 4), window: Sequence[int] = (4, 4, 4),
                 mlp_ratio: float = 4.0, stochastic_depth_prob: float = 0.1,
                 expand_dim: bool = True, out_channels: int = 256, in_channels: int = 4,
                 dtype=None):
        super().__init__()
        if len(set(patch_size)) != 1:
            raise ValueError(f"patch_size must be cubic, got {tuple(patch_size)}")
        self.depths, self.out_channels = tuple(depths), out_channels
        self.patch_embed = Conv3d(in_channels, embed_dim, patch_size[0], patch_size[0],
                                  dtype=dtype)
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype=dtype)
        total = sum(depths)
        block_id, dims, prev = 0, [], embed_dim
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i if expand_dim else embed_dim
            if i > 0:
                self.add_module(f"merge_{i}", PatchMerging3D(prev, dim, dtype=dtype))
            for j in range(depth):
                sd = stochastic_depth_prob * block_id / max(total - 1, 1)
                shift = [0 if j % 2 == 0 else w // 2 for w in window]
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, num_heads[i], window, shift, mlp_ratio=mlp_ratio, drop_path=sd,
                    dtype=dtype))
                block_id += 1
            dims.append(dim)
            prev = dim
        self.fpn = FPN(dims, out_channels, num_outs=4, dtype=dtype)

    def forward(self, x, deterministic: bool = True, generator=None, layout=None):
        x = self.LayerNorm_0(self.patch_embed(x, layout))
        if layout is not None:
            layout = layout.strided(self.patch_embed.stride)
        features, layouts = [], []
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f"merge_{i}")(x, layout)
                layout = None if layout is None else layout.strided(2)
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, deterministic, generator, layout)
            features.append(x)
            layouts.append(layout)
        return self.fpn(features, None if layout is None else layouts)
