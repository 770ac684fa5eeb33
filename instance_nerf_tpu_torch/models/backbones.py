"""3D conv backbones producing 4-level 256-channel pyramids (PyTorch
counterpart of ``instance_nerf_tpu.models.backbones``): VGG-FPN with the
split stage configs AF / DF / EF, the ResNet-FPNs (``Bottleneck``,
``ResNet_FPN_256`` / ``ResNet_FPN_64``) and the single-level
``ResNetSimplified``; the 3D Swin Transformer is in ``swin.py``. Input
``(N, W, L, H, C)``; outputs are channels-last, at strides {4, 8, 16, 32}
for the backbones ``build_backbone`` returns. Every backbone exposes
``out_channels``. Module names are flax's (``ConvBlock_0``, ``stem``,
``layer{i}_block{b}``, ``lat_i``, ...), so ``convert.py`` maps a flax
params tree onto them.

``forward(x, layout)`` with a W layout (``parallel/spatial.py``) runs on
this rank's rows of a grid split over the mesh's ``sp`` ranks and returns
(levels, the levels' layouts).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.fpn import FPN
from instance_nerf_tpu_torch.models.layers import (
    Conv3d,
    ConvBlock,
    max_pool_3d,
    upsample_nearest_to,
)
from instance_nerf_tpu_torch.models.swin import SwinTransformerFPN, swin_config

def _strided(layout, stride: int):
    return None if layout is None else layout.strided(stride)


# "M" = maxpool, "F" = stage boundary (feature tap)
VGG_CFGS = {
    "AF": [64, 128, "F", 256, 256, "M", "F", 512, 512, "M", "F", 512, 512, "M", "F"],
    "DF": [64, 64, 128, 128, "F", 256, 256, 256, "M", "F", 512, 512, 512, "M", "F",
           512, 512, 512, "M", "F"],
    "EF": [64, 64, 128, 128, "F", 256, 256, 256, 256, "M", "F", 512, 512, 512, 512,
           "M", "F", 512, 512, 512, 512, "M", "F"],
}


class VGG_FPN(nn.Module):
    """VGG-style backbone + FPN neck (the shipped default is ``vgg_EF``)."""

    def __init__(self, cfg: str = "EF", in_channels: int = 4,
                 input_size: int = 160, conv_at_start: bool = False,
                 out_channels: int = 256, dtype=None):
        super().__init__()
        self.input_size, self.conv_at_start = input_size, conv_at_start
        self.out_channels = out_channels
        if conv_at_start:
            # two 32-channel convs ahead of the stem, and a stride-4 branch
            # projected to 128 channels and added to the first tap
            self.start_conv1 = ConvBlock(in_channels, 32, dtype=dtype)
            self.start_conv2 = ConvBlock(32, 32, dtype=dtype)
            self.ds_conv1 = ConvBlock(32, 32, stride=2, dtype=dtype)
            self.ds_conv2 = ConvBlock(32, 32, stride=2, dtype=dtype)
            self.ds_proj = ConvBlock(32, 128, kernel=1, dtype=dtype)
            in_channels = 32
        # stem: stride 4 (conv s2 + pool) for large grids, stride 1 for small
        stride = 2 if input_size >= 160 else 1
        self.stem = ConvBlock(in_channels, 64, kernel=7, stride=stride, dtype=dtype)
        self.plan = []  # per stage: list of ("conv", name) / ("pool", None)
        stage, li, c = [], 0, 64
        tap_channels = []
        for v in VGG_CFGS[cfg]:
            if v == "M":
                stage.append(("pool", None))
            elif v == "F":
                self.plan.append(stage)
                tap_channels.append(c)
                stage = []
            else:
                self.add_module(f"conv_{li}", ConvBlock(c, v, dtype=dtype))
                stage.append(("conv", f"conv_{li}"))
                li, c = li + 1, v
        self.fpn = FPN(tap_channels[-4:], out_channels, num_outs=4, dtype=dtype)

    def forward(self, x, layout=None):
        x_ds = None
        if self.conv_at_start:
            x = self.start_conv2(self.start_conv1(x, layout), layout)
            half = _strided(layout, 2)
            x_ds = self.ds_proj(self.ds_conv2(self.ds_conv1(x, layout), half),
                                _strided(half, 2))
        x = self.stem(x, layout)
        layout = _strided(layout, self.stem.conv.stride)
        if self.input_size >= 160:
            x = max_pool_3d(x, window=3, stride=2, layout=layout)
            layout = _strided(layout, 2)
        features, layouts = [], []
        for stage in self.plan:
            for kind, name in stage:
                if kind == "pool":
                    x = max_pool_3d(x, 2, 2, layout=layout)
                    layout = _strided(layout, 2)
                else:
                    x = getattr(self, name)(x, layout)
            features.append(x)
            layouts.append(layout)
        if x_ds is not None:
            features[0] = features[0] + x_ds
        return self.fpn(features[-4:], None if layout is None else layouts[-4:])


class Bottleneck(nn.Module):
    """3D ResNet bottleneck: 1x1 stride-s, 3x3, 1x1 to ``planes * 4``, plus
    the input (through the 1x1 ``downsample`` where the stride or the width
    changes), then ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, expansion: int = 4,
                 dtype=None):
        super().__init__()
        out_ch = planes * expansion
        self.ConvBlock_0 = ConvBlock(in_ch, planes, kernel=1, stride=stride, dtype=dtype)
        self.ConvBlock_1 = ConvBlock(planes, planes, kernel=3, dtype=dtype)
        self.ConvBlock_2 = ConvBlock(planes, out_ch, kernel=1, use_relu=False, dtype=dtype)
        self.downsample = (ConvBlock(in_ch, out_ch, kernel=1, stride=stride, use_relu=False,
                                     dtype=dtype)
                           if stride != 1 or in_ch != out_ch else None)
        self.out_ch, self.stride = out_ch, stride

    def forward(self, x, layout=None):
        out = _strided(layout, self.stride)
        y = self.ConvBlock_2(self.ConvBlock_1(self.ConvBlock_0(x, layout), out), out)
        residual = x if self.downsample is None else self.downsample(x, layout)
        return F.relu(y + residual)


def _resnet_layers(module: nn.Module, in_ch: int, base: int, layers: Sequence[int],
                   dtype) -> list[int]:
    """Add the ``layer{i}_block{b}`` bottlenecks (``base * 2^i`` planes,
    stride 2 at the first block of every stage after the first); returns
    each stage's output width."""
    widths = []
    for i, depth in enumerate(layers):
        for b in range(depth):
            block = Bottleneck(in_ch, base * 2 ** i, stride=2 if i > 0 and b == 0 else 1,
                               dtype=dtype)
            module.add_module(f"layer{i}_block{b}", block)
            in_ch = block.out_ch
        widths.append(in_ch)
    return widths


def _run_layers(module: nn.Module, x, layers: Sequence[int], layout=None):
    """Each stage's output and its W layout."""
    outs, layouts = [], []
    for i, depth in enumerate(layers):
        for b in range(depth):
            block = getattr(module, f"layer{i}_block{b}")
            x = block(x, layout)
            layout = _strided(layout, block.stride)
        outs.append(x)
        layouts.append(layout)
    return outs, layouts


def _top_down(module: nn.Module, c_out, lays, top_name: str, lat_offset: int):
    """A ResNet-FPN's pyramid: ``top_name`` on the last stage, then per stage
    ``i`` from the top the upsampled level above plus ``lat_{i + lat_offset}``,
    through ``smooth_i``. Returns the levels finest first (and their layouts
    with a W layout)."""
    p_out, p_lay = [getattr(module, top_name)(c_out[-1], lays[-1])], [lays[-1]]
    for i in range(len(c_out) - 1):
        lay = lays[-2 - i]
        lat_i = getattr(module, f"lat_{i + lat_offset}")(c_out[-2 - i], lay)
        p = upsample_nearest_to(p_out[-1], lat_i.shape[1:4], p_lay[-1], lay) + lat_i
        p_out.append(getattr(module, f"smooth_{i}")(p, lay))
        p_lay.append(lay)
    out = tuple(reversed(p_out))
    return out if lays[0] is None else (out, tuple(reversed(p_lay)))


class ResNet_FPN_256(nn.Module):
    """ResNet-FPN with its own top-down pathway: ``len(layers)`` levels at
    ``out_channels``, strides {2 * 2^i}, or {4 * 2^i} with ``is_max_pool``.
    ``lat_0`` takes the last stage; ``lat_{i+1}`` and ``smooth_i`` the
    stage ``i + 1`` from the top."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), in_planes: int = 64,
                 is_max_pool: bool = False, out_channels: int = 256, in_channels: int = 4,
                 dtype=None):
        super().__init__()
        self.layers, self.is_max_pool = tuple(layers), is_max_pool
        self.out_channels = out_channels
        self.stem = ConvBlock(in_channels, in_planes, kernel=7, stride=2, dtype=dtype)
        widths = _resnet_layers(self, in_planes, in_planes, self.layers, dtype)
        self.lat_0 = Conv3d(widths[-1], out_channels, 1, dtype=dtype)
        for i in range(len(self.layers) - 1):
            self.add_module(f"lat_{i + 1}",
                            Conv3d(widths[-2 - i], out_channels, 1, dtype=dtype))
            self.add_module(f"smooth_{i}", Conv3d(out_channels, out_channels, 3, dtype=dtype))

    def forward(self, x, layout=None):
        x = self.stem(x, layout)
        layout = _strided(layout, 2)
        if self.is_max_pool:
            x = max_pool_3d(x, window=3, stride=2, layout=layout)
            layout = _strided(layout, 2)
        c_out, lays = _run_layers(self, x, self.layers, layout)
        return _top_down(self, c_out, lays, "lat_0", 1)


class ResNet_FPN_64(nn.Module):
    """The stride-1-stem variant for 64^3 grids: a 16-channel stem,
    bottlenecks of 16 * 2^i planes, a 64-channel pyramid (``top`` on the
    last stage, ``lat_i`` / ``smooth_i`` below it)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), out_channels: int = 64,
                 in_channels: int = 4, dtype=None):
        super().__init__()
        self.layers, self.out_channels = tuple(layers), out_channels
        self.stem = ConvBlock(in_channels, 16, kernel=7, stride=1, dtype=dtype)
        widths = _resnet_layers(self, 16, 16, self.layers, dtype)
        self.top = Conv3d(widths[-1], out_channels, 1, dtype=dtype)
        for i in range(len(self.layers) - 1):
            self.add_module(f"lat_{i}", Conv3d(widths[-2 - i], out_channels, 1, dtype=dtype))
            self.add_module(f"smooth_{i}", Conv3d(out_channels, out_channels, 3, dtype=dtype))

    def forward(self, x, layout=None):
        c_out, lays = _run_layers(self, self.stem(x, layout), self.layers, layout)
        return _top_down(self, c_out, lays, "top", 0)


class ResNetSimplified(nn.Module):
    """Single-level debug backbone: a k7 stem (stride 2 and a pool with
    ``downsample``) and ``num_residuals`` two-conv residual blocks."""

    def __init__(self, out_channels: int = 64, num_residuals: int = 3,
                 downsample: bool = False, in_channels: int = 4, dtype=None):
        super().__init__()
        self.out_channels, self.num_residuals = out_channels, num_residuals
        self.downsample = downsample
        self.stem = ConvBlock(in_channels, out_channels, kernel=7,
                              stride=2 if downsample else 1, dtype=dtype)
        for i in range(num_residuals):
            self.add_module(f"res{i}_a", ConvBlock(out_channels, out_channels, dtype=dtype))
            self.add_module(f"res{i}_b", ConvBlock(out_channels, out_channels, use_relu=False,
                                                   dtype=dtype))

    def forward(self, x, layout=None):
        x = self.stem(x, layout)
        layout = _strided(layout, self.stem.conv.stride)
        if self.downsample:
            x = max_pool_3d(x, window=3, stride=2, layout=layout)
            layout = _strided(layout, 2)
        for i in range(self.num_residuals):
            y = getattr(self, f"res{i}_b")(getattr(self, f"res{i}_a")(x, layout), layout)
            x = F.relu(x + y)
        return (x,) if layout is None else ((x,), (layout,))


def build_backbone(backbone_type: str, input_size: int = 160,
                   in_channels: int = 4, conv_at_start: bool = False,
                   dtype=None):
    """Backbone factory: ``vgg_AF`` / ``vgg_DF`` / ``vgg_EF``, ``resnet``
    (``ResNet_FPN_256``, max-pooled stem from ``input_size`` 160 up) and
    ``swin_t`` / ``swin_s`` / ``swin_b`` / ``swin_l``."""
    if backbone_type.startswith("vgg"):
        cfg = backbone_type.split("_")[1] if "_" in backbone_type else "EF"
        return VGG_FPN(cfg=cfg, in_channels=in_channels, input_size=input_size,
                       conv_at_start=conv_at_start, dtype=dtype)
    if backbone_type == "resnet":
        return ResNet_FPN_256(is_max_pool=input_size >= 160, in_channels=in_channels,
                              dtype=dtype)
    if backbone_type.startswith("swin"):
        return SwinTransformerFPN(**swin_config(backbone_type), in_channels=in_channels,
                                  dtype=dtype)
    raise ValueError(f"Unknown backbone type: {backbone_type}")
