"""3D conv backbones producing 4-level 256-channel pyramids (PyTorch
counterpart of ``instance_nerf_tpu.models.backbones``): VGG-FPN with the
split stage configs AF / DF / EF. Input ``(N, W, L, H, 4)``; outputs are
channels-last at strides {4, 8, 16, 32}."""
from __future__ import annotations

import torch.nn as nn

from instance_nerf_tpu_torch.models.fpn import FPN
from instance_nerf_tpu_torch.models.layers import ConvBlock, max_pool_3d

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
        if conv_at_start:
            raise NotImplementedError(
                "VGG_FPN(conv_at_start=True) comes with slice 5b (ROADMAP queue A)")
        self.input_size = input_size
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

    def forward(self, x):
        x = self.stem(x)
        if self.input_size >= 160:
            x = max_pool_3d(x, window=3, stride=2)
        features = []
        for stage in self.plan:
            for kind, name in stage:
                x = max_pool_3d(x, 2, 2) if kind == "pool" else getattr(self, name)(x)
            features.append(x)
        return self.fpn(features[-4:])


def build_backbone(backbone_type: str, input_size: int = 160,
                   in_channels: int = 4, conv_at_start: bool = False,
                   dtype=None):
    """Backbone factory (``vgg_AF`` / ``vgg_DF`` / ``vgg_EF``)."""
    if backbone_type.startswith("vgg"):
        cfg = backbone_type.split("_")[1] if "_" in backbone_type else "EF"
        return VGG_FPN(cfg=cfg, in_channels=in_channels, input_size=input_size,
                       conv_at_start=conv_at_start, dtype=dtype)
    if backbone_type == "resnet":
        raise NotImplementedError(
            "the ResNet-FPN backbone comes with slice 5b (ROADMAP queue A)")
    if backbone_type.startswith("swin"):
        raise NotImplementedError(
            "the Swin backbone comes with slice 5b (ROADMAP queue A)")
    raise ValueError(f"Unknown backbone type: {backbone_type}")
