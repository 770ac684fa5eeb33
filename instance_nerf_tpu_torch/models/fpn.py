"""3D Feature Pyramid Network neck (PyTorch counterpart of
``instance_nerf_tpu.models.fpn``): lateral 1x1 convs, nearest-upsample
top-down sums, 3x3 smoothing convs; extra levels by stride-2 subsampling
(``add_extra_convs=False``, the only form the VGG backbones use).

Given the levels' W layouts (``parallel/spatial.py``), every conv, the
top-down upsample and the extra levels' subsampling work on this rank's
rows of each level; ``forward`` then returns the outputs' layouts too."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from instance_nerf_tpu_torch.models.layers import Conv3d, max_pool_3d, upsample_nearest_to


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, dtype=None):
        super().__init__()
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv3d(c, out_channels, 1, dtype=dtype))
            self.add_module(f"fpn_conv_{i}",
                            Conv3d(out_channels, out_channels, 3, dtype=dtype))
        self.num_ins = len(in_channels)

    def forward(self, inputs: Sequence[torch.Tensor], layouts=None):
        """The levels; with ``layouts`` (the inputs'), (levels, their
        layouts)."""
        lay = list(layouts) if layouts is not None else [None] * self.num_ins
        laterals = [getattr(self, f"lateral_{i}")(inputs[i], lay[i])
                    for i in range(self.num_ins)]
        for i in range(self.num_ins - 1, 0, -1):  # top-down pathway
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
                laterals[i], laterals[i - 1].shape[1:4], lay[i], lay[i - 1])
        outs = [getattr(self, f"fpn_conv_{i}")(laterals[i], lay[i])
                for i in range(self.num_ins)]
        for _ in range(self.num_outs - self.num_ins):
            # global even rows: the pool's rows come from the owning ranks
            outs.append(max_pool_3d(outs[-1], window=1, stride=2, layout=lay[-1]))
            lay.append(None if layouts is None else lay[-1].strided(2))
        if layouts is None:
            return tuple(outs)
        return tuple(outs), tuple(lay)
