"""Legacy two-stage proposal classification path (PyTorch counterpart of
``instance_nerf_tpu.models.legacy_classifier``).

``ProposalClassifier`` scores pooled RoI features: a conv tower with ReLU
(flax ``SAME`` padding), the features flattened channels-last, two dense
layers with ReLU and the class scores; leading dims are flattened and
restored. Its parameter names are the flax module's (``conv0`` ...,
``fc1``, ``fc2``, ``cls``), so ``convert.legacy_classifier_params_from_jax``
maps a flax tree onto it.

``LegacyProposalScorer`` is the path's entry on a device: the legacy
ROIPool (``ops/legacy_roi_pool.py``) of a scene's proposals from its FPN
levels, then the classifier.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.models.layers import Conv3d, Linear
from instance_nerf_tpu_torch.ops.legacy_roi_pool import legacy_roi_pool


class ProposalClassifier(nn.Module):
    """Conv tower + MLP over pooled RoI features -> objectness / class
    scores. ``in_channels`` and ``pooled_size`` fix the shapes flax infers at
    its first call."""

    def __init__(self, in_channels: int, pooled_size: Sequence[int] = (1, 1, 1),
                 num_classes: int = 2, conv_channels: Sequence[int] = (256, 256),
                 rep_size: int = 512, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        ch = in_channels
        for i, out in enumerate(conv_channels):
            self.add_module(f"conv{i}", Conv3d(ch, out, 3, dtype=dtype))
            ch = out
        self.n_convs = len(conv_channels)
        self.fc1 = Linear(ch * math.prod(pooled_size), rep_size, dtype=dtype)
        self.fc2 = Linear(rep_size, rep_size, dtype=dtype)
        self.cls = Linear(rep_size, num_classes, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """``(..., w, l, h, C)`` -> ``(..., num_classes)``."""
        lead = pooled.shape[:-4]
        x = pooled.reshape(-1, *pooled.shape[-4:])
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls(x).reshape(*lead, self.num_classes)


def init_legacy_classifier(model: ProposalClassifier, seed: int) -> None:
    """Seeded random init with flax's defaults: lecun-normal kernels (a
    normal truncated at two std, variance 1 / fan_in), zero biases. The
    numbers differ from JAX's (another generator)."""
    from instance_nerf_tpu_torch.train.rcnn_trainer import _trunc_normal

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv3d, Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(_trunc_normal(mod.weight.shape, math.sqrt(1.0 / fan_in), gen))
                mod.bias.zero_()


class LegacyProposalScorer:
    """The legacy path on one device: ``legacy_roi_pool`` of a scene's rotated
    proposals from its FPN levels (the JAX defaults: enlarged by 0.2,
    adaptive max-pool), then ``ProposalClassifier`` with seeded
    random weights (a flax tree loads into ``model`` through
    ``convert.legacy_classifier_params_from_jax``)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 2,
                 output_size: Sequence[int] = (1, 1, 1),
                 conv_channels: Sequence[int] = (256, 256), rep_size: int = 512,
                 max_grid: int = 32, dtype=None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.output_size = tuple(output_size)
        self.max_grid = max_grid
        self.model = ProposalClassifier(in_channels, self.output_size, num_classes,
                                        conv_channels, rep_size, dtype=dtype)
        init_legacy_classifier(self.model, seed)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, level_feats, rois, level_ids, spatial_scale):
        """Per level features ``(W_l, L_l, H_l, C)``, rois ``(P, 7|6)`` and
        their level ids ``(P,)`` on the scorer's device -> (scores
        ``(P, num_classes)``, pooled features ``(P, o0, o1, o2, C)``)."""
        pooled = legacy_roi_pool(level_feats, rois, level_ids, spatial_scale,
                                 output_size=self.output_size, max_grid=self.max_grid)
        return self.model(pooled), pooled
