"""Anchor-based 3D RPN, inference (PyTorch counterpart of
``instance_nerf_tpu.models.rpn``; the target assignment and the losses come
with detector training).

Anchors are numpy arrays built on the host once per feature geometry, as
the JAX package builds them at trace time. Head outputs are flattened
location-major and anchor-minor per level, as the JAX package does: the
convs run NCDHW inside, and their outputs are viewed channels-last before
any reshape, so delta channel ``a * d + k`` lands at anchor ``a``,
coordinate ``k``.

``filter_proposals``: per-level top-n (ties to the lower index), decode,
clip (AABB), small-box and score masks, per-level NMS (B1 for AABBs, the
rotated IoU and B2 for OBBs) and a global top-n, with static shapes.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.layers import Conv3d
from instance_nerf_tpu_torch.ops import nms as nms_ops
from instance_nerf_tpu_torch.ops.boxes import clip_boxes_to_mesh, small_box_mask
from instance_nerf_tpu_torch.ops.coders import AABBCoder, MidpointOffsetCoder

DEFAULT_ANCHOR_SIZES = ((8.0,), (16.0,), (32.0,), (64.0,))
DEFAULT_ASPECT_RATIOS = (
    ((1.0, 1.0, 1.0), (1.0, 1.0, 2.0), (1.0, 2.0, 2.0), (1.0, 1.0, 3.0), (1.0, 3.0, 3.0)),
) * 4


class AnchorGenerator3D:
    """Base anchors = sizes x unique ratio permutations, shifted over each
    FPN level's voxel grid. Host-side numpy; the arithmetic is the JAX
    package's, so the anchors are bit-identical."""

    def __init__(self, sizes=DEFAULT_ANCHOR_SIZES,
                 aspect_ratios=DEFAULT_ASPECT_RATIOS, is_normalized=False):
        self.sizes = sizes
        self.aspect_ratios = aspect_ratios
        self.is_normalized = is_normalized
        self.unique_ratios = []
        for level_ratios in aspect_ratios:
            perms = set()
            for r in level_ratios:
                perms.update(itertools.permutations(r))
            self.unique_ratios.append(sorted(perms))

    def num_anchors_per_location(self):
        return [len(s) * len(r) for s, r in zip(self.sizes, self.unique_ratios)]

    def base_anchors(self, level: int) -> np.ndarray:
        scales = np.asarray(self.sizes[level], np.float64)
        ratios = np.asarray(self.unique_ratios[level], np.float64)  # (P, 3)
        if self.is_normalized:
            ratios = ratios / np.cbrt(ratios.prod(axis=1, keepdims=True))
        whd = (ratios[:, None, :] * scales[None, :, None]).reshape(-1, 3)
        return np.round(np.concatenate([-whd, whd], axis=1) / 2).astype(np.float32)

    def grid_anchors(self, feature_shapes: Sequence[tuple[int, int, int]],
                     strides: Sequence[tuple[int, int, int]]):
        """Per level an ``(R_l * A_l, 6)`` array; index = loc * A + a."""
        out = []
        for lvl, (shape, stride) in enumerate(zip(feature_shapes, strides)):
            base = self.base_anchors(lvl)  # (A, 6)
            ax = [np.arange(s, dtype=np.float32) * st for s, st in zip(shape, stride)]
            gx, gy, gz = np.meshgrid(*ax, indexing="ij")
            shifts = np.stack([gx, gy, gz, gx, gy, gz], axis=-1).reshape(-1, 1, 6)
            out.append((shifts + base[None]).reshape(-1, 6))
        return out


class RPNHead(nn.Module):
    """Shared 3x3 conv tower -> 1x1 objectness + 1x1 deltas, run on every
    level. Outputs per level: logits ``(N, w, l, h, A)`` and deltas
    ``(N, w, l, h, A, d)`` with d = 8 (OBB) or 6 (AABB)."""

    def __init__(self, in_ch: int, num_anchors: int, conv_depth: int = 4,
                 rotated: bool = False, dtype=None):
        super().__init__()
        self.num_anchors, self.conv_depth = num_anchors, conv_depth
        self.box_dim = 8 if rotated else 6
        for i in range(conv_depth):
            self.add_module(f"conv_{i}", Conv3d(in_ch, in_ch, 3, dtype=dtype))
        self.cls_logits = Conv3d(in_ch, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv3d(in_ch, num_anchors * self.box_dim, 1, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for t in features:
            for i in range(self.conv_depth):
                t = F.relu(getattr(self, f"conv_{i}")(t))
            logits.append(self.cls_logits(t))  # channels-last view
            # reshape copies in channels-last order: channel a * d + k
            deltas.append(self.bbox_pred(t).reshape(
                *t.shape[:4], self.num_anchors, self.box_dim))
        return logits, deltas


def flatten_head_outputs(logits, deltas):
    """(N, R_total) objectness + (N, R_total, D) deltas, location-major
    anchor-minor per level, levels concatenated."""
    n = logits[0].shape[0]
    obj = torch.cat([l.reshape(n, -1) for l in logits], dim=1)
    d = deltas[0].shape[-1]
    reg = torch.cat([r.reshape(n, -1, d) for r in deltas], dim=1)
    return obj, reg


def anchor_padding_mask(anchors_per_level: Sequence[torch.Tensor],
                        grid_sizes: torch.Tensor,
                        strides: Sequence[int]) -> torch.Tensor:
    """(N, R_total) True for anchors whose grid cell lies inside each
    scene's un-padded region (cells < ceil(size / stride))."""
    masks = []
    for a, s in zip(anchors_per_level, strides):
        # base anchors are symmetric about their cell shift, so the cell
        # coordinate is the box midpoint
        cell = 0.5 * (a[:, 0:3] + a[:, 3:6])
        limit = torch.ceil(grid_sizes / s) * s  # (N, 3)
        masks.append(torch.all(cell[None] < limit[:, None, :], dim=-1))
    return torch.cat(masks, dim=1)


class RPNProposals(NamedTuple):
    boxes: torch.Tensor  # (N, P, 6|7)
    scores: torch.Tensor  # (N, P)
    level_ids: torch.Tensor  # (N, P)
    valid: torch.Tensor  # (N, P)


def filter_proposals(
    objectness: torch.Tensor,  # (N, R)
    pred_deltas: torch.Tensor,  # (N, R, D)
    anchors_per_level: Sequence[torch.Tensor],
    grid_sizes: torch.Tensor,  # (N, 3)
    pre_nms_top_n: int = 1000,
    post_nms_top_n: int = 1000,
    nms_thresh: float = 0.7,
    score_thresh: float = 0.0,
    min_size: float = 1e-3,
    pad_mask: torch.Tensor | None = None,
    rotated: bool = False,
    nms_sweep=None,
    stage=nms_ops.no_stage,
) -> RPNProposals:
    """Decode + per-level top-n + clip + per-LEVEL NMS + global top-n.

    The deltas are cast to f32 before decoding (bf16 head outputs meet
    f32 anchors, which JAX promotes to f32). ``nms_sweep`` replaces the
    NMS sweep (see ``ops.nms.nms_mask``); ``stage(name)`` opens the spans
    ``decode_filter``, ``obb_iou``, ``nms_sweep`` and ``topk``."""
    coder = MidpointOffsetCoder() if rotated else AABBCoder()
    if pad_mask is not None:
        objectness = torch.where(pad_mask, objectness,
                                 torch.full_like(objectness, -torch.inf))
    counts = [a.shape[0] for a in anchors_per_level]
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    dev = objectness.device
    outs = []
    for obj_s, deltas_s, gsize in zip(objectness, pred_deltas, grid_sizes):
        with stage("decode_filter"):
            boxes_l, scores_l, lvl_l, valid_l = [], [], [], []
            for lvl, a in enumerate(anchors_per_level):
                s = obj_s[offsets[lvl]:offsets[lvl + 1]]
                d = deltas_s[offsets[lvl]:offsets[lvl + 1]]
                k = min(pre_nms_top_n, s.shape[0])
                # lax.top_k breaks ties to the lower index: a stable sort
                top_i = torch.sort(s, descending=True, stable=True).indices[:k]
                top_s = s[top_i]
                valid = top_s > -torch.inf
                boxes = coder.decode(d[top_i].to(torch.float32), a[top_i])
                scores = torch.sigmoid(top_s)
                if not rotated:
                    boxes = clip_boxes_to_mesh(boxes, gsize)
                valid &= small_box_mask(boxes, min_size)
                valid &= scores >= score_thresh
                boxes_l.append(boxes)
                scores_l.append(scores)
                lvl_l.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
                valid_l.append(valid)
            boxes = torch.cat(boxes_l)
            scores = torch.cat(scores_l)
            lvls = torch.cat(lvl_l)
            valid = torch.cat(valid_l)
        keep = nms_ops.batched_nms_mask(boxes, scores, lvls, nms_thresh, valid=valid,
                                        sweep=nms_sweep, stage=stage)
        with stage("topk"):
            top_idx, top_mask = nms_ops.top_k_by_score(
                scores, min(post_nms_top_n, scores.shape[0]), valid=keep)
            outs.append((boxes[top_idx], scores[top_idx] * top_mask,
                         lvls[top_idx], top_mask))
    return RPNProposals(*(torch.stack(f) for f in zip(*outs)))


class NeRFRegionProposalNetwork(nn.Module):
    """Backbone + anchor RPN head. ``forward`` returns the raw head outputs
    flattened (objectness ``(N, R)``, deltas ``(N, R, D)``), the anchors per
    level (device tensors, cached per feature geometry) and the features."""

    def __init__(self, backbone: nn.Module, anchor_generator=None,
                 conv_depth: int = 4, rotated: bool = False,
                 fpn_strides: Sequence[int] = (4, 8, 16, 32),
                 out_channels: int = 256, dtype=None):
        super().__init__()
        self.backbone = backbone
        self.gen = anchor_generator or AnchorGenerator3D()
        self.fpn_strides = tuple(fpn_strides)
        self.rpn_head = RPNHead(out_channels, self.gen.num_anchors_per_location()[0],
                                conv_depth=conv_depth, rotated=rotated, dtype=dtype)
        self._anchors = {}

    def features(self, grids):
        return list(self.backbone(grids))[:len(self.fpn_strides)]

    def anchors(self, features):
        shapes = tuple(tuple(f.shape[1:4]) for f in features)
        dev = features[0].device
        key = (shapes, str(dev))
        if key not in self._anchors:
            strides = [(s,) * 3 for s in self.fpn_strides]
            self._anchors[key] = [torch.from_numpy(a).to(dev)
                                  for a in self.gen.grid_anchors(shapes, strides)]
        return self._anchors[key]

    def head(self, features):
        """Flattened objectness ``(N, R)`` and deltas ``(N, R, D)``."""
        return flatten_head_outputs(*self.rpn_head(features))

    def forward(self, grids):
        features = self.features(grids)
        obj, reg = self.head(features)
        return obj, reg, self.anchors(features), features
