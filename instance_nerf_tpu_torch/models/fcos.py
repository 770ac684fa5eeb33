"""Anchor-free FCOS-3D proposal network, inference (PyTorch counterpart of
``instance_nerf_tpu.models.fcos``; the target assignment and the losses
come with detector training).

Shared conv towers with GroupNorm(32) run on every FPN level, with a
learnable scale per level, a centerness branch and the focal-prior cls
bias. Locations are the voxel centers of every level, concatenated in the
JAX package's order (level-major, then ``(w, l, h)`` row-major), and the
head outputs are flattened the same way.

``fcos_postprocess``: per level a stable top-n over the whole location
vector (ties to the lower index, as ``lax.top_k``), decode, clip (AABB),
small-box mask, one NMS over all levels (B1 for AABBs, the rotated IoU and
B2 for OBBs) and a global top-n, with static shapes. Scores are
``sqrt(cls * centerness)`` in the head's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.layers import Conv3d, GroupNorm
from instance_nerf_tpu_torch.ops import nms as nms_ops
from instance_nerf_tpu_torch.ops.boxes import clip_boxes_to_mesh, small_box_mask

INF = 1e8

# per-level regression ranges
OBJECT_SIZES_OF_INTEREST = ((-1.0, 16.0), (16.0, 32.0), (32.0, 64.0), (64.0, INF))


class FCOSHead(nn.Module):
    """Cls/bbox towers + logits/regression/centerness convs, shared across
    levels. Outputs per level: logits ``(N, w, l, h)``, regression
    ``(N, w, l, h, 6|8)`` in f32 and centerness ``(N, w, l, h)``.

    The bf16 regression conv output meets the f32 per-level ``scales`` and
    promotes to f32, as in JAX (a 0-dim torch tensor would not promote it,
    so the product is taken in f32 explicitly)."""

    def __init__(self, in_ch: int = 256, num_convs: int = 4, num_levels: int = 4,
                 fpn_strides: Sequence[int] = (4, 8, 16, 32),
                 norm_reg_targets: bool = True, centerness_on_reg: bool = True,
                 use_obb: bool = False, dtype=None):
        super().__init__()
        self.num_convs = num_convs
        self.fpn_strides = tuple(fpn_strides)
        self.norm_reg_targets = norm_reg_targets
        self.centerness_on_reg = centerness_on_reg
        for i in range(num_convs):
            for branch in ("cls", "bbox"):
                self.add_module(f"{branch}_tower_{i}", Conv3d(in_ch, in_ch, 3, dtype=dtype))
                self.add_module(f"{branch}_gn_{i}", GroupNorm(32, in_ch, dtype=dtype))
        self.cls_logits = Conv3d(in_ch, 1, 3, dtype=dtype)
        self.bbox_pred = Conv3d(in_ch, 8 if use_obb else 6, 3, dtype=dtype)
        self.centerness = Conv3d(in_ch, 1, 3, dtype=dtype)
        self.scales = nn.Parameter(torch.ones(num_levels))

    def tower(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            conv = getattr(self, f"{branch}_tower_{i}")
            x = F.relu(getattr(self, f"{branch}_gn_{i}")(conv(x)))
        return x

    def forward(self, features: Sequence[torch.Tensor], train: bool = False):
        logits, bbox_reg, ctr = [], [], []
        for lvl, feat in enumerate(features):
            c = self.tower("cls", feat)
            b = self.tower("bbox", feat)
            logits.append(self.cls_logits(c)[..., 0])
            ctr.append(self.centerness(b if self.centerness_on_reg else c)[..., 0])
            pred = self.bbox_pred(b).to(torch.float32) * self.scales[lvl]
            if self.norm_reg_targets:
                dist = F.relu(pred[..., :6])
                if not train:
                    dist = dist * self.fpn_strides[lvl]
                pred = torch.cat([dist, pred[..., 6:]], dim=-1)
            else:
                pred = torch.exp(pred)
            bbox_reg.append(pred)
        return logits, bbox_reg, ctr


def init_fcos_head(head: FCOSHead, gen: torch.Generator) -> None:
    """flax's init of the head: ``normal(0.01)`` kernels, zero biases but
    the focal prior on ``cls_logits`` (-log(99)), unit GroupNorm scales and
    level scales."""
    prior = -math.log((1 - 0.01) / 0.01)
    with torch.no_grad():
        for name, mod in head.named_children():
            if isinstance(mod, Conv3d):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * 0.01)
                mod.bias.fill_(prior if name == "cls_logits" else 0.0)
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        head.scales.fill_(1.0)


class LevelInfo(NamedTuple):
    locations: torch.Tensor  # (R, 3) voxel-center coords, all levels concat
    level_ids: torch.Tensor  # (R,) int32
    strides: torch.Tensor  # (R,) f32
    sizes_of_interest: torch.Tensor  # (R, 2) f32


def compute_locations(feature_shapes: Sequence[tuple[int, int, int]],
                      fpn_strides: Sequence[int], device=None) -> LevelInfo:
    """Per-level voxel-center grids, concatenated."""
    locs, lids, strs, sois = [], [], [], []
    for lvl, ((w, l, h), stride) in enumerate(zip(feature_shapes, fpn_strides)):
        axes = [torch.arange(n, dtype=torch.float32, device=device) * stride + stride // 2
                for n in (w, l, h)]
        gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=-1)
        r = pts.shape[0]
        locs.append(pts)
        lids.append(torch.full((r,), lvl, dtype=torch.int32, device=device))
        strs.append(torch.full((r,), float(stride), dtype=torch.float32, device=device))
        soi = OBJECT_SIZES_OF_INTEREST[min(lvl, len(OBJECT_SIZES_OF_INTEREST) - 1)]
        sois.append(torch.tensor(soi, dtype=torch.float32, device=device).expand(r, 2))
    return LevelInfo(torch.cat(locs), torch.cat(lids), torch.cat(strs), torch.cat(sois))


def padding_mask(info: LevelInfo, grid_sizes: torch.Tensor) -> torch.Tensor:
    """(N, R) True where a location is inside each scene's un-padded grid."""
    return torch.all(info.locations[None] < grid_sizes[:, None, :], dim=-1)


def decode_fcos_aabb(locations: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """6-distance -> AABB."""
    return torch.cat([locations - dist[..., 0:3], locations + dist[..., 3:6]], dim=-1)


def _safe_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1) + eps)


def decode_fcos_obb(locations: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Midpoint-offset 8-param -> OBB ``(x, y, z, w, l, h, theta)``.

    ``theta`` is ``atan2`` taken in f64 and rounded to f32: torch's f32
    ``atan2`` on the CPU differs by an ulp between vectorised and scalar
    lanes, so a box's angle would depend on its position in the tensor."""
    x0 = locations[..., 0] - reg[..., 0]
    y0 = locations[..., 1] - reg[..., 1]
    z0 = locations[..., 2] - reg[..., 2]
    x1 = locations[..., 0] + reg[..., 3]
    y1 = locations[..., 1] + reg[..., 4]
    z1 = locations[..., 2] + reg[..., 5]
    vx = torch.clamp((x1 + x0) / 2 + reg[..., 6] * (x1 - x0), x0, x1)
    vy = torch.clamp((y1 + y0) / 2 + reg[..., 7] * (y1 - y0), y0, y1)

    cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
    v0 = torch.stack([vx - cx, y1 - cy], dim=-1)
    v1 = torch.stack([x1 - cx, vy - cy], dim=-1)
    d0 = _safe_norm(v0)
    d1 = _safe_norm(v1)
    dmax = torch.maximum(d0, d1)
    v0 = v0 / (d0[..., None] + 1e-7) * dmax[..., None]
    v1 = v1 / (d1[..., None] + 1e-7) * dmax[..., None]

    l = _safe_norm(v0 - v1)
    mid = (v0 + v1) / 2
    w = _safe_norm(mid) * 2
    h = z1 - z0
    mid_x = torch.where((mid[..., 0] == 0) & (mid[..., 1] == 0),
                        torch.full_like(mid[..., 0], 1e-7), mid[..., 0])
    theta = torch.atan2(mid[..., 1].double(), mid_x.double()).to(mid.dtype)
    return torch.stack([cx, cy, cz, w, l, h, theta], dim=-1)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the JAX package computes it on the CPU: in bf16 ``1 / (1 + exp(-x))``
    with every step rounded to bf16 (``torch.sigmoid`` rounds once and
    differs by a bf16 ulp on about a third of the inputs); in f32
    ``torch.sigmoid``."""
    if x.dtype == torch.bfloat16:
        return 1 / (1 + torch.exp(-x))
    return torch.sigmoid(x)


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (N, P, 6|7)
    scores: torch.Tensor  # (N, P)
    level_ids: torch.Tensor  # (N, P) int32
    valid: torch.Tensor  # (N, P) bool


def fcos_postprocess(
    info: LevelInfo,
    logits: torch.Tensor,  # (N, R)
    box_reg: torch.Tensor,  # (N, R, 6|8) in voxel units (stride applied)
    centerness: torch.Tensor,  # (N, R)
    grid_sizes: torch.Tensor,  # (N, 3)
    num_levels: int,
    pre_nms_thresh: float = 0.0,
    pre_nms_top_n: int = 2500,
    nms_thresh: float = 0.3,
    fpn_post_nms_top_n: int = 2500,
    min_size: float = 0.0,
    pad_mask: torch.Tensor | None = None,
    use_obb: bool = False,
    nms_sweep=None,
    stage=nms_ops.no_stage,
) -> Proposals:
    """Decode + filter proposals with static shapes, scene by scene.

    Per level: the candidates (sigmoid(cls) above ``pre_nms_thresh``) of
    that level keep their score ``cls * ctr``, every other location of the
    whole vector gets -1; the top ``pre_nms_top_n`` of that vector are
    decoded, clipped (AABB) and masked (score > 0, small boxes). The levels
    are concatenated into one NMS, then the global top
    ``fpn_post_nms_top_n``. The padding fill -1e5 is written in the
    sigmoid's dtype, so it rounds in bf16 as in JAX. ``nms_sweep`` replaces
    the NMS sweep (see ``ops.nms.nms_mask``); ``stage(name)`` opens the
    spans ``decode_filter``, ``obb_iou``, ``nms_sweep`` and ``topk``."""
    cls_sig = sigmoid(logits)
    ctr_sig = sigmoid(centerness)
    if pad_mask is not None:
        cls_sig = torch.where(pad_mask, cls_sig, torch.full_like(cls_sig, -1e5))
    candidate = cls_sig > pre_nms_thresh
    score = cls_sig * ctr_sig
    dev = logits.device
    outs = []
    for score_s, cand_s, reg_s, gsize in zip(score, candidate, box_reg, grid_sizes):
        with stage("decode_filter"):
            boxes_l, scores_l, valid_l, lvl_l = [], [], [], []
            for lvl in range(num_levels):
                lvl_mask = info.level_ids == lvl
                s = torch.where(lvl_mask & cand_s, score_s, torch.full_like(score_s, -1.0))
                k = min(pre_nms_top_n, s.shape[0])
                # lax.top_k breaks ties to the lower index: a stable sort
                top_i = torch.sort(s, descending=True, stable=True).indices[:k]
                top_s = s[top_i]
                valid = top_s > 0
                locs = info.locations[top_i]
                reg = reg_s[top_i]
                if use_obb:
                    boxes = decode_fcos_obb(locs, reg)
                else:
                    boxes = clip_boxes_to_mesh(decode_fcos_aabb(locs, reg[..., :6]), gsize)
                valid &= small_box_mask(boxes, min_size)
                boxes_l.append(boxes)
                scores_l.append(torch.sqrt(top_s.clamp_min(0.0)))
                valid_l.append(valid)
                lvl_l.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
            boxes = torch.cat(boxes_l)
            scores = torch.cat(scores_l)
            valid = torch.cat(valid_l)
            lvls = torch.cat(lvl_l)
        keep = nms_ops.nms_mask(boxes, scores, nms_thresh, valid=valid, sweep=nms_sweep,
                                stage=stage)
        with stage("topk"):
            top_idx, top_mask = nms_ops.top_k_by_score(
                scores, min(fpn_post_nms_top_n, scores.shape[0]), valid=keep)
            outs.append((boxes[top_idx], scores[top_idx] * top_mask, lvls[top_idx],
                         top_mask))
    return Proposals(*(torch.stack(f) for f in zip(*outs)))


class FCOSOverNeRF(nn.Module):
    """Backbone + FCOS head. ``forward`` returns (level info, logits
    ``(N, R)``, box regression ``(N, R, D)``, centerness ``(N, R)``,
    features); the level info is cached per feature geometry and device."""

    def __init__(self, backbone: nn.Module, fpn_strides: Sequence[int] = (4, 8, 16, 32),
                 num_convs: int = 4, norm_reg_targets: bool = True,
                 centerness_on_reg: bool = True, use_obb: bool = False,
                 out_channels: int = 256, dtype=None):
        super().__init__()
        self.backbone = backbone
        self.fpn_strides = tuple(fpn_strides)
        self.head = FCOSHead(out_channels, num_convs=num_convs,
                             num_levels=len(self.fpn_strides), fpn_strides=self.fpn_strides,
                             norm_reg_targets=norm_reg_targets,
                             centerness_on_reg=centerness_on_reg, use_obb=use_obb,
                             dtype=dtype)
        self._info = {}

    def features(self, grids):
        return list(self.backbone(grids))[:len(self.fpn_strides)]

    def level_info(self, features) -> LevelInfo:
        shapes = tuple(tuple(f.shape[1:4]) for f in features)
        key = (shapes, str(features[0].device))
        if key not in self._info:
            self._info[key] = compute_locations(shapes, self.fpn_strides,
                                                device=features[0].device)
        return self._info[key]

    def head_outputs(self, features, train: bool = False):
        """Flattened logits ``(N, R)``, regression ``(N, R, D)`` and
        centerness ``(N, R)``."""
        logits, box_reg, ctr = self.head(features, train=train)
        n = features[0].shape[0]
        return (torch.cat([x.reshape(n, -1) for x in logits], 1),
                torch.cat([x.reshape(n, -1, x.shape[-1]) for x in box_reg], 1),
                torch.cat([x.reshape(n, -1) for x in ctr], 1))

    def forward(self, grids, train: bool = False):
        features = self.features(grids)
        logits, reg, ctr = self.head_outputs(features, train=train)
        return self.level_info(features), logits, reg, ctr, features
