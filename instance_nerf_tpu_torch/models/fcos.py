"""Anchor-free FCOS-3D proposal network (PyTorch counterpart of
``instance_nerf_tpu.models.fcos``): head, target assignment, losses and
post-processing.

Shared conv towers with GroupNorm(32) run on every FPN level, with a
learnable scale per level, a centerness branch and the focal-prior cls
bias. Locations are the voxel centers of every level, concatenated in the
JAX package's order (level-major, then ``(w, l, h)`` row-major), and the
head outputs are flattened the same way.

Given the grid's W layout (``parallel/spatial.py``), the backbone and the
towers run on this rank's rows of every level (the towers' GroupNorm
statistics summed over the ``sp`` ranks) and the locations are this rank's,
at their global coordinates.

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
from instance_nerf_tpu_torch.ops.boxes import clip_boxes_to_mesh, obb2points_3d, small_box_mask
from instance_nerf_tpu_torch.ops.projection import projection_loss_points
from instance_nerf_tpu_torch.ops.rotated_iou import (
    box2corners,
    cal_diou_3d,
    cal_giou_3d,
    cal_iou_3d,
)
from instance_nerf_tpu_torch.train.timing import NO_STAGES

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

    def tower(self, branch: str, x: torch.Tensor, layout=None) -> torch.Tensor:
        for i in range(self.num_convs):
            conv = getattr(self, f"{branch}_tower_{i}")
            x = F.relu(getattr(self, f"{branch}_gn_{i}")(conv(x, layout), layout))
        return x

    def forward(self, features: Sequence[torch.Tensor], train: bool = False, layouts=None):
        logits, bbox_reg, ctr = [], [], []
        for lvl, feat in enumerate(features):
            lay = None if layouts is None else layouts[lvl]
            c = self.tower("cls", feat, lay)
            b = self.tower("bbox", feat, lay)
            logits.append(self.cls_logits(c, lay)[..., 0])
            ctr.append(self.centerness(b if self.centerness_on_reg else c, lay)[..., 0])
            pred = self.bbox_pred(b, lay).to(torch.float32) * self.scales[lvl]
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
                      fpn_strides: Sequence[int], device=None,
                      w_offsets: Sequence[int] | None = None) -> LevelInfo:
    """Per-level voxel-center grids, concatenated. ``w_offsets``: each
    level's first global W row (a rank's block of a W-split level)."""
    locs, lids, strs, sois = [], [], [], []
    offsets = w_offsets or (0,) * len(feature_shapes)
    for lvl, ((w, l, h), stride) in enumerate(zip(feature_shapes, fpn_strides)):
        axes = [(torch.arange(n, dtype=torch.float32, device=device) + o) * stride
                + stride // 2 for n, o in ((w, offsets[lvl]), (l, 0), (h, 0))]
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


# ---------------------------------------------------------------------------
# Target assignment. Every function takes leading batch dims on the gt
# (``(..., K, D)``) and gives ``(..., R, ...)`` over the locations.
# ---------------------------------------------------------------------------


def _center_sample_mask(aabbs: torch.Tensor, info: LevelInfo, radius: float) -> torch.Tensor:
    """(..., R, K): is a location inside each gt's center region (its center
    +- ``radius`` strides, clipped to the box)."""
    centers = 0.5 * (aabbs[..., 0:3] + aabbs[..., 3:6])  # (..., K, 3)
    rad = info.strides[:, None, None] * radius  # (R, 1, 1)
    lo = torch.maximum(centers[..., None, :, :] - rad, aabbs[..., None, :, 0:3])
    hi = torch.minimum(centers[..., None, :, :] + rad, aabbs[..., None, :, 3:6])
    p = info.locations[:, None, :]  # (R, 1, 3)
    return torch.all((p - lo > 0) & (hi - p > 0), dim=-1)


def _assign(info: LevelInfo, reg, aabbs, gt_mask, center_sampling_radius):
    """Each location's gt: the smallest-volume gt whose center region holds
    it and whose largest distance lies in its level's size range (the first
    of equal volumes). Returns (labels (..., R), targets (..., R, D))."""
    if center_sampling_radius > 0:
        in_boxes = _center_sample_mask(aabbs, info, center_sampling_radius)
    else:
        in_boxes = reg[..., :6].amin(dim=-1) > 0
    max_reg = reg[..., :6].amax(dim=-1)  # (..., R, K)
    cared = ((max_reg >= info.sizes_of_interest[:, 0:1])
             & (max_reg <= info.sizes_of_interest[:, 1:2]))
    volumes = ((aabbs[..., 3] - aabbs[..., 0]) * (aabbs[..., 4] - aabbs[..., 1])
               * (aabbs[..., 5] - aabbs[..., 2]))
    area = torch.where(in_boxes & cared & gt_mask[..., None, :],
                       volumes[..., None, :].expand_as(in_boxes),
                       torch.full_like(max_reg, INF))
    labels = (area.amin(dim=-1) < INF).to(torch.float32)
    gt_idx = area.argmin(dim=-1)
    idx = gt_idx[..., None, None].expand(*gt_idx.shape, 1, reg.shape[-1])
    return labels, torch.gather(reg.expand(*area.shape, reg.shape[-1]), -2, idx)[..., 0, :]


def fcos_targets(info: LevelInfo, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                 center_sampling_radius: float = 1.5, norm_reg_targets: bool = True):
    """Labels (..., R) in {0, 1} and 6-distance targets (..., R, 6) for AABB
    gt ``(..., K, 6)``; the targets are in strides with ``norm_reg_targets``."""
    xs, ys, zs = (info.locations[:, a:a + 1] for a in range(3))
    g = gt_boxes[..., None, :, :]  # (..., 1, K, 6)
    reg = torch.stack([xs - g[..., 0], ys - g[..., 1], zs - g[..., 2],
                       g[..., 3] - xs, g[..., 4] - ys, g[..., 5] - zs], dim=-1)
    labels, reg_t = _assign(info, reg, gt_boxes, gt_mask, center_sampling_radius)
    if norm_reg_targets:
        reg_t = reg_t / info.strides[:, None]
    return labels, reg_t


def centerness_target(reg: torch.Tensor) -> torch.Tensor:
    """sqrt of the product over the axes of min / max of the two distances."""
    def ratio(a, b):
        p = reg[..., [a, b]]
        return p.amin(dim=-1) / p.amax(dim=-1).clamp_min(1e-10)

    return torch.sqrt((ratio(0, 3) * ratio(1, 4) * ratio(2, 5)).clamp_min(0.0))


def encode_fcos_obb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """OBB ``(..., 7)`` -> 8-param midpoint-offset targets at ``locations``
    ``(..., 3)`` (the two broadcast): the 6 distances to the OBB's enclosing
    AABB and the offsets of the top and right edges' touching vertices."""
    corners = box2corners(boxes[..., [0, 1, 3, 4, 6]])  # (..., 4, 2)
    xs, ys = corners[..., 0], corners[..., 1]
    xmax, xmin = xs.amax(dim=-1), xs.amin(dim=-1)
    ymax, ymin = ys.amax(dim=-1), ys.amin(dim=-1)

    x0 = locations[..., 0] - xmin
    y0 = locations[..., 1] - ymin
    z0 = locations[..., 2] - (boxes[..., 2] - boxes[..., 5] / 2)
    x1 = xmax - locations[..., 0]
    y1 = ymax - locations[..., 1]
    z1 = (boxes[..., 2] + boxes[..., 5] / 2) - locations[..., 2]

    xt = torch.where(ymax[..., None] - ys > 0.1, torch.full_like(xs, -1e6), xs)
    yt = torch.where(xmax[..., None] - xs > 0.1, torch.full_like(ys, 1e6), ys)
    vx = xt.amax(dim=-1)
    vy = yt.amin(dim=-1)
    near_aabb = torch.isclose(vx, xmax) & torch.isclose(vy, ymin)
    vx = torch.where(near_aabb, xmax, vx)
    vy = torch.where(near_aabb, ymin, vy)

    alpha = (vx - boxes[..., 0]) / (xmax - xmin).clamp_min(1e-7)
    beta = (vy - boxes[..., 1]) / (ymax - ymin).clamp_min(1e-7)
    shape = torch.broadcast_shapes(x0.shape, alpha.shape)
    return torch.stack([t.expand(shape) for t in (x0, y0, z0, x1, y1, z1, alpha, beta)],
                       dim=-1)


def fcos_targets_obb(info: LevelInfo, gt_obbs: torch.Tensor, gt_mask: torch.Tensor,
                     center_sampling_radius: float = 1.5, norm_reg_targets: bool = True):
    """OBB target assignment: labels (..., R) and 8-param targets (..., R, 8)
    for gt ``(..., K, 7)``, assigned through each OBB's enclosing AABB."""
    reg = encode_fcos_obb(info.locations[:, None, :], gt_obbs[..., None, :, :])
    corners = box2corners(gt_obbs[..., [0, 1, 3, 4, 6]])  # (..., K, 4, 2)
    aabbs = torch.cat([corners.amin(dim=-2), gt_obbs[..., 2:3] - gt_obbs[..., 5:6] / 2,
                       corners.amax(dim=-2), gt_obbs[..., 2:3] + gt_obbs[..., 5:6] / 2],
                      dim=-1)
    labels, reg_t = _assign(info, reg, aabbs, gt_mask, center_sampling_radius)
    if norm_reg_targets:
        reg_t = torch.cat([reg_t[..., :6] / info.strides[:, None], reg_t[..., 6:]], dim=-1)
    return labels, reg_t


# ---------------------------------------------------------------------------
# Losses (f32)
# ---------------------------------------------------------------------------


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, as the JAX package writes it."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def iou_loss_6dist(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "iou"):
    """IoU-family loss on the 6-distance parameterisation."""
    tl, tt, tf, tr, tb, tba = target.unbind(-1)
    pl, pt, pf, pr, pb, pba = pred.unbind(-1)
    target_vol = (tl + tr) * (tt + tb) * (tf + tba)
    pred_vol = (pl + pr) * (pt + pb) * (pf + pba)
    w_i = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_i = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    d_i = torch.minimum(pf, tf) + torch.minimum(pba, tba)
    g_d = torch.maximum(pf, tf) + torch.maximum(pba, tba)
    ac = g_w * g_h * g_d + 1e-7
    inter = w_i * h_i * d_i
    union = target_vol + pred_vol - inter
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        return -torch.log(ious.clamp_min(1e-10))
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        return 1.0 - (ious - (ac - union) / ac)
    raise NotImplementedError(loss_type)


def rotated_iou_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "iou"):
    """OBB loss on 8-param midpoint offsets, both decoded at the origin."""
    dummy = torch.zeros(pred.shape[:-1] + (3,), dtype=pred.dtype, device=pred.device)
    pred_boxes = decode_fcos_obb(dummy, pred)
    tgt_boxes = decode_fcos_obb(dummy, target)
    if loss_type in ("iou", "linear_iou"):
        ious, _, _, _, unions = cal_iou_3d(pred_boxes, tgt_boxes, verbose=True)
        ious = (ious * unions + 1.0) / (unions + 1.0)
        return -torch.log(ious.clamp_min(1e-10)) if loss_type == "iou" else 1.0 - ious
    if loss_type == "giou":
        return cal_giou_3d(pred_boxes, tgt_boxes)[0]
    if loss_type == "diou":
        return cal_diou_3d(pred_boxes, tgt_boxes)[0]
    raise NotImplementedError(loss_type)


def fcos_loss(
    info: LevelInfo,
    logits: torch.Tensor,  # (N, R)
    box_reg: torch.Tensor,  # (N, R, 6|8)
    centerness: torch.Tensor,  # (N, R)
    gt_boxes: torch.Tensor,  # (N, K, 6|7)
    gt_mask: torch.Tensor,  # (N, K)
    pad_mask: torch.Tensor | None = None,  # (N, R)
    center_sampling_radius: float = 1.5,
    iou_loss_type: str = "iou",
    norm_reg_targets: bool = True,
    use_obb: bool = False,
    use_additional_l1_loss: bool = False,
    proj2d_loss_weight: float = 0.0,
    proj2d_res: int = 160,
    dist_sum=None,
) -> dict:
    """The FCOS loss: focal cls loss over the un-padded locations,
    centerness-weighted box loss and centerness BCE over the positives,
    each normalised as the reference does. Computed in f32 whatever the
    head's dtype.

    ``dist_sum`` (the JAX loss's ``axis_name`` hook) maps this rank's
    positive count and centerness sum to their sums over the ranks of a
    data-parallel step (``parallel/mesh.py:Shard.sum``): each loss is then
    this rank's numerator over the global batch's normaliser, and the
    losses and their gradients sum over the ranks to the global batch's.
    The JAX step under GSPMD sums over the global batch (``world`` 1), so
    the normaliser is the global count, not its mean over ranks.
    ``num_pos`` is this rank's count.

    The box losses are the JAX package's masked sums. The OBB losses are
    computed on the positive rows alone: the rest contribute exactly 0 to
    the loss and the gradient there, so both are equal, and the polygon
    clipping runs over thousands of rows, not N x R."""
    logits = logits.float()
    box_reg = box_reg.float()
    centerness = centerness.float()
    target_fn = fcos_targets_obb if use_obb else fcos_targets
    with torch.no_grad():
        labels, reg_t = target_fn(info, gt_boxes, gt_mask, center_sampling_radius,
                                  norm_reg_targets)
    if pad_mask is None:
        pad_mask = torch.ones_like(labels, dtype=torch.bool)
    pos = (labels > 0) & pad_mask
    zero = torch.zeros_like(logits)

    num_pos = pos.sum().to(torch.float32)
    ctr_t = torch.where(pos, centerness_target(reg_t[..., :6]), zero)
    num_pos_global, sum_ctr = num_pos, ctr_t.sum()
    if dist_sum is not None:
        num_pos_global, sum_ctr = dist_sum(torch.stack([num_pos, sum_ctr]))
    num_pos_avg = num_pos_global.clamp_min(1.0)
    sum_ctr_avg = sum_ctr.clamp_min(1e-6)
    cls = sigmoid_focal_loss(logits, labels)
    cls_loss = torch.where(pad_mask, cls, zero).sum() / num_pos_avg

    if iou_loss_type == "smooth_l1" or not use_obb:
        # benign values off the positives, so no inf or NaN leaks into the
        # gradient through the mask (off-box targets have negative distances)
        ones = torch.ones_like(reg_t)
        reg_t_s = torch.where(pos[..., None], reg_t, ones)
        box_reg_s = torch.where(pos[..., None], box_reg, ones)
        if iou_loss_type == "smooth_l1":
            per = smooth_l1(box_reg_s, reg_t_s).sum(-1) * ctr_t
        else:
            per = iou_loss_6dist(box_reg_s, reg_t_s, iou_loss_type) * ctr_t
        reg_loss = torch.where(pos, per, zero).sum() / sum_ctr_avg
    else:
        at = pos.nonzero(as_tuple=True)
        p, t, c = box_reg[at], reg_t[at], ctr_t[at]
        reg_loss = (rotated_iou_loss(p, t, iou_loss_type) * c).sum() / sum_ctr_avg
        if use_additional_l1_loss:
            l1 = smooth_l1(p[:, 6:], t[:, 6:]).sum(-1) * c
            reg_loss = reg_loss + l1.sum() / sum_ctr_avg
        if proj2d_loss_weight > 0:
            # corner-projection consistency, decoded at voxel scale (the
            # stride normalisation undone)
            scale = info.strides[at[1]][:, None] if norm_reg_targets else 1.0
            dummy = torch.zeros((p.shape[0], 3), dtype=p.dtype, device=p.device)
            pb = decode_fcos_obb(dummy, torch.cat([p[:, :6] * scale, p[:, 6:]], dim=-1))
            tb = decode_fcos_obb(dummy, torch.cat([t[:, :6] * scale, t[:, 6:]], dim=-1))
            l2d = projection_loss_points(obb2points_3d(pb), obb2points_3d(tb),
                                         torch.cat([c, c]), res=proj2d_res) / sum_ctr_avg
            reg_loss = reg_loss + proj2d_loss_weight * l2d

    ctr_bce = optax_sigmoid_ce(centerness, ctr_t)
    ctr_loss = torch.where(pos, ctr_bce, zero).sum() / num_pos_avg
    return {"loss_cls": cls_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss,
            "num_pos": num_pos}


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
    stage=NO_STAGES,
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

    def features(self, grids, layout=None):
        """The levels; with the grid's W ``layout``, (levels, their layouts)."""
        n = len(self.fpn_strides)
        if layout is None:
            return list(self.backbone(grids))[:n]
        feats, layouts = self.backbone(grids, layout=layout)
        return list(feats)[:n], list(layouts)[:n]

    def level_info(self, features, layouts=None) -> LevelInfo:
        shapes = tuple(tuple(f.shape[1:4]) for f in features)
        offsets = tuple(0 if lay is None else lay.lo for lay in layouts or ())
        key = (shapes, offsets, str(features[0].device))
        if key not in self._info:
            self._info[key] = compute_locations(shapes, self.fpn_strides,
                                                device=features[0].device,
                                                w_offsets=offsets or None)
        return self._info[key]

    def head_outputs(self, features, train: bool = False, layouts=None):
        """Flattened logits ``(N, R)``, regression ``(N, R, D)`` and
        centerness ``(N, R)``."""
        logits, box_reg, ctr = self.head(features, train=train, layouts=layouts)
        n = features[0].shape[0]

        def flat(x, *tail):  # explicit sizes: a rank's level may hold no rows
            return x.reshape(n, math.prod(x.shape[1:4]), *tail)

        return (torch.cat([flat(x) for x in logits], 1),
                torch.cat([flat(x, x.shape[-1]) for x in box_reg], 1),
                torch.cat([flat(x) for x in ctr], 1))

    def forward(self, grids, train: bool = False, layout=None):
        """(level info, logits, regression, centerness, features); with the
        grid's W ``layout`` all of them this rank's."""
        layouts = None
        if layout is None:
            features = self.features(grids)
        else:
            features, layouts = self.features(grids, layout)
        logits, reg, ctr = self.head_outputs(features, train=train, layouts=layouts)
        return self.level_info(features, layouts), logits, reg, ctr, features
