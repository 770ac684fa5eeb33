"""NeRF-RCNN RoI heads, training samples and losses, and the inference
chain (PyTorch counterpart of ``instance_nerf_tpu.models.rcnn``).

Training: match the proposals (the gt appended) to the gt, draw a balanced
sample, pack it stably into fixed slots, then the classification, box and
mask losses. Inference: softmax -> per-class decode -> clip -> small-box
mask -> per-class NMS (kernel B1 through ``ops/nms.py``; with OBB deltas,
``box_dim = 8``, the rotated IoU swept by kernel B2) -> top-k -> mask head
-> mask paste.
Pooled features keep the JAX layout ``(K, ow, ol, oh, C)``, so ``fc6``
takes them flattened channels-last exactly as the flax head does.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.fcos import optax_sigmoid_ce, smooth_l1
from instance_nerf_tpu_torch.models.layers import Conv3d, Linear, _cast, to_ncdhw, to_ndhwc
from instance_nerf_tpu_torch.ops import nms as nms_ops
from instance_nerf_tpu_torch.ops.boxes import (
    box_iou_3d,
    clip_boxes_to_mesh,
    obb2hbb_3d,
    small_box_mask,
)
from instance_nerf_tpu_torch.ops.coders import AABBCoder, MidpointOffsetCoder
from instance_nerf_tpu_torch.ops.mask_paste import paste_masks_in_image
from instance_nerf_tpu_torch.ops.poolers import multiscale_roi_align_3d
from instance_nerf_tpu_torch.ops.roi_align import roi_align_3d
from instance_nerf_tpu_torch.ops.sampling import balanced_sample, match_proposals


class FastRCNNHead(nn.Module):
    """Flatten pooled 5^3 x C -> fc6/fc7 -> class scores + per-class deltas."""

    def __init__(self, in_features: int, num_classes: int, rep_size: int = 512,
                 box_dim: int = 6, dtype=None):
        super().__init__()
        self.num_classes, self.box_dim = num_classes, box_dim
        self.fc6 = Linear(in_features, rep_size, dtype)
        self.fc7 = Linear(rep_size, rep_size, dtype)
        self.cls_score = Linear(rep_size, num_classes, dtype)
        self.bbox_pred = Linear(rep_size, num_classes * box_dim, dtype)

    def forward(self, pooled: torch.Tensor):
        """pooled (..., ow, ol, oh, C) -> scores (..., num_classes),
        deltas (..., num_classes, box_dim)."""
        lead = pooled.shape[:-4]
        x = pooled.reshape(*lead, -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        scores = self.cls_score(x)
        deltas = self.bbox_pred(x)
        return scores, deltas.reshape(*lead, self.num_classes, self.box_dim)


class MaskRCNNHead(nn.Module):
    """4x (Conv3x3 + ReLU) FCN (no norm, the reference default)."""

    def __init__(self, in_ch: int = 256, layers: Sequence[int] = (256, 256, 256, 256),
                 dtype=None):
        super().__init__()
        for i, feat in enumerate(layers):
            self.add_module(f"mask_fcn{i}", Conv3d(in_ch, feat, 3, dtype=dtype))
            in_ch = feat
        self.n = len(layers)

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class ConvTranspose3d(nn.Module):
    """flax ``nn.ConvTranspose`` k2 s2 (SAME) on NDHWC. ``weight`` is the
    torch layout ``(in, out, 2, 2, 2)``; ``convert.py`` flips the flax
    kernel spatially into it."""

    def __init__(self, in_ch: int, out_ch: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv_transpose3d(to_ncdhw(_cast(x, self.dtype)),
                               _cast(self.weight, self.dtype),
                               _cast(self.bias, self.dtype), stride=2)
        return to_ndhwc(y)


class MaskRCNNPredictor(nn.Module):
    """ConvTranspose 2x upsample -> ReLU -> 1x1 conv -> per-class logits."""

    def __init__(self, in_ch: int, num_classes: int, dim_reduced: int = 256,
                 dtype=None):
        super().__init__()
        self.conv5_mask = ConvTranspose3d(in_ch, dim_reduced, dtype)
        self.mask_fcn_logits = Conv3d(dim_reduced, num_classes, 1, dtype=dtype)

    def forward(self, x):
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class SampledRois(NamedTuple):
    rois: torch.Tensor  # (N, S, 6)
    labels: torch.Tensor  # (N, S) int64, 0 = background, -1 = empty slot
    reg_targets: torch.Tensor  # (N, S, D)
    matched_gt_idx: torch.Tensor  # (N, S)
    valid: torch.Tensor  # (N, S)
    pos: torch.Tensor  # (N, S) positive (label >= 1)


def _pack(mask: torch.Tensor, size: int):
    """The True positions of ``mask`` first, in order (a stable sort), cut to
    ``size`` slots: (indices, valid)."""
    idx = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[..., :size]
    return idx, torch.gather(mask, -1, idx)


@torch.no_grad()
def select_training_samples(
    proposals: torch.Tensor,  # (N, P, 6)
    prop_valid: torch.Tensor,  # (N, P)
    gt_boxes: torch.Tensor,  # (N, K, 6|7)
    gt_labels: torch.Tensor,  # (N, K)
    gt_mask: torch.Tensor,  # (N, K)
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    fg_iou_thresh: float = 0.25,
    bg_iou_thresh: float = 0.25,
    append_gt: bool = True,
    box_dim: int = 6,
    uniforms: torch.Tensor | None = None,  # (N, 2, P [+ K])
    generator: torch.Generator | None = None,
    shard=None,
) -> SampledRois:
    """Per scene: label the proposals (the gt appended) by IoU with the low-
    quality matches recovered, draw a balanced sample (``uniforms`` per
    scene, else drawn from ``generator``), pack it into min(S, P + K) slots
    and encode the box targets. ``box_dim = 8`` (OBB RCNN): the gt are
    ``(N, K, 7)`` OBBs, matched (and appended) by their AABB
    (``obb2hbb_3d``), and the targets are ``MidpointOffsetCoder`` deltas.
    With ``shard`` (a data-parallel step's rows) the draws are its rows of
    the global batch's."""
    coder = MidpointOffsetCoder() if box_dim == 8 else AABBCoder()
    gt_aabb = gt_boxes if gt_boxes.shape[-1] == 6 else obb2hbb_3d(gt_boxes)
    if append_gt:
        proposals = torch.cat([proposals, gt_aabb], dim=1)
        prop_valid = torch.cat([prop_valid, gt_mask], dim=1)
    if uniforms is None:
        n, p = prop_valid.shape
        uniforms = (torch.rand((n, 2, p), generator=generator, device=prop_valid.device)
                    if shard is None else shard.rand((2, p), generator, prop_valid.device))
    out = []
    for props, pvalid, gtb, gta, gtl, gtm, u in zip(proposals, prop_valid, gt_boxes,
                                                     gt_aabb, gt_labels, gt_mask, uniforms):
        quality = box_iou_3d(gta, props)  # (K, P)
        quality = torch.where(gtm[:, None], quality, torch.full_like(quality, -1.0))
        quality = torch.where(pvalid[None, :], quality, torch.full_like(quality, -1.0))
        matched = match_proposals(quality, fg_iou_thresh, bg_iou_thresh,
                                  allow_low_quality_matches=True, gt_valid=gtm)
        clamped = matched.clamp_min(0)
        zero, ignore = torch.zeros_like(matched), torch.full_like(matched, -1)
        labels = torch.where(matched >= 0, gtl.to(torch.int64)[clamped],
                             torch.where(matched == -1, zero, ignore))
        labels = torch.where(pvalid, labels, ignore)
        if not bool(gtm.any()):  # a background scene: every valid proposal negative
            labels = torch.where(pvalid, zero, ignore)
        sample = balanced_sample(labels, batch_size_per_image, positive_fraction,
                                 uniforms=u)
        idx, valid = _pack(sample.pos_mask | sample.neg_mask, batch_size_per_image)
        rois = props[idx]
        lab = torch.where(valid, labels[idx], torch.full_like(idx, -1))
        midx = clamped[idx]
        reg_t = coder.encode(gtb[midx], rois)
        reg_t = torch.where(torch.isfinite(reg_t), reg_t, torch.zeros_like(reg_t))
        out.append(SampledRois(rois, lab, reg_t, midx, valid, lab >= 1))
    return SampledRois(*(torch.stack(f) for f in zip(*out)))


def fastrcnn_loss(class_logits, box_regression, labels, reg_targets, valid, n_valid=None):
    """CE over the sampled rois + smooth-L1 of the positives' own-class
    deltas, both over the sampled count, in f32. ``n_valid`` replaces the
    sampled count of these rows (a data-parallel step passes the global
    batch's).

    class_logits (N, S, C); box_regression (N, S, C, D); labels, valid (N, S)."""
    if box_regression.shape[-1] != reg_targets.shape[-1]:
        # the JAX OBB RCNN step fails here too: its sampler encodes AABB
        # targets for the 8-delta head (ROADMAP, known gaps of the reference)
        raise ValueError(
            f"fastrcnn_loss: {box_regression.shape[-1]} box deltas against "
            f"{reg_targets.shape[-1]}-wide targets; the reference's OBB RCNN train step "
            "samples without box_dim and fails at this point")
    class_logits = class_logits.float()
    box_regression = box_regression.float()
    safe_labels = labels.clamp_min(0)
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    n_valid = (valid.sum() if n_valid is None else n_valid).clamp_min(1)
    zero = torch.zeros_like(ce)
    classification_loss = torch.where(valid, ce, zero).sum() / n_valid
    pos = (labels >= 1) & valid
    sel = safe_labels[..., None, None].expand(*safe_labels.shape, 1, box_regression.shape[-1])
    own = torch.gather(box_regression, -2, sel)[..., 0, :]
    per = smooth_l1(own, reg_targets, beta=1 / 9).sum(-1)
    box_loss = torch.where(pos, per, zero).sum() / n_valid
    return classification_loss, box_loss


def project_gt_masks(gt_masks: torch.Tensor, boxes: torch.Tensor, matched_idx: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Each roi's matched gt voxel mask ``(K, W, L, H)`` uint8, RoI-aligned
    to ``(m, m, m)`` f32 targets. The mask is chosen inside the align's
    gather (``roi_batch = matched_idx``), so no ``(slots, W, L, H)`` copy is
    made and the masks stay uint8 until they are gathered."""
    return roi_align_3d(gt_masks[..., None], boxes, matched_idx, (m, m, m))[..., 0]


def maskrcnn_loss(mask_logits, boxes, gt_masks, labels, matched_idx, valid):
    """BCE of each valid roi's own-class mask logits against its RoI-aligned
    gt mask, over valid rois x m^3, in f32.

    mask_logits (M, m, m, m, C); boxes (M, 6); gt_masks (K, W, L, H); labels,
    matched_idx, valid (M,)."""
    m = mask_logits.shape[1]
    targets = project_gt_masks(gt_masks, boxes, matched_idx, m)
    sel = labels.clamp_min(0)[:, None, None, None, None].expand(*mask_logits.shape[:-1], 1)
    own = torch.gather(mask_logits.float(), -1, sel)[..., 0]
    bce = optax_sigmoid_ce(own, targets)
    denom = (valid.sum() * m ** 3).clamp_min(1)
    return torch.where(valid[:, None, None, None], bce, torch.zeros_like(bce)).sum() / denom


class Detections(NamedTuple):
    boxes: torch.Tensor  # (N, D, 6), (N, D, 7) OBBs with box_dim = 8
    scores: torch.Tensor  # (N, D)
    labels: torch.Tensor  # (N, D)
    valid: torch.Tensor  # (N, D)
    roi_index: torch.Tensor  # (N, D) which input roi produced it


def postprocess_detections(
    class_logits: torch.Tensor,  # (N, P, C)
    box_regression: torch.Tensor,  # (N, P, C, 6|8)
    proposals: torch.Tensor,  # (N, P, 6)
    prop_valid: torch.Tensor,  # (N, P)
    grid_sizes: torch.Tensor,  # (N, 3)
    score_thresh: float = 0.0,
    nms_thresh: float = 0.15,
    detections_per_img: int = 25,
    box_dim: int = 6,
    nms_sweep=None,
) -> Detections:
    """Fixed-shape detections per scene; invalid slots carry score and
    label 0. ``box_dim = 8`` decodes ``MidpointOffsetCoder`` deltas to
    ``(N, D, 7)`` OBBs, unclipped, through the OBB NMS (the rotated IoU of
    the valid candidates swept by kernel B2). ``nms_sweep`` replaces the NMS
    sweep (see ``ops.nms.nms_mask``)."""
    coder = MidpointOffsetCoder() if box_dim == 8 else AABBCoder()
    n, p, c = class_logits.shape
    dev = class_logits.device
    outs = []
    for i in range(n):
        scores = torch.softmax(class_logits[i], dim=-1)  # (P, C)
        props, pvalid = proposals[i], prop_valid[i]
        cand_boxes, cand_scores, cand_labels, cand_valid = [], [], [], []
        for cls in range(1, c):  # drop background class 0
            b = coder.decode(box_regression[i, :, cls], props)
            if box_dim == 6:
                b = clip_boxes_to_mesh(b, grid_sizes[i])
            sc = scores[:, cls]
            cand_boxes.append(b)
            cand_scores.append(sc)
            cand_labels.append(torch.full((p,), cls, dtype=torch.int32, device=dev))
            cand_valid.append(pvalid & (sc > score_thresh) & small_box_mask(b, 1e-2))
        boxes = torch.cat(cand_boxes)
        sc = torch.cat(cand_scores)
        lab = torch.cat(cand_labels)
        val = torch.cat(cand_valid)
        roi = torch.arange(p, dtype=torch.int32, device=dev).repeat(c - 1)
        keep = nms_ops.batched_nms_mask(boxes, sc, lab, nms_thresh, valid=val,
                                        sweep=nms_sweep)
        idx, mask = nms_ops.top_k_by_score(
            sc, min(detections_per_img, sc.shape[0]), valid=keep)
        outs.append((boxes[idx], sc[idx] * mask, lab[idx] * mask, mask, roi[idx]))
    return Detections(*(torch.stack(f) for f in zip(*outs)))


def maskrcnn_inference(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """sigmoid + the predicted class's channel:
    (..., m, m, m, C), (...,) -> (..., m, m, m)."""
    probs = torch.sigmoid(mask_logits)
    sel = labels.clamp_min(0).to(torch.int64)[..., None, None, None, None]
    sel = sel.expand(*probs.shape[:-1], 1)
    return torch.gather(probs, -1, sel)[..., 0]


class NeRF_RCNN(nn.Module):
    """Backbone + RoI heads over precomputed rois."""

    def __init__(self, backbone: nn.Module, num_classes: int = 11,
                 box_dim: int = 6, box_pool_size: int = 5,
                 mask_pool_size: int = 10, input_shape=(160, 160, 160),
                 out_channels: int = 256, dtype=None):
        super().__init__()
        self.backbone = backbone
        self.num_classes, self.box_dim = num_classes, box_dim
        self.box_pool_size, self.mask_pool_size = box_pool_size, mask_pool_size
        self.input_shape = tuple(input_shape)
        self.box_head = FastRCNNHead(out_channels * box_pool_size ** 3,
                                     num_classes, box_dim=box_dim, dtype=dtype)
        self.mask_head = MaskRCNNHead(out_channels, dtype=dtype)
        self.mask_predictor = MaskRCNNPredictor(256, num_classes, dtype=dtype)

    def features(self, grids):
        return list(self.backbone(grids))[:4]

    def box_forward(self, features, rois):
        pooled = multiscale_roi_align_3d(
            features, rois, (self.box_pool_size,) * 3, self.input_shape)
        return self.box_head(pooled)

    def mask_forward(self, features, rois):
        n, p = rois.shape[:2]
        pooled = multiscale_roi_align_3d(
            features, rois, (self.mask_pool_size,) * 3, self.input_shape)
        x = pooled.reshape(n * p, *pooled.shape[2:])
        logits = self.mask_predictor(self.mask_head(x))
        return logits.reshape(n, p, *logits.shape[1:])

    def forward(self, grids, rois, with_masks: bool = False):
        feats = self.features(grids)
        cls, deltas = self.box_forward(feats, rois)
        if with_masks:
            return feats, cls, deltas, self.mask_forward(feats, rois)
        return feats, cls, deltas


def paste_detections(det: Detections, mask_probs: torch.Tensor, grid_shape,
                     threshold=0.5):
    """Full-grid masks for one scene's detections (``det`` already indexed
    for that scene); ``mask_probs`` is ``(D, m, m, m)``."""
    return paste_masks_in_image(mask_probs, det.boxes, grid_shape, threshold)
