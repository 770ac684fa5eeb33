"""NeRF-RCNN RoI heads and inference chain (PyTorch counterpart of
``instance_nerf_tpu.models.rcnn``, inference only).

softmax -> per-class decode -> clip -> small-box mask -> per-class NMS
(kernel B1 through ``ops/nms.py``) -> top-k -> mask head -> mask paste.
Pooled features keep the JAX layout ``(K, ow, ol, oh, C)``, so ``fc6``
takes them flattened channels-last exactly as the flax head does.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.layers import Conv3d, Linear, _cast, to_ncdhw, to_ndhwc
from instance_nerf_tpu_torch.ops import nms as nms_ops
from instance_nerf_tpu_torch.ops.boxes import clip_boxes_to_mesh, small_box_mask
from instance_nerf_tpu_torch.ops.coders import AABBCoder
from instance_nerf_tpu_torch.ops.mask_paste import paste_masks_in_image
from instance_nerf_tpu_torch.ops.poolers import multiscale_roi_align_3d


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


class Detections(NamedTuple):
    boxes: torch.Tensor  # (N, D, 6)
    scores: torch.Tensor  # (N, D)
    labels: torch.Tensor  # (N, D)
    valid: torch.Tensor  # (N, D)
    roi_index: torch.Tensor  # (N, D) which input roi produced it


def postprocess_detections(
    class_logits: torch.Tensor,  # (N, P, C)
    box_regression: torch.Tensor,  # (N, P, C, 6)
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
    label 0. ``nms_sweep`` replaces the NMS sweep (see ``ops.nms.nms_mask``)."""
    if box_dim != 6:
        raise NotImplementedError("OBB detections come with slice 5 (ROADMAP queue A)")
    coder = AABBCoder()
    n, p, c = class_logits.shape
    dev = class_logits.device
    outs = []
    for i in range(n):
        scores = torch.softmax(class_logits[i], dim=-1)  # (P, C)
        props, pvalid = proposals[i], prop_valid[i]
        cand_boxes, cand_scores, cand_labels, cand_valid = [], [], [], []
        for cls in range(1, c):  # drop background class 0
            b = clip_boxes_to_mesh(coder.decode(box_regression[i, :, cls], props),
                                   grid_sizes[i])
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
