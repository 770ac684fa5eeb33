"""Anchor-based 3D RPN (PyTorch counterpart of ``instance_nerf_tpu.models.rpn``):
anchors, head, target assignment, losses and proposal filtering.

Anchors are numpy arrays built on the host once per feature geometry, as
the JAX package builds them at trace time. Head outputs are flattened
location-major and anchor-minor per level, as the JAX package does: the
convs run NCDHW inside, and their outputs are viewed channels-last before
any reshape, so delta channel ``a * d + k`` lands at anchor ``a``,
coordinate ``k``.

``filter_proposals``: per-level top-n (ties to the lower index), decode,
clip (AABB), small-box and score masks, per-level NMS (B1 for AABBs, the
rotated IoU and B2 for OBBs) and a global top-n, with static shapes.

Given the grid's W layout (``parallel/spatial.py``), the network runs on
this ``sp`` rank's rows of every level (halos in the backbone and the
head's k3 convs), its anchors are those of its rows in global voxel
coordinates, and ``rpn_loss`` takes the targets over the whole scene: each
gt's best anchor quality is the MAX over the ranks, and the balanced
sampler runs on the labels gathered from every rank in the global anchor
order (level-major; within a level location-major, so a rank's anchors of
a level are one contiguous range), each rank keeping its own columns. The
sampled masks are then those of one process on the whole grid.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instance_nerf_tpu_torch.models.layers import Conv3d
from instance_nerf_tpu_torch.ops import nms as nms_ops
from instance_nerf_tpu_torch.models.fcos import optax_sigmoid_ce, smooth_l1
from instance_nerf_tpu_torch.ops.boxes import (
    box_iou_3d,
    clip_boxes_to_mesh,
    obb2hbb_3d,
    obb2points_3d,
    small_box_mask,
)
from instance_nerf_tpu_torch.ops.coders import AABBCoder, MidpointOffsetCoder
from instance_nerf_tpu_torch.ops.projection import projection_loss_points
from instance_nerf_tpu_torch.ops.rotated_iou import cal_diou_3d, cal_giou_3d, cal_iou_3d
from instance_nerf_tpu_torch.ops.sampling import SampleResult, balanced_sample, match_proposals
from instance_nerf_tpu_torch.parallel.spatial import gather_over, max_over
from instance_nerf_tpu_torch.train.timing import NO_STAGES

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
                     strides: Sequence[tuple[int, int, int]],
                     w_offsets: Sequence[int] | None = None):
        """Per level an ``(R_l * A_l, 6)`` array; index = loc * A + a.
        ``w_offsets``: each level's first global W row (the anchors of a
        rank's rows ``[lo, lo + w)`` of a W-split level)."""
        out = []
        offsets = w_offsets or (0,) * len(feature_shapes)
        for lvl, (shape, stride) in enumerate(zip(feature_shapes, strides)):
            base = self.base_anchors(lvl)  # (A, 6)
            ax = [np.arange(o, o + s, dtype=np.float32) * st
                  for s, st, o in zip(shape, stride, (offsets[lvl], 0, 0))]
            gx, gy, gz = np.meshgrid(*ax, indexing="ij")
            shifts = np.stack([gx, gy, gz, gx, gy, gz], axis=-1).reshape(-1, 1, 6)
            out.append((shifts + base[None]).reshape(-1, 6))
        return out


class RPNHead(nn.Module):
    """Shared 3x3 conv tower -> 1x1 objectness + 1x1 deltas, run on every
    level. Outputs per level: logits ``(N, w, l, h, A)`` and deltas
    ``(N, w, l, h, A, d)`` with d = 8 (OBB) or 6 (AABB). With the levels'
    W ``layouts`` the k3 convs exchange their halos; the 1x1 convs take no
    other rank's rows."""

    def __init__(self, in_ch: int, num_anchors: int, conv_depth: int = 4,
                 rotated: bool = False, dtype=None):
        super().__init__()
        self.num_anchors, self.conv_depth = num_anchors, conv_depth
        self.box_dim = 8 if rotated else 6
        for i in range(conv_depth):
            self.add_module(f"conv_{i}", Conv3d(in_ch, in_ch, 3, dtype=dtype))
        self.cls_logits = Conv3d(in_ch, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv3d(in_ch, num_anchors * self.box_dim, 1, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor], layouts=None):
        logits, deltas = [], []
        for lvl, t in enumerate(features):
            lay = None if layouts is None else layouts[lvl]
            for i in range(self.conv_depth):
                t = F.relu(getattr(self, f"conv_{i}")(t, lay))
            logits.append(self.cls_logits(t, lay))  # channels-last view
            # reshape copies in channels-last order: channel a * d + k
            deltas.append(self.bbox_pred(t, lay).reshape(
                *t.shape[:4], self.num_anchors, self.box_dim))
        return logits, deltas


def flatten_head_outputs(logits, deltas):
    """(N, R_total) objectness + (N, R_total, D) deltas, location-major
    anchor-minor per level, levels concatenated."""
    n = logits[0].shape[0]
    # explicit sizes: a rank's level may hold no rows
    obj = torch.cat([l.reshape(n, math.prod(l.shape[1:])) for l in logits], dim=1)
    d = deltas[0].shape[-1]
    reg = torch.cat([r.reshape(n, math.prod(r.shape[1:-1]), d) for r in deltas], dim=1)
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


class RPNTargets(NamedTuple):
    labels: torch.Tensor  # (R,) f32 in {1, 0, -1}
    matched_gt: torch.Tensor  # (R, 6|7)


def assign_targets_to_anchors(
    anchors: torch.Tensor,  # (R, 6)
    gt_boxes: torch.Tensor,  # (K, 6|7)
    gt_mask: torch.Tensor,  # (K,)
    fg_iou_thresh: float = 0.7,
    bg_iou_thresh: float = 0.3,
    pad_mask: torch.Tensor | None = None,  # (R,)
    layout=None,
) -> RPNTargets:
    """One scene's anchor labels (1 positive, 0 negative, -1 ignored) and
    matched gt, by AABB IoU (an OBB gt through its enclosing AABB) with the
    low-quality matches recovered; a scene without gt is all background.
    With the grid's W ``layout`` the anchors are this rank's and a gt's
    best quality is the MAX over the ``sp`` ranks': every anchor at it, on
    whichever rank, keeps its argmax gt."""
    gt_for_iou = obb2hbb_3d(gt_boxes) if gt_boxes.shape[-1] == 7 else gt_boxes
    quality = box_iou_3d(gt_for_iou, anchors)  # (K, R)
    quality = torch.where(gt_mask[:, None], quality, torch.full_like(quality, -1.0))
    if pad_mask is not None:
        quality = torch.where(pad_mask[None, :], quality, torch.full_like(quality, -1.0))
    gt_best = None
    if layout is not None:
        gt_best = max_over(quality.amax(dim=-1) if quality.shape[-1]
                           else quality.new_full(quality.shape[:-1], -torch.inf), layout)
    matched = match_proposals(quality, fg_iou_thresh, bg_iou_thresh,
                              allow_low_quality_matches=True, gt_valid=gt_mask,
                              gt_best=gt_best)
    matched_gt = gt_boxes[matched.clamp_min(0)]
    one, zero, ignore = (torch.full(matched.shape, v, device=matched.device)
                         for v in (1.0, 0.0, -1.0))
    labels = torch.where(matched >= 0, one, torch.where(matched == -1, zero, ignore))
    if pad_mask is not None:
        labels = torch.where(pad_mask, labels, ignore)
    if not bool(gt_mask.any()):
        labels = zero if pad_mask is None else torch.where(pad_mask, zero, ignore)
        matched_gt = torch.zeros_like(matched_gt)
    return RPNTargets(labels, matched_gt)


def scene_labels(labels: torch.Tensor, layout, level_counts: Sequence[int]):
    """This rank's anchor labels ``(N, R)`` (levels of ``level_counts``
    anchors, concatenated) gathered from every ``sp`` rank into the scene's
    anchor order ``(N, R_scene)``, and this rank's columns there (a
    contiguous range a level: ``[(a, b)]``)."""
    dev = labels.device
    counts = gather_over(torch.tensor([list(level_counts)], dtype=torch.int64, device=dev),
                         layout, 0, sizes=[1] * layout.parts).cpu().numpy()  # (ranks, levels)
    parts, levels = counts.shape
    blocks = gather_over(labels.to(torch.int8), layout, 1,
                         sizes=counts.sum(1).tolist()).split(counts.reshape(-1).tolist(), 1)
    scene = torch.cat([blocks[q * levels + lvl] for lvl in range(levels) for q in range(parts)],
                      1).to(labels.dtype)
    first = (np.concatenate([[0], np.cumsum(counts.sum(0))[:-1]])
             + (np.cumsum(counts, 0) - counts)[layout.index])
    return scene, [(int(a), int(a + c)) for a, c in zip(first, counts[layout.index])]


def own_columns(x: torch.Tensor, cols) -> torch.Tensor:
    """The last axis's columns ``[(a, b)]`` of ``x``, concatenated."""
    return torch.cat([x[..., a:b] for a, b in cols], -1)


def sample_anchors(
    anchors: torch.Tensor,  # (R, 6)
    gt_boxes: torch.Tensor,  # (N, K, 6|7)
    gt_mask: torch.Tensor,  # (N, K)
    batch_size_per_mesh: int = 256,
    positive_fraction: float = 0.5,
    fg_iou_thresh: float = 0.7,
    bg_iou_thresh: float = 0.3,
    pad_mask: torch.Tensor | None = None,  # (N, R)
    uniforms: torch.Tensor | None = None,  # (N, 2, R_scene)
    generator: torch.Generator | None = None,
    shard=None,
    layout=None,
    level_counts: Sequence[int] | None = None,
):
    """``rpn_loss``'s targets: (labels ``(N, R)``, matched gt ``(N, R, 6|7)``,
    the balanced sample's ``SampleResult`` over these anchors). With the
    grid's W ``layout`` (``level_counts``: this rank's anchors a level) the
    sampler ranks the scene's labels, gathered from every ``sp`` rank, by
    uniforms over the scene's anchors, and this rank keeps its columns."""
    n = gt_boxes.shape[0]
    targets = [assign_targets_to_anchors(
        anchors, gt_boxes[i], gt_mask[i], fg_iou_thresh, bg_iou_thresh,
        None if pad_mask is None else pad_mask[i], layout) for i in range(n)]
    labels = torch.stack([t.labels for t in targets])
    scene, cols = labels, None
    if layout is not None:
        scene, cols = scene_labels(labels, layout, level_counts)
    if uniforms is None and shard is not None:
        uniforms = shard.rand((2, scene.shape[-1]), generator, labels.device)
    samples = balanced_sample(scene.to(torch.int64), batch_size_per_mesh, positive_fraction,
                              uniforms=uniforms, generator=generator)
    if cols is not None:
        samples = SampleResult(own_columns(samples.pos_mask, cols),
                               own_columns(samples.neg_mask, cols))
    return labels, torch.stack([t.matched_gt for t in targets]), samples


def rpn_loss(
    objectness: torch.Tensor,  # (N, R)
    pred_deltas: torch.Tensor,  # (N, R, 6|8)
    anchors: torch.Tensor,  # (R, 6)
    gt_boxes: torch.Tensor,  # (N, K, 6|7)
    gt_mask: torch.Tensor,  # (N, K)
    batch_size_per_mesh: int = 256,
    positive_fraction: float = 0.5,
    fg_iou_thresh: float = 0.7,
    bg_iou_thresh: float = 0.3,
    pad_mask: torch.Tensor | None = None,  # (N, R)
    rotated: bool = False,
    reg_loss_type: str = "smooth_l1",
    max_mesh_dim: int = 160,
    proj2d: bool = True,
    uniforms: torch.Tensor | None = None,  # (N, 2, R)
    generator: torch.Generator | None = None,
    shard=None,
    layout=None,
    level_counts: Sequence[int] | None = None,
) -> dict:
    """BCE objectness over the sampled anchors, box regression on the
    positives over the sampled count, and the 2D projection loss over the
    positive count. ``uniforms`` are the sampler's draws per scene (see
    ``ops.sampling.balanced_sample``), else drawn from ``generator``.

    In f32 whatever the head's dtype. The box and projection losses are
    computed on the positive rows alone: the rest add exactly 0 to the loss
    and the gradient in the JAX package's masked sums, so both are equal.
    The IoU-type losses take OBBs: the JAX package's would read an AABB's
    six numbers as an OBB's seven (its gather clamps index 6 to 5).

    ``shard`` (``parallel/mesh.py:Shard``, a data-parallel step): these
    are its rows of the global batch; the draws are its rows of the global
    batch's, and the sampled and positive counts are summed over the ranks,
    so that the losses sum over the ranks to the global batch's.

    ``layout`` (the grid's W layout on the mesh's spatial axis, with
    ``shard``): the head outputs, ``anchors`` (``level_counts`` a level) and
    ``pad_mask`` are this ``sp`` rank's; the targets are the whole scene's
    (``sample_anchors``), ``uniforms`` are drawn over the scene's anchors,
    and the numerators are this rank's, so that the ranks' losses add up to
    the global batch's."""
    if reg_loss_type != "smooth_l1" and not rotated:
        raise ValueError(f"reg_loss_type {reg_loss_type!r} needs rotated boxes")
    if layout is not None and shard is None:
        raise ValueError("a W layout needs the batch's shard: the counts sum over the world")
    objectness = objectness.float()
    pred_deltas = pred_deltas.float()
    coder = MidpointOffsetCoder() if rotated else AABBCoder()
    with torch.no_grad():
        labels, matched_gt, samples = sample_anchors(
            anchors, gt_boxes, gt_mask, batch_size_per_mesh, positive_fraction,
            fg_iou_thresh, bg_iou_thresh, pad_mask=pad_mask, uniforms=uniforms,
            generator=generator, shard=shard, layout=layout, level_counts=level_counts)
    pos = samples.pos_mask
    sampled = pos | samples.neg_mask
    num_sampled, num_pos = sampled.sum(), pos.sum()
    if shard is not None:
        num_sampled, num_pos = shard.sum(torch.stack([num_sampled, num_pos]))
    num_sampled, num_pos = num_sampled.clamp_min(1), num_pos.clamp_min(1)

    bce = optax_sigmoid_ce(objectness, labels)
    losses = {"loss_objectness":
              torch.where(sampled, bce, torch.zeros_like(bce)).sum() / num_sampled}

    at = pos.nonzero(as_tuple=True)
    deltas = pred_deltas[at]
    anchors_pos = anchors[at[1]]
    matched_gt = matched_gt[at]
    if reg_loss_type == "smooth_l1":
        reg_t = coder.encode(matched_gt, anchors_pos)
        per = smooth_l1(deltas, reg_t, beta=1 / 9).sum(-1)
    else:
        pred_boxes = coder.decode(deltas, anchors_pos)
        if reg_loss_type in ("iou", "linear_iou"):
            ious, _, _, _, unions = cal_iou_3d(pred_boxes, matched_gt, verbose=True)
            ious = (ious * unions + 1.0) / (unions + 1.0)
            per = -torch.log(ious.clamp_min(1e-10)) if reg_loss_type == "iou" else 1 - ious
        elif reg_loss_type == "giou":
            per = cal_giou_3d(pred_boxes, matched_gt)[0]
        else:
            per = cal_diou_3d(pred_boxes, matched_gt)[0]
    losses["loss_rpn_box_reg"] = per.sum() / num_sampled

    if proj2d:
        # box corner points through the 4 fixed cameras
        pred_boxes = coder.decode(deltas, anchors_pos)
        if rotated:
            pts_p, pts_t = obb2points_3d(pred_boxes), obb2points_3d(matched_gt)
        else:
            pts_p = torch.cat([pred_boxes[:, :3], pred_boxes[:, 3:]], dim=0)
            pts_t = torch.cat([matched_gt[:, :3], matched_gt[:, 3:]], dim=0)
        wts = torch.ones(pts_p.shape[0], dtype=pts_p.dtype, device=pts_p.device)
        losses["loss_rpn_box_reg_2d"] = projection_loss_points(
            pts_p, pts_t, wts, res=max_mesh_dim) / num_pos
    return losses


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
    stage=NO_STAGES,
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
    level (device tensors, cached per feature geometry, W offsets and
    device) and the features; given the grid's W ``layout``, all of them
    this ``sp`` rank's."""

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

    def features(self, grids, layout=None):
        """The levels; with the grid's W ``layout``, (levels, their layouts)."""
        n = len(self.fpn_strides)
        if layout is None:
            return list(self.backbone(grids))[:n]
        feats, layouts = self.backbone(grids, layout=layout)
        return list(feats)[:n], list(layouts)[:n]

    def anchors(self, features, layouts=None):
        shapes = tuple(tuple(f.shape[1:4]) for f in features)
        # a rank's rows: equal local shapes of two layouts are other anchors
        offsets = tuple(0 if lay is None else lay.lo for lay in layouts or ())
        dev = features[0].device
        key = (shapes, offsets, str(dev))
        if key not in self._anchors:
            strides = [(s,) * 3 for s in self.fpn_strides]
            self._anchors[key] = [torch.from_numpy(a).to(dev) for a in
                                  self.gen.grid_anchors(shapes, strides, offsets or None)]
        return self._anchors[key]

    def head(self, features, layouts=None):
        """Flattened objectness ``(N, R)`` and deltas ``(N, R, D)``."""
        return flatten_head_outputs(*self.rpn_head(features, layouts))

    def forward(self, grids, layout=None):
        layouts = None
        if layout is None:
            features = self.features(grids)
        else:
            features, layouts = self.features(grids, layout)
        obj, reg = self.head(features, layouts)
        return obj, reg, self.anchors(features, layouts), features
