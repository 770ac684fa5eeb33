"""Fixed-shape greedy 3D NMS (PyTorch counterpart of
``instance_nerf_tpu.ops.nms``).

Sort once by score (stable, as ``jnp.argsort``), run the greedy sweep over
the score-ordered boxes, scatter the keep mask back. AABB sweeps go through
kernel B1 (``kernels/nms_cuda.py:nms_boxes``), which computes the IoU
itself. OBB sweeps with ``K <= DENSE_NMS_MAX`` compute the dense rotated
IoU matrix in row chunks (``ops/rotated_iou.py:pairwise_iou_3d``) and
sweep it with kernel B2 (``nms_cuda.py:nms_sweep``). Each kernel runs for
a CUDA tensor, its plain version for a CPU tensor. Keep decisions are
identical to the JAX package's on the same inputs.
"""
from __future__ import annotations

import contextlib

import torch

from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes, nms_sweep
from instance_nerf_tpu_torch.ops.rotated_iou import pairwise_iou_3d

NEG_INF = -1e30
# Above this candidate count the JAX package streams the OBB IoU matrix
# through an XLA sweep instead of materialising it (``ops/nms.py:45-97``).
DENSE_NMS_MAX = 4096


def no_stage(name):
    """Default ``stage``: no span."""
    return contextlib.nullcontext()


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    sweep=None,
    stage=no_stage,
) -> torch.Tensor:
    """Greedy NMS; returns a bool keep mask of shape ``(N,)``.

    ``boxes`` is ``(N, 6)`` AABB or ``(N, 7)`` OBB; ``valid`` an optional
    ``(N,)`` bool (invalid entries are never kept and never suppress).
    ``sweep`` replaces the sweep function: ``nms_boxes`` (boxes in) for
    AABBs, ``nms_sweep`` (IoU matrix in) for OBBs; a check that holds a
    kernel against its plain version on the card passes the latter.
    ``stage(name)`` opens a span around the OBB IoU (``obb_iou``) and the
    sweep (``nms_sweep``).
    """
    n = boxes.shape[0]
    obb = boxes.shape[-1] == 7
    if obb and n > DENSE_NMS_MAX:
        raise NotImplementedError(
            f"OBB NMS over K={n} > {DENSE_NMS_MAX} candidates takes the streamed "
            "sweep, which comes with the FCOS slice (slice 4)")
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    eff_scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-eff_scores, stable=True)  # descending, stable
    sboxes = boxes[order].to(torch.float32).contiguous()
    svalid = valid[order].contiguous()
    if obb:
        with stage("obb_iou"):
            iou = pairwise_iou_3d(sboxes, sboxes)
        with stage("nms_sweep"):
            keep_sorted = (sweep or nms_sweep)(iou, svalid, iou_threshold)
    else:
        with stage("nms_sweep"):
            keep_sorted = (sweep or nms_boxes)(sboxes, svalid, iou_threshold)
    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    sweep=None,
    stage=no_stage,
) -> torch.Tensor:
    """Per-category NMS via the coordinate-offset trick: one fixed-shape
    pass that equals running NMS independently per class. AABBs shift all
    six coordinates; OBBs shift x only, by twice ``max|xyz| + max(whd) +
    1`` per category."""
    if boxes.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
    if boxes.shape[-1] == 6:
        span = torch.max(torch.abs(boxes)) + 1.0
        offsets = idxs.to(boxes.dtype) * (2.0 * span)
        shifted = boxes + offsets[:, None]
    else:
        span = torch.max(torch.abs(boxes[:, :3])) + torch.max(boxes[:, 3:6]) + 1.0
        offsets = idxs.to(boxes.dtype) * (2.0 * span)
        shifted = torch.cat([boxes[:, :1] + offsets[:, None], boxes[:, 1:]], dim=1)
    return nms_mask(shifted, scores, iou_threshold, valid=valid, sweep=sweep,
                    stage=stage)


def top_k_by_score(scores: torch.Tensor, k: int,
                   valid: torch.Tensor | None = None):
    """Indices + mask of the top-k valid scores (descending), fixed shape.

    Ties go to the lower index first, as ``jax.lax.top_k`` does: the order
    comes from a stable descending sort, which ``torch.topk`` does not
    promise."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    k = min(k, scores.shape[0])
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    mask = scores[idx] > NEG_INF / 2
    return idx, mask
