"""Fixed-shape greedy 3D NMS (PyTorch counterpart of
``instance_nerf_tpu.ops.nms``).

Sort once by score (stable, as ``jnp.argsort``), run the greedy sweep over
the score-ordered boxes, scatter the keep mask back. AABB sweeps go through
kernel B1 (``kernels/nms_cuda.py:nms_boxes``), which computes the IoU
itself. OBB sweeps compute the dense rotated IoU matrix in row chunks
(``ops/rotated_iou.py:pairwise_iou_3d``) and sweep it with kernel B2
(``nms_cuda.py:nms_sweep``), which takes K up to ``nms_cuda.MAX_K``. The
matrix covers the valid boxes only (see ``nms_mask``); where the JAX
package streams the OBB sweep in row tiles (above its ``DENSE_NMS_MAX``,
``ops/nms.py:_sweep_xla_streamed``) the port still sweeps that dense
matrix. Each kernel runs for a CUDA tensor, its plain version for a CPU
tensor. Keep decisions are identical to the JAX package's on the same
inputs.
"""
from __future__ import annotations

import torch

from instance_nerf_tpu_torch.kernels.nms_cuda import MAX_K, nms_boxes, nms_sweep
from instance_nerf_tpu_torch.ops.rotated_iou import pairwise_iou_3d
from instance_nerf_tpu_torch.train.timing import NO_STAGES

NEG_INF = -1e30


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    sweep=None,
    stage=NO_STAGES,
) -> torch.Tensor:
    """Greedy NMS; returns a bool keep mask of shape ``(N,)``.

    ``boxes`` is ``(N, 6)`` AABB or ``(N, 7)`` OBB; ``valid`` an optional
    ``(N,)`` bool (invalid entries are never kept and never suppress).
    ``sweep`` replaces the sweep function: ``nms_boxes`` (boxes in) for
    AABBs, ``nms_sweep`` (IoU matrix in) for OBBs; a check that holds a
    kernel against its plain version on the card passes the latter.
    ``stage(name)`` opens a span around the OBB IoU (``obb_iou``) and the
    sweep (``nms_sweep``).

    The OBB IoU matrix is built and swept over the valid boxes alone, in
    score order. Invalid boxes are never kept and never suppress, so the
    keep mask is that of the sweep over all boxes, and FCOS-OBB's matrix
    shrinks from 10,000^2 to 6,125^2 entries at 160^3. It costs one
    device-to-host read (the count of valid boxes). More valid OBBs than
    ``nms_cuda.MAX_K`` raise ``ValueError`` before the IoU matrix is built.
    """
    n = boxes.shape[0]
    obb = boxes.shape[-1] == 7
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    eff_scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-eff_scores, stable=True)  # descending, stable
    if obb:
        # the valid boxes in the same relative order (a valid score may tie
        # NEG_INF, so take them by mask, not as a prefix)
        order = order[valid[order]]
        svalid = torch.ones((order.shape[0],), dtype=torch.bool, device=boxes.device)
    else:
        svalid = valid[order].contiguous()
    sboxes = boxes[order].to(torch.float32).contiguous()
    if obb:
        if sboxes.shape[0] > MAX_K:  # before the K x K IoU is built
            raise ValueError(f"OBB NMS over K={sboxes.shape[0]} boxes exceeds the "
                             f"sweep's limit of {MAX_K}")
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
    stage=NO_STAGES,
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
