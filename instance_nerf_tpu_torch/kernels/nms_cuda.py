"""Greedy NMS sweeps: CUDA kernels B1 and B2 and their plain PyTorch
versions (the JAX package keeps both sweeps in ``kernels/nms_pallas.py``).

* B1 ``nms_boxes`` replaces ``nms_pallas.py:nms_boxes_pallas``: the AABB
  sweep with the IoU computed in the kernel (``csrc/nms_sweep.cu``).
* B2 ``nms_sweep`` replaces ``nms_pallas.py:nms_sweep_pallas``: the sweep
  over a precomputed score-ordered IoU matrix, which the OBB path fills
  with the rotated IoU (``csrc/nms_sweep_iou.cu``).

Both run in two phases (see ``csrc/nms_scan.cuh`` and the sources): a mask
pass over all pairs across the card writes every "IoU(i, j) > thr" (j > i)
as one bit of a ``(B, K, ceil(K / 64))`` uint64 mask, with a summary of its
nonzero words, then one block per problem scans it 64 rows at a time. The
wrapper allocates that workspace (about K^2 / 8 bytes a problem) and takes
K up to ``MAX_K``; above that it raises.

A wrapper takes a CUDA tensor to its kernel and a CPU tensor to its plain
version; a CUDA tensor never falls back to the plain version. Each call
counts one launch, whatever the number of CUDA launches inside.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from instance_nerf_tpu_torch.kernels import build
from instance_nerf_tpu_torch.ops.boxes import aabb_volume

# the largest K the kernels take (csrc/nms_scan.cuh kMaxK): a mask of 128 MB
# a problem
MAX_K = 32768
TILE = 64  # mask bits a word


def _check(sboxes: torch.Tensor, svalid: torch.Tensor) -> None:
    if sboxes.dtype != torch.float32:
        raise TypeError(f"sboxes must be float32, got {sboxes.dtype}")
    if sboxes.dim() not in (2, 3) or sboxes.shape[-1] != 6:
        raise ValueError(f"sboxes must be (K, 6) or (B, K, 6), got {tuple(sboxes.shape)}")
    if svalid.shape != sboxes.shape[:-1]:
        raise ValueError(f"svalid shape {tuple(svalid.shape)} does not match "
                         f"sboxes {tuple(sboxes.shape)}")
    if svalid.device != sboxes.device:
        raise ValueError("sboxes and svalid are on different devices")


def nms_boxes_plain(sboxes: torch.Tensor, svalid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Sequential greedy sweep in PyTorch; ``(.., K, 6)`` score-ordered boxes
    and ``(.., K)`` bool -> ``(.., K)`` bool keep. The IoU of row i against
    the later boxes is computed row by row (O(K) memory per row) with the
    exact ``box_iou_3d`` formula."""
    _check(sboxes, svalid)
    batched = sboxes.dim() == 3
    boxes = sboxes if batched else sboxes[None]
    valid = (svalid if batched else svalid[None]).to(torch.bool)
    k = boxes.shape[1]
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    lo, hi, vol = boxes[..., 0:3], boxes[..., 3:6], aabb_volume(boxes)
    sup = ~valid  # invalid boxes are never kept and never suppress
    for i in range(k - 1):
        alive = ~sup[:, i]  # (B,)
        lt = torch.maximum(lo[:, i:i + 1], lo[:, i + 1:])
        rb = torch.minimum(hi[:, i:i + 1], hi[:, i + 1:])
        whd = (rb - lt).clamp_min(0)
        inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
        union = vol[:, i:i + 1] + vol[:, i + 1:] - inter
        iou = torch.where(union > 0, inter / union.clamp_min(1e-12),
                          torch.zeros_like(inter))
        sup[:, i + 1:] |= alive[:, None] & (iou > thr)
    keep = ~sup
    return keep if batched else keep[0]


def nms_boxes(sboxes: torch.Tensor, svalid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy AABB NMS over score-ordered boxes -> bool keep (score order).

    ``sboxes`` is ``(K, 6)`` or ``(B, K, 6)`` float32 (B independent
    problems), ``svalid`` the matching bool mask. A CUDA tensor launches
    the kernel (and counts one launch); a CPU tensor runs
    ``nms_boxes_plain``."""
    _check(sboxes, svalid)
    if sboxes.device.type == "cpu":
        return nms_boxes_plain(sboxes, svalid, iou_threshold)
    if sboxes.device.type != "cuda":
        raise ValueError(f"unsupported device {sboxes.device}")
    if not sboxes.is_contiguous() or not svalid.is_contiguous():
        raise ValueError("sboxes and svalid must be contiguous")
    batched = sboxes.dim() == 3
    b, k = (sboxes.shape[0] if batched else 1), sboxes.shape[-2]
    keep = _launch("nms_sweep", sboxes, svalid, iou_threshold, b, k)
    nms_boxes.launches += int(keep.numel() > 0)
    return keep if batched else keep[0]


nms_boxes.launches = 0


def _check_iou(iou: torch.Tensor, svalid: torch.Tensor) -> None:
    if iou.dtype != torch.float32:
        raise TypeError(f"iou must be float32, got {iou.dtype}")
    if iou.dim() not in (2, 3) or iou.shape[-1] != iou.shape[-2]:
        raise ValueError(f"iou must be (K, K) or (B, K, K), got {tuple(iou.shape)}")
    if svalid.shape != iou.shape[:-1]:
        raise ValueError(f"svalid shape {tuple(svalid.shape)} does not match "
                         f"iou {tuple(iou.shape)}")
    if svalid.device != iou.device:
        raise ValueError("iou and svalid are on different devices")


def nms_sweep_plain(iou: torch.Tensor, svalid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Sequential greedy sweep in PyTorch over a ``(.., K, K)`` score-ordered
    IoU matrix and ``(.., K)`` bool -> ``(.., K)`` bool keep: box i is kept
    iff it is valid and no earlier kept box j has ``iou[j, i] > thr`` (in
    f32)."""
    _check_iou(iou, svalid)
    batched = iou.dim() == 3
    m = iou if batched else iou[None]
    sup = ~(svalid if batched else svalid[None]).to(torch.bool)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=m.device)
    for i in range(m.shape[1] - 1):
        alive = ~sup[:, i]  # (B,)
        sup[:, i + 1:] |= alive[:, None] & (m[:, i, i + 1:] > thr)
    keep = ~sup
    return keep if batched else keep[0]


def nms_sweep(iou: torch.Tensor, svalid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy NMS sweep over a score-ordered IoU matrix -> bool keep.

    ``iou`` is ``(K, K)`` or ``(B, K, K)`` float32 (B independent problems),
    ``svalid`` the matching ``(K,)`` / ``(B, K)`` bool mask. A CUDA tensor
    launches kernel B2 (and counts one launch); a CPU tensor runs
    ``nms_sweep_plain``."""
    _check_iou(iou, svalid)
    if iou.device.type == "cpu":
        return nms_sweep_plain(iou, svalid, iou_threshold)
    if iou.device.type != "cuda":
        raise ValueError(f"unsupported device {iou.device}")
    if not iou.is_contiguous() or not svalid.is_contiguous():
        raise ValueError("iou and svalid must be contiguous")
    batched = iou.dim() == 3
    b, k = (iou.shape[0] if batched else 1), iou.shape[-1]
    keep = _launch("nms_sweep_iou", iou, svalid, iou_threshold, b, k)
    nms_sweep.launches += int(keep.numel() > 0)
    return keep if batched else keep[0]


nms_sweep.launches = 0


def _launch(name: str, data: torch.Tensor, svalid: torch.Tensor, iou_threshold: float,
            b: int, k: int) -> torch.Tensor:
    """Both phases of ``csrc/<name>.cu`` on ``data`` (boxes or IoU matrix)
    -> ``(B, K)`` bool keep; nothing is launched for an empty problem."""
    keep = torch.empty((b, k), dtype=torch.bool, device=data.device)
    if b == 0 or k == 0:
        return keep
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the NMS kernels' limit of {MAX_K} boxes")
    if svalid.dtype != torch.bool:  # the kernels read one 0/1 byte per box
        svalid = svalid != 0
    # the workspace: the (B, K, W) uint64 suppression mask and its
    # (B, K, ceil(W / 64)) summary of nonzero words, as int64 words
    nw = -(-k // TILE)
    workspace = torch.empty(b * k * (nw + -(-nw // TILE)), dtype=torch.int64,
                            device=data.device)
    err = build.call_on_stream(_launch_fn(name), data.device.index, data.data_ptr(),
                               svalid.data_ptr(), iou_threshold, b, k, workspace.data_ptr(),
                               keep.data_ptr())
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return keep


@functools.lru_cache(maxsize=None)
def _launch_fn(name: str):
    """``csrc/<name>.cu``'s launch function, typed (built on first use):
    (data*, valid*, float thr, int batch, int k, workspace*, keep*, stream) -> int."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.typed(name, f"{name}_launch", [p, p, ctypes.c_float, i, i, p, p, p])
