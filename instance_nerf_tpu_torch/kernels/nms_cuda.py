"""Greedy NMS sweeps: CUDA kernels B1 and B2 and their plain PyTorch
versions (the JAX package keeps both sweeps in ``kernels/nms_pallas.py``).

* B1 ``nms_boxes`` replaces ``nms_pallas.py:nms_boxes_pallas``: the AABB
  sweep with the IoU computed in the kernel (``csrc/nms_sweep.cu``).
* B2 ``nms_sweep`` replaces ``nms_pallas.py:nms_sweep_pallas``: the sweep
  over a precomputed score-ordered IoU matrix, which the OBB path fills
  with the rotated IoU (``csrc/nms_sweep_iou.cu``).

Both run one thread block per independent problem with the suppression
flags in shared memory; both are bound by the K-step dependency chain (one
barrier per surviving row), not by bytes or operations. See the sources
for the designs.

A wrapper takes a CUDA tensor to its kernel and a CPU tensor to its plain
version; a CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from instance_nerf_tpu_torch.ops.boxes import aabb_volume

SMEM_BYTES = 232448  # shared memory a block may use on sm_90 (227 KB)


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
    boxes = sboxes if batched else sboxes[None]
    valid = svalid if batched else svalid[None]
    b, k = boxes.shape[:2]
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep if batched else keep[0]
    if k > SMEM_BYTES:  # one flag byte per box must fit in shared memory
        raise ValueError(f"K={k} exceeds the kernel's shared-memory flag budget")
    lib = _lib("nms_sweep", "nms_sweep_launch")
    # structure of arrays (B, 7, K): lo xyz, hi xyz, volume as (dx*dy)*dz
    soa = torch.cat([boxes, aabb_volume(boxes)[..., None]], -1)
    soa = soa.transpose(1, 2).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_sweep_launch(
            soa.data_ptr(), valid_u8.data_ptr(), ctypes.c_float(iou_threshold),
            b, k, keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms_sweep launch failed: CUDA error {err}")
    nms_boxes.launches += 1
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
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if b == 0 or k == 0:
        return keep if batched else keep[0]
    if k > SMEM_BYTES:  # one flag byte per box must fit in shared memory
        raise ValueError(f"K={k} exceeds the kernel's shared-memory flag budget")
    lib = _lib("nms_sweep_iou", "nms_sweep_iou_launch")
    valid_u8 = svalid.to(torch.uint8).contiguous()
    with torch.cuda.device(iou.device):
        stream = torch.cuda.current_stream(iou.device).cuda_stream
        err = lib.nms_sweep_iou_launch(
            iou.data_ptr(), valid_u8.data_ptr(), ctypes.c_float(iou_threshold),
            b, k, keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms_sweep_iou launch failed: CUDA error {err}")
    nms_sweep.launches += 1
    return keep if batched else keep[0]


nms_sweep.launches = 0


def _lib(name: str, launch: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its launch function typed:
    (float*, uint8*, float thr, int batch, int k, uint8*, stream) -> int."""
    from instance_nerf_tpu_torch.kernels import build

    lib = build.load(name)
    fn = getattr(lib, launch)
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
