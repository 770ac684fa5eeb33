"""3D box geometry (PyTorch counterpart of ``instance_nerf_tpu.ops.boxes``).

* AABB: ``(N, 6)`` tensors ``(x1, y1, z1, x2, y2, z2)`` in grid coordinates.
* OBB: ``(N, 7)`` tensors ``(x, y, z, w, l, h, theta)``, z-axis yaw only;
  the 2D helpers take ``(x, y, w, h, theta)``.

Every function is differentiable by autograd where its output is real.

The arithmetic follows the JAX functions op for op, so the AABB results are
bit-identical on the same inputs; the OBB helpers differ from XLA's only by
the last bit of ``sin`` / ``cos`` / ``atan2``.
"""
from __future__ import annotations

import math

import torch

PI = math.pi


def aabb_volume(boxes: torch.Tensor) -> torch.Tensor:
    """Volume of ``(..., 6)`` AABBs, as ``(dx * dy) * dz``."""
    whd = boxes[..., 3:6] - boxes[..., 0:3]
    return whd[..., 0] * whd[..., 1] * whd[..., 2]


def box_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise AABB IoU ``(N, M)``; zero-volume unions give 0, not NaN."""
    vol1 = aabb_volume(boxes1)
    vol2 = aabb_volume(boxes2)
    lt = torch.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    rb = torch.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    whd = (rb - lt).clamp_min(0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    union = vol1[:, None] + vol2[None, :] - inter
    iou = inter / union.clamp_min(1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def clip_boxes_to_mesh(boxes: torch.Tensor, size) -> torch.Tensor:
    """Clamp ``(..., 6)`` AABBs to ``[0, size]`` per axis; ``size`` is
    ``(W, L, H)``."""
    size = torch.as_tensor(size, dtype=boxes.dtype, device=boxes.device)
    lo = torch.minimum(boxes[..., 0:3].clamp_min(0.0), size)
    hi = torch.minimum(boxes[..., 3:6].clamp_min(0.0), size)
    return torch.cat([lo, hi], dim=-1)


def obb_center_inside_mesh(boxes: torch.Tensor, size) -> torch.Tensor:
    """OBB validity: the center inside ``[0, size]`` on every axis (the
    reference drops such boxes; a mask here)."""
    size = torch.as_tensor(size, dtype=boxes.dtype, device=boxes.device)
    c = boxes[..., 0:3]
    return torch.all((c >= 0) & (c <= size), dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes (AABB or OBB) with *all* sides ``>= min_size``."""
    if boxes.shape[-1] == 6:
        whd = boxes[..., 3:6] - boxes[..., 0:3]
    else:  # OBB (x, y, z, w, l, h, theta)
        whd = boxes[..., 3:6]
    return torch.all(whd >= min_size, dim=-1)


def regular_theta(theta: torch.Tensor, mode: str = "180",
                  start: float = -PI / 2) -> torch.Tensor:
    """Wrap angles into ``[start, start + cycle)``: ``(theta - start) %
    cycle + start`` with the floor-mod written as XLA lowers ``%`` (an
    exact ``fmod``, then ``+ cycle`` where the sign differs)."""
    cycle = 2 * PI if mode == "360" else PI
    r = torch.fmod(theta - start, cycle)
    r = torch.where((r != 0) & (r < 0), r + cycle, r)
    return r + start


def regular_obb(obboxes: torch.Tensor) -> torch.Tensor:
    """Canonicalize 2D OBBs ``(x, y, w, h, theta)`` so that w >= h and
    theta lies in [-pi/2, pi/2)."""
    x, y, w, h, theta = obboxes.unbind(-1)
    swap = w > h
    w_r = torch.where(swap, w, h)
    h_r = torch.where(swap, h, w)
    t_r = regular_theta(torch.where(swap, theta, theta + PI / 2))
    return torch.stack([x, y, w_r, h_r, t_r], dim=-1)


def rectpoly2obb(polys: torch.Tensor) -> torch.Tensor:
    """Rectangular 4-point polygon ``(..., 8)`` -> 2D OBB ``(..., 5)``.

    The JAX function rotates the points with an ``einsum`` at HIGHEST
    precision; here the two products per coordinate are written out in
    f32, so no matmul unit (and no TF32) takes part."""
    eps = 1e-7
    theta = torch.atan2(-(polys[..., 3] - polys[..., 1]),
                        polys[..., 2] - polys[..., 0] + eps)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    x = torch.mean(polys[..., 0::2], dim=-1)
    y = torch.mean(polys[..., 1::2], dim=-1)
    px = polys[..., 0::2] - x[..., None]  # (..., 4)
    py = polys[..., 1::2] - y[..., None]
    # rot = [[c, -s], [s, c]]; rot_pts[n, j] = sum_i pts[n, i] * rot[j, i]
    rx = px * c + py * (-s)
    ry = px * s + py * c
    w = rx.amax(dim=-1) - rx.amin(dim=-1)
    h = ry.amax(dim=-1) - ry.amin(dim=-1)
    return regular_obb(torch.stack([x, y, w, h, theta], dim=-1))


def obb2hbb(obboxes: torch.Tensor) -> torch.Tensor:
    """2D OBB ``(..., 5)`` -> smallest enclosing 2D AABB ``(..., 4)``."""
    center = obboxes[..., 0:2]
    w, h, theta = obboxes[..., 2:3], obboxes[..., 3:4], obboxes[..., 4:5]
    c, s = torch.cos(theta), torch.sin(theta)
    x_bias = torch.abs(w / 2 * c) + torch.abs(h / 2 * s)
    y_bias = torch.abs(w / 2 * s) + torch.abs(h / 2 * c)
    bias = torch.cat([x_bias, y_bias], dim=-1)
    return torch.cat([center - bias, center + bias], dim=-1)


def obb2hbb_3d(obboxes: torch.Tensor) -> torch.Tensor:
    """3D OBB ``(..., 7)`` -> smallest enclosing AABB ``(..., 6)``."""
    z, d = obboxes[..., 2:3], obboxes[..., 5:6]
    hbb = obb2hbb(obboxes[..., [0, 1, 3, 4, 6]])
    return torch.cat([hbb[..., 0:2], z - d / 2, hbb[..., 2:4], z + d / 2], dim=-1)


def obb2poly(obboxes: torch.Tensor) -> torch.Tensor:
    """2D OBB ``(..., 5)`` -> 4 corner points ``(..., 8)``."""
    center = obboxes[..., 0:2]
    w, h, theta = obboxes[..., 2:3], obboxes[..., 3:4], obboxes[..., 4:5]
    c, s = torch.cos(theta), torch.sin(theta)
    v1 = torch.cat([w / 2 * c, -w / 2 * s], dim=-1)
    v2 = torch.cat([-h / 2 * s, -h / 2 * c], dim=-1)
    return torch.cat([center + v1 + v2, center + v1 - v2,
                      center - v1 - v2, center - v1 + v2], dim=-1)


def box_centers(boxes: torch.Tensor) -> torch.Tensor:
    """Centers of ``(..., 6)`` AABBs or ``(..., 7)`` OBBs."""
    if boxes.shape[-1] == 6:
        return 0.5 * (boxes[..., 0:3] + boxes[..., 3:6])
    return boxes[..., 0:3]


def obb2poly_3d(obboxes: torch.Tensor) -> torch.Tensor:
    """3D OBB ``(..., 7)`` -> its 8 corners ``(..., 24)``: the 4 lower ones,
    then the 4 upper ones, each ``(x, y, z)``."""
    poly2d = obb2poly(obboxes[..., [0, 1, 3, 4, 6]])
    half_h = obboxes[..., 5:6] / 2
    z0 = obboxes[..., 2:3] - half_h
    z1 = obboxes[..., 2:3] + half_h
    pts = poly2d.reshape(*poly2d.shape[:-1], 4, 2)
    lower = torch.cat([pts, z0[..., None, :].expand(*pts.shape[:-1], 1)], dim=-1)
    upper = torch.cat([pts, z1[..., None, :].expand(*pts.shape[:-1], 1)], dim=-1)
    lead = poly2d.shape[:-1]
    return torch.cat([lower.reshape(*lead, 12), upper.reshape(*lead, 12)], dim=-1)


def aabb2obb_3d(boxes: torch.Tensor) -> torch.Tensor:
    """AABB ``(..., 6)`` -> OBB ``(..., 7)`` with theta = 0."""
    center = 0.5 * (boxes[..., 0:3] + boxes[..., 3:6])
    whd = boxes[..., 3:6] - boxes[..., 0:3]
    return torch.cat([center, whd, torch.zeros_like(boxes[..., 0:1])], dim=-1)


def obb2points_3d(obboxes: torch.Tensor) -> torch.Tensor:
    """Two diagonal corners per OBB ``(..., 7)``, stacked along dim 0 (the
    2D projection loss's points): ``center - v`` of every box, then
    ``center + v``."""
    center = obboxes[..., 0:3]
    w, l, h = obboxes[..., 3:4], obboxes[..., 4:5], obboxes[..., 5:6]
    theta = obboxes[..., 6:7]
    c, s = torch.cos(theta), torch.sin(theta)
    vector = torch.cat([w / 2 * c - l / 2 * s, w / 2 * s + l / 2 * c, h / 2], dim=-1)
    return torch.cat([center - vector, center + vector], dim=0)
