"""Virtual-camera 2D projection for the auxiliary box loss (PyTorch
counterpart of ``instance_nerf_tpu.ops.projection``).

Four fixed cameras at the corners above the grid look at its centroid; box
points are projected through K [R|t] and their 2D smooth-L1 is the loss.
The anchor RPN's default loss and FCOS-OBB's optional one use it. The
camera matrices are host-side numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_K = np.array(
    [[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)


def _normalize(x):
    n = np.linalg.norm(x)
    return x / (n if n != 0 else 1.0)


def look_at_rotation(camera_position, at=None, up=(0, 0, -1)):
    """World->view rotation of a camera at ``camera_position`` looking at
    ``at`` (the origin by default)."""
    camera_position = np.asarray(camera_position, np.float64)
    at = np.zeros(3) if at is None else np.asarray(at, np.float64)
    up = np.asarray(up, np.float64)
    z_axis = _normalize(camera_position - at)
    x_axis = _normalize(np.cross(up, z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    return np.stack([x_axis, y_axis, z_axis], axis=1)


def c2w_from_loc_and_at(cam_pos, at, up=(0, 0, 1)):
    c2w = np.eye(4)
    c2w[:3, 3] = cam_pos
    c2w[:3, :3] = look_at_rotation(np.asarray(cam_pos, np.float64), at=at, up=up)
    return c2w


def get_w2cs(res: int = 160) -> np.ndarray:
    """(4, 4, 4) f32 world->camera matrices of the 4 fixed corner cameras."""
    centroid = np.array([res / 2.0] * 3)
    positions = (
        np.array([[res, res, res], [res, -res, res], [-res, res, res], [-res, -res, res]])
        + centroid
    )
    return np.stack(
        [np.linalg.inv(c2w_from_loc_and_at(p, centroid)) for p in positions]
    ).astype(np.float32)


def project(intrinsic: torch.Tensor, pose: torch.Tensor, points_h: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Homogeneous world points (N, 4) -> pixel coords (N, 2); |z| is held
    at ``eps`` or more so no point at the camera plane emits inf or NaN."""
    cam = points_h @ pose.T
    pic = cam[..., :3] @ intrinsic.T
    z = pic[..., 2:3]
    z = torch.where(torch.abs(z) < eps,
                    torch.where(z < 0, torch.full_like(z, -eps), torch.full_like(z, eps)), z)
    return pic[..., :2] / z


def projection_loss_points(pred_pts: torch.Tensor, target_pts: torch.Tensor,
                           weights: torch.Tensor, res: int, intrinsic=None,
                           beta: float = 1 / 9) -> torch.Tensor:
    """Weighted smooth-L1 between the projected 2D coords of (M, 3) predicted
    and target points, summed over the 4 cameras, over ``res``.

    Rows of weight 0 take the target's point (their gradient stays 0 and
    finite); predicted points are clipped to 4 ``res`` and |z| held at
    ``res / 4`` or more, because early decoded boxes can cross a camera
    plane where the 1/z^2 gradient overflows f32."""
    dev = pred_pts.device
    dt = torch.promote_types(pred_pts.dtype, target_pts.dtype)
    pred_pts, target_pts = pred_pts.to(dt), target_pts.to(dt)
    k = torch.as_tensor(DEFAULT_K if intrinsic is None else intrinsic, dtype=dt, device=dev)
    w2cs = torch.as_tensor(get_w2cs(res), dtype=dt, device=dev)
    ones = torch.ones((*pred_pts.shape[:-1], 1), dtype=dt, device=dev)
    pred_h = torch.cat([pred_pts, ones], dim=-1)
    tgt_h = torch.cat([target_pts, ones], dim=-1)
    sel = weights > 0
    pred_h = torch.where(sel[..., None], pred_h, tgt_h)
    lim = 4.0 * res
    pred_h = torch.cat([pred_h[..., :3].clamp(-lim, lim), pred_h[..., 3:]], dim=-1)
    z_eps = res / 4.0

    def sl1(d):
        a = torch.abs(d)
        return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)

    total = 0.0
    for i in range(w2cs.shape[0]):
        p2 = project(k, w2cs[i], pred_h, eps=z_eps)
        t2 = project(k, w2cs[i], tgt_h, eps=z_eps)
        per = torch.sum(sl1(p2 - t2), dim=-1)
        total = total + torch.sum(torch.where(sel, per * weights, torch.zeros_like(per)))
    return total / res
