"""The field cells' traffic: synthetic posed-image scenes drawn from a seed.

A frozen copy of the port's ``data/nerf_dataset.py:make_synthetic_nerf_scene``
(coloured boxes in the unit cube, rendered by exact ray marching at 96
samples a ray, instance masks by weight majority), rendered here for all
views of a scene at once. A traffic file (``benchmark/traffic/<name>.json``)
gives the scene's parameters: ``n_views``, ``hw``, ``n_blobs`` and, for a
fleet, nothing more: the fleet's size is its configuration's.

Every seed gives scenes of the same size, so the work of a step is the
same from seed to seed; only the boxes and colours move.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.plain_field import composite, ray_aabb, sample_points


class Scene(NamedTuple):
    images: np.ndarray  # (V, H, W, 3) float32 in [0, 1]
    poses: np.ndarray  # (V, 4, 4) camera-to-world, OpenGL, unit-cube coordinates
    intrinsics: tuple  # (fx, fy, cx, cy)
    hw: tuple  # (H, W)
    masks: np.ndarray  # (V, H, W) int32 instance ids, 0 background


def look_at(eye, target=(0.5, 0.5, 0.5), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = (target - eye) / np.linalg.norm(target - eye)
    z = -fwd
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


@torch.no_grad()
def make_scene(rng: np.random.Generator, n_views: int, hw, n_blobs: int, device,
               fov: float = 0.9, blob_lo=(0.15, 0.6), blob_size=(0.15, 0.3),
               cam_radius: float = 1.6, cam_height: float = 1.3) -> Scene:
    """One scene: ``n_blobs`` boxes and colours from ``rng``, ``n_views``
    views on an orbit, rendered on ``device``."""
    boxes, colors = [], []
    for _ in range(n_blobs):
        lo = rng.uniform(*blob_lo, 3)
        hi = lo + rng.uniform(*blob_size, 3)
        boxes.append(np.concatenate([lo, np.minimum(hi, 0.9)]))
        colors.append(rng.uniform(0.2, 1.0, 3))
    box_t = torch.as_tensor(np.stack(boxes), dtype=torch.float32, device=device)
    col_t = torch.as_tensor(np.stack(colors), dtype=torch.float32, device=device)
    h, w = hw
    fx = fy = 0.5 * w / np.tan(0.5 * fov)
    intr = (fx, fy, w / 2.0, h / 2.0)
    poses = np.stack([look_at([0.5 + cam_radius * np.cos(2 * np.pi * v / n_views),
                               0.5 + cam_radius * np.sin(2 * np.pi * v / n_views),
                               cam_height]) for v in range(n_views)]).astype(np.float32)
    c2w = torch.as_tensor(poses, device=device)
    pix = torch.arange(h * w, device=device)
    py = (pix // w).to(torch.float32) + 0.5
    px = (pix % w).to(torch.float32) + 0.5
    dirs = torch.stack([(px - intr[2]) / fx, -(py - intr[3]) / fy, -torch.ones_like(px)], -1)
    d = torch.einsum("pj,vij->vpi", dirs, c2w[:, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, None, :3, 3].expand(d.shape)
    near, far = ray_aabb(o, d)
    valid = (far > near).to(torch.float32)
    xyz, t, dt = sample_points(o, d, 96, near, torch.maximum(far, near + 1e-4), 0.5)
    xyz = torch.clamp(xyz, 0.0, 1.0)
    inside = ((xyz[..., None, :] >= box_t[:, :3]) & (xyz[..., None, :] <= box_t[:, 3:])).all(-1)
    any_in = inside.any(-1)
    first = inside.to(torch.int32).argmax(-1)  # the first box a point is in
    sigma_raw = torch.where(any_in, 4.0, -15.0)
    rgb = torch.where(any_in[..., None], col_t[first], torch.zeros(3, device=device))
    out, weights = composite(sigma_raw, rgb, t, dt, torch.ones_like(t), valid)
    inst = torch.where(any_in, first + 1, 0)
    acc = torch.stack([(weights * (inst == k + 1)).sum(-1) for k in range(n_blobs)], -1)
    ids = torch.where(acc.sum(-1) > 0.5, acc.argmax(-1) + 1, 0)
    return Scene(images=out.reshape(n_views, h, w, 3).cpu().numpy(), poses=poses,
                 intrinsics=intr, hw=(h, w),
                 masks=ids.reshape(n_views, h, w).to(torch.int32).cpu().numpy())


def make_scenes(seed: int, count: int, traffic: dict, device) -> list:
    """``count`` scenes of the traffic's size, scene i from the stream
    ``(seed, i)``."""
    return [make_scene(np.random.default_rng([seed, i]), traffic["n_views"],
                       tuple(traffic["hw"]), traffic["n_blobs"], device)
            for i in range(count)]
