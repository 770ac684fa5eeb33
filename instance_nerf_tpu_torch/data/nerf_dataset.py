"""Posed-image (NeRF) dataset: instant-ngp transforms.json + 2D masks
(PyTorch-side copy of ``instance_nerf_tpu.data.nerf_dataset``).

Scenes are numpy on the host. ``NeRFScene.ray_batch`` draws with numpy's
``default_rng`` exactly as the JAX package does, so both trainers see the
same ray batches from the same seed. ``make_synthetic_nerf_scene`` renders
its ground truth with the port's own ``models/render.py``;
``write_nerf_scene`` stores a scene as a directory that ``load_nerf_scene``
(and the JAX package's) reads back. PNGs go through ``data/png.py``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from instance_nerf_tpu_torch.data.png import read_png, write_png


@dataclass
class NeRFScene:
    images: np.ndarray  # (V, H, W, 3) float32 in [0, 1]
    poses: np.ndarray  # (V, 4, 4) c2w, OpenGL convention, unit-cube coords
    intrinsics: tuple  # (fx, fy, cx, cy)
    hw: tuple  # (H, W)
    masks: np.ndarray | None = None  # (V, H, W) int32 instance ids, -1 unlabeled

    @property
    def num_views(self):
        return self.images.shape[0]

    def ray_batch(self, rng: np.random.Generator, batch_size: int):
        """Random (view, pixel) rays -> host arrays for the train step."""
        v = rng.integers(0, self.num_views, batch_size)
        h, w = self.hw
        pix = rng.integers(0, h * w, batch_size)
        rgb = self.images[v, pix // w, pix % w]
        inst = self.masks[v, pix // w, pix % w] if self.masks is not None else None
        return v, pix, rgb, inst


def _load_image(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        img = read_png(path)  # the port's own codec: no Pillow needed
    else:
        from PIL import Image  # other formats need Pillow

        img = np.asarray(Image.open(path))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def load_transforms(root: str, transforms_name: str = "transforms.json") -> dict:
    """The scene's ``transforms.json`` as a dict."""
    with open(os.path.join(root, transforms_name)) as f:
        return json.load(f)


def pose_to_unit_cube(c2w: np.ndarray, scale: float, offset: np.ndarray):
    out = c2w.copy()
    out[:3, 3] = out[:3, 3] * scale + offset
    return out


def load_nerf_scene(root: str, transforms_name: str = "transforms.json",
                    masks_dir: str | None = None, downscale: int = 1) -> NeRFScene:
    """An instant-ngp scene directory -> ``NeRFScene`` (poses mapped into the
    unit cube by the json's ``scale`` / ``offset``)."""
    meta = load_transforms(root, transforms_name)
    imgs, poses, masks = [], [], []
    for fr in meta["frames"]:
        p = fr["file_path"]
        if not os.path.isabs(p):
            p = os.path.join(root, p)
        if not os.path.splitext(p)[1]:
            p = p + ".png"
        img = _load_image(p)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        imgs.append(img)
        poses.append(np.asarray(fr["transform_matrix"], np.float64))
        if masks_dir is not None:
            stem = os.path.splitext(os.path.basename(p))[0]
            m = np.load(os.path.join(masks_dir, stem + ".npy")).astype(np.int32)
            if downscale > 1:
                m = m[::downscale, ::downscale]
            masks.append(m)

    h, w = imgs[0].shape[:2]
    if "fl_x" in meta:
        fx, fy = meta["fl_x"] / downscale, meta["fl_y"] / downscale
        cx = meta.get("cx", w * downscale / 2) / downscale
        cy = meta.get("cy", h * downscale / 2) / downscale
    else:
        fx = fy = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        cx, cy = w / 2.0, h / 2.0
    scale = float(meta.get("scale", 1.0))
    offset = np.asarray(meta.get("offset", [0.5, 0.5, 0.5]), np.float64)
    poses = np.stack([pose_to_unit_cube(p, scale, offset) for p in poses])
    return NeRFScene(images=np.stack(imgs).astype(np.float32),
                     poses=poses.astype(np.float32), intrinsics=(fx, fy, cx, cy),
                     hw=(h, w), masks=np.stack(masks) if masks else None)


def write_nerf_scene(root: str, scene: NeRFScene, masks_dir: str | None = "masks",
                     boxes=None, stem: str = "{:04d}") -> str:
    """Write ``scene`` as an instant-ngp directory: 8-bit PNG frames
    ``images/<stem>.png`` (``stem`` formats the view index; the JAX
    package's writer names them ``r_{:03d}``), ``transforms.json`` (its
    intrinsics, the unit-cube poses with scale 1 and offset 0), where the
    scene has masks and ``masks_dir`` is given ``<masks_dir>/<stem>.npy``,
    and where ``boxes`` are given ``boxes.npy``. Returns ``root``."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    fx, fy, cx, cy = (float(v) for v in scene.intrinsics)
    frames = []
    for v in range(scene.num_views):
        name = stem.format(v)
        write_png(os.path.join(root, "images", name + ".png"),
                  np.round(np.clip(scene.images[v], 0.0, 1.0) * 255.0).astype(np.uint8))
        frames.append({"file_path": f"images/{name}.png",
                       "transform_matrix": np.asarray(scene.poses[v], np.float64).tolist()})
        if scene.masks is not None and masks_dir:
            os.makedirs(os.path.join(root, masks_dir), exist_ok=True)
            np.save(os.path.join(root, masks_dir, name + ".npy"), scene.masks[v])
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "w": int(scene.hw[1]),
            "h": int(scene.hw[0]), "scale": 1.0, "offset": [0.0, 0.0, 0.0], "frames": frames}
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
    if boxes is not None:
        np.save(os.path.join(root, "boxes.npy"), np.asarray(boxes))
    return root


def look_at_pose(eye, target=(0.5, 0.5, 0.5), up=(0.0, 0.0, 1.0)):
    """OpenGL c2w looking from eye at target."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


@torch.no_grad()
def make_synthetic_nerf_scene(rng: np.random.Generator, n_views: int = 8, hw=(48, 48),
                              n_blobs: int = 3, fov: float = 0.9, blob_lo=(0.15, 0.6),
                              blob_size=(0.15, 0.3), cam_radius: float = 1.6,
                              cam_height: float = 1.3, device="cpu"):
    """Analytic volumetric scene (colored boxes in the unit cube) rendered by
    exact ray marching (96 samples per ray, no jitter): ground-truth images
    and weight-majority instance masks. Returns (NeRFScene, blob boxes
    (K, 6) in unit coords). The draws from ``rng`` are the JAX package's, so
    the same seed gives the same scene; ``device`` only says where it is
    rendered."""
    from instance_nerf_tpu_torch.models.render import (
        camera_rays,
        composite,
        ray_aabb,
        sample_points,
    )

    boxes, colors = [], []
    for _ in range(n_blobs):
        lo = rng.uniform(*blob_lo, 3)
        hi = lo + rng.uniform(*blob_size, 3)
        boxes.append(np.concatenate([lo, np.minimum(hi, 0.9)]))
        colors.append(rng.uniform(0.2, 1.0, 3))
    boxes = np.stack(boxes)
    colors = np.stack(colors)
    box_t = torch.as_tensor(boxes, dtype=torch.float32, device=device)
    col_t = torch.as_tensor(colors, dtype=torch.float32, device=device)

    def field(xyz):
        inside = torch.stack([((xyz >= box_t[k, :3]) & (xyz <= box_t[k, 3:])).all(-1)
                              for k in range(n_blobs)], dim=-1)  # (..., K)
        any_in = inside.any(-1)
        first = inside.to(torch.int32).argmax(-1)  # the first box a point is in
        sigma_raw = torch.where(any_in, 4.0, -15.0)
        rgb = torch.where(any_in[..., None], col_t[first], torch.zeros(3, device=device))
        inst = torch.where(any_in, first + 1, 0)
        return sigma_raw, rgb, inst

    h, w = hw
    fx = fy = 0.5 * w / np.tan(0.5 * fov)
    intr = (fx, fy, w / 2.0, h / 2.0)
    images, poses, masks = [], [], []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views
        eye = np.array([0.5 + cam_radius * np.cos(ang), 0.5 + cam_radius * np.sin(ang),
                        cam_height])
        c2w = look_at_pose(eye)
        o, d = camera_rays(torch.as_tensor(c2w, dtype=torch.float32, device=device), intr, hw)
        near, far = ray_aabb(o, d)
        valid = far > near
        far_c = torch.maximum(far, near + 1e-4)
        xyz, t, dt = sample_points(o, d, 96, near, far_c, stratified=False)
        sigma_raw, rgb, inst = field(torch.clamp(xyz, 0, 1))
        out = composite(sigma_raw, rgb, None, t, dt, valid=valid.to(torch.float32))
        images.append(out.rgb.cpu().numpy().reshape(h, w, 3))
        # instance mask: weight-majority id along the ray (accumulated weight
        # per id is sampling-density invariant)
        wgt = out.weights.cpu().numpy()
        inst_oh = inst.cpu().numpy()[..., None] == np.arange(1, n_blobs + 1)
        acc = (wgt[..., None] * inst_oh).sum(axis=1)  # (rays, K)
        ids = np.where(acc.sum(axis=1) > 0.5, acc.argmax(axis=1) + 1, 0)
        masks.append(ids.reshape(h, w).astype(np.int32))
        poses.append(np.asarray(c2w, np.float32))
    scene = NeRFScene(images=np.stack(images), poses=np.stack(poses), intrinsics=intr,
                      hw=hw, masks=np.stack(masks))
    return scene, boxes
