"""Synthetic scene generation — test/bench data without 3D-FRONT (the
port's copy of ``instance_nerf_tpu.data.synthetic``, unchanged).

Random AABBs rasterized into RGBσ grids (SURVEY.md §4: "tiny end-to-end
runs on synthetic scenes (random boxes rasterized into grids)"). Also
writes the reference's full on-disk dataset layout so the CLIs can be
exercised end to end: features/ metadata/ masks/ rois/ +
dataset_split.json.
"""
from __future__ import annotations

import json
import os

import numpy as np

from instance_nerf_tpu_torch.data.datasets import FRONT3D_CLASS_IDS


def make_scene(
    rng: np.random.Generator,
    grid_size=(64, 64, 48),
    num_boxes: int = 5,
    min_side: int = 6,
    max_side: int = 24,
):
    """Returns (rgbsigma (W,L,H,4) f32, boxes (K,6), class_ids (K,) NYU40,
    instance_mask_grid (W,L,H) int64 with ids 1..K)."""
    w, l, h = grid_size
    grid = np.zeros((w, l, h, 4), np.float32)
    mask = np.zeros((w, l, h), np.int64)
    boxes, cls = [], []
    for i in range(num_boxes):
        sides = rng.integers(min_side, max_side + 1, 3)
        sides = np.minimum(sides, [w - 2, l - 2, h - 2])
        lo = np.array(
            [rng.integers(1, max(2, d - s)) for d, s in zip(grid_size, sides)]
        )
        hi = lo + sides
        color = rng.uniform(0.2, 1.0, 3)
        grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], :3] = color
        grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], 3] = rng.uniform(0.6, 1.0)
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = i + 1
        boxes.append(np.concatenate([lo, hi]).astype(np.float32))
        cls.append(int(rng.choice(FRONT3D_CLASS_IDS)))
    # mild noise so the detector can't key on exact zeros
    grid[..., 3] += rng.uniform(0, 0.02, (w, l, h)).astype(np.float32)
    return grid, np.stack(boxes), np.asarray(cls), mask


# class-conditioned appearance so a detector must actually *classify*:
# each 3D-FRONT class gets a distinctive base color and size range
# (fractions of the scene side). Order matches FRONT3D_CLASS_IDS.
CLASS_STYLES = {
    3: dict(color=(0.85, 0.25, 0.20), size=(0.10, 0.22), flat=0.9),   # chair
    4: dict(color=(0.20, 0.65, 0.85), size=(0.18, 0.35), flat=0.5),   # sofa-ish
    5: dict(color=(0.30, 0.80, 0.30), size=(0.15, 0.30), flat=0.4),   # table
    6: dict(color=(0.90, 0.75, 0.15), size=(0.20, 0.38), flat=0.45),  # bed
    7: dict(color=(0.60, 0.30, 0.80), size=(0.08, 0.16), flat=1.3),   # tall
    10: dict(color=(0.95, 0.50, 0.10), size=(0.12, 0.25), flat=1.1),
    14: dict(color=(0.15, 0.35, 0.75), size=(0.07, 0.14), flat=0.8),
    32: dict(color=(0.80, 0.20, 0.60), size=(0.10, 0.20), flat=1.6),  # slim
    35: dict(color=(0.25, 0.75, 0.65), size=(0.14, 0.26), flat=0.6),
    39: dict(color=(0.55, 0.55, 0.25), size=(0.06, 0.12), flat=1.0),  # small
}


def make_room_scene(
    rng: np.random.Generator,
    grid_size=(160, 160, 160),
    num_boxes=(6, 12),
    rotated: bool = False,
):
    """A richer synthetic 'room': floor + two walls as background
    structure, plus class-conditioned furniture boxes (color + size per
    class — CLASS_STYLES) optionally yaw-rotated.

    Returns (rgbsigma (W,L,H,4), boxes (K, 6|7 [cx..theta] if rotated),
    class_ids (K,) NYU40, instance mask grid (W,L,H) int64).
    """
    w, l, h = grid_size
    grid = np.zeros((w, l, h, 4), np.float32)
    mask = np.zeros((w, l, h), np.int64)
    side = min(w, l)

    # background structure: floor slab + two walls, muted gray
    floor_h = max(2, h // 40)
    wall_t = max(2, side // 50)
    gray = rng.uniform(0.35, 0.55)
    for sl in (np.s_[:, :, :floor_h], np.s_[:wall_t, :, :],
               np.s_[:, :wall_t, :]):
        grid[sl][..., :3] = gray + rng.uniform(-0.05, 0.05)
        grid[sl][..., 3] = rng.uniform(0.7, 0.95)

    k_boxes = int(rng.integers(num_boxes[0], num_boxes[1] + 1))
    boxes, cls = [], []
    for i in range(k_boxes):
        cid = int(rng.choice(list(CLASS_STYLES)))
        style = CLASS_STYLES[cid]
        base = np.asarray(style["color"])
        color = np.clip(base + rng.uniform(-0.12, 0.12, 3), 0.05, 1.0)
        lo_s, hi_s = style["size"]
        ext_xy = rng.uniform(lo_s, hi_s, 2) * side
        ext_z = np.clip(ext_xy.mean() * style["flat"]
                        * rng.uniform(0.8, 1.25), 3, h * 0.8)
        ext = np.array([ext_xy[0], ext_xy[1], ext_z])
        ctr = np.array([
            rng.uniform(wall_t + ext[0] / 2 + 1, w - ext[0] / 2 - 1),
            rng.uniform(wall_t + ext[1] / 2 + 1, l - ext[1] / 2 - 1),
            floor_h + ext[2] / 2,  # furniture sits on the floor
        ])
        theta = float(rng.uniform(-np.pi / 2, np.pi / 2)) if rotated else 0.0

        # rasterize (rotated) box over its bounding subgrid
        cth, sth = np.cos(theta), np.sin(theta)
        rx = abs(ext[0] / 2 * cth) + abs(ext[1] / 2 * sth)
        ry = abs(ext[0] / 2 * sth) + abs(ext[1] / 2 * cth)
        lo_i = np.maximum(np.floor(ctr - [rx, ry, ext[2] / 2]), 0).astype(int)
        hi_i = np.minimum(np.ceil(ctr + [rx, ry, ext[2] / 2]),
                          grid_size).astype(int)
        xs, ys, zs = [np.arange(lo_i[a], hi_i[a]) + 0.5 for a in range(3)]
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        dx, dy, dz = gx - ctr[0], gy - ctr[1], gz - ctr[2]
        # rotate into the box frame (inverse yaw)
        bx = cth * dx + sth * dy
        by = -sth * dx + cth * dy
        inside = (
            (np.abs(bx) <= ext[0] / 2) & (np.abs(by) <= ext[1] / 2)
            & (np.abs(dz) <= ext[2] / 2)
        )
        sub = np.s_[lo_i[0]:hi_i[0], lo_i[1]:hi_i[1], lo_i[2]:hi_i[2]]
        grid[sub][inside, :3] = color
        grid[sub][inside, 3] = rng.uniform(0.6, 1.0)
        mask[sub][inside] = i + 1

        if rotated:
            boxes.append(np.array([*ctr, *ext, theta], np.float32))
        else:
            boxes.append(np.concatenate(
                [ctr - ext / 2, ctr + ext / 2]).astype(np.float32))
        cls.append(cid)

    grid[..., 3] += rng.uniform(0, 0.02, (w, l, h)).astype(np.float32)
    return grid, np.stack(boxes), np.asarray(cls), mask


def jittered_rois(rng, boxes, grid_size, num_rois=64, noise=2.0):
    """Noisy proposals around gt (stand-in for RPN output) + fake level ids."""
    k = boxes.shape[0]
    reps = -(-num_rois // k)
    rois = np.repeat(boxes, reps, axis=0)[:num_rois]
    rois = rois + rng.normal(0, noise, rois.shape).astype(np.float32)
    rois[:, :3] = np.clip(rois[:, :3], 0, np.asarray(grid_size) - 2)
    rois[:, 3:] = np.clip(rois[:, 3:], rois[:, :3] + 1, np.asarray(grid_size))
    vols = np.cbrt(np.prod(rois[:, 3:] - rois[:, :3], axis=1))
    levels = np.clip(np.floor(np.log2(vols / 20 + 1e-6)) + 2, 0, 3).astype(np.int64)
    return rois.astype(np.float32), levels


def write_dataset(
    root: str,
    num_scenes: int = 4,
    grid_size=(64, 64, 48),
    num_boxes: int = 5,
    seed: int = 0,
    splits=(0.5, 0.25),
    style: str = "boxes",
    rotated: bool = False,
    compress: bool = True,
):
    """Write a reference-layout dataset (features/metadata/masks/rois +
    dataset_split.json). Boxes in metadata are stored in world coords with
    a scene_bbox so the loader's rescale path is exercised.

    ``style="room"`` uses make_room_scene (floor/walls + class-
    conditioned furniture); ``rotated=True`` additionally writes 7-param
    grid-coord OBBs to ``boxes_obb/<scene>.npy`` (the RPNDataset npy
    path) and metadata aabbs become the enclosing boxes.
    """
    rng = np.random.default_rng(seed)
    subs = ["features", "metadata", "masks", "rois"]
    if rotated:
        subs.append("boxes_obb")
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    scenes = []
    for i in range(num_scenes):
        scene = f"scene_{i:04d}"
        scenes.append(scene)
        if style == "room":
            grid, boxes, cls, mask = make_room_scene(
                rng, grid_size, (max(2, num_boxes - 3), num_boxes + 3),
                rotated=rotated,
            )
        else:
            grid, boxes, cls, mask = make_scene(rng, grid_size, num_boxes)
        if rotated:
            np.save(os.path.join(root, "boxes_obb", scene + ".npy"),
                    boxes.astype(np.float32))
            ctr, ext, th = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
            c, s = np.abs(np.cos(th)), np.abs(np.sin(th))
            rx = ext[:, 0] / 2 * c + ext[:, 1] / 2 * s
            ry = ext[:, 0] / 2 * s + ext[:, 1] / 2 * c
            half = np.stack([rx, ry, ext[:, 2] / 2], -1)
            boxes = np.concatenate([ctr - half, ctr + half], -1)
        # density stored raw-ish; the loader applies density_to_alpha.
        # alpha = 1-exp(-exp(sigma)/100)  =>  sigma = log(-100*log(1-alpha))
        alpha = np.clip(grid[..., 3], 1e-4, 0.95)
        sigma = np.log(-100.0 * np.log1p(-alpha))
        feat = np.concatenate([grid[..., :3], sigma[..., None]], axis=-1)
        save = np.savez_compressed if compress else np.savez
        save(
            os.path.join(root, "features", scene + ".npz"),
            rgbsigma=feat.astype(np.float32),
            resolution=np.asarray(grid_size),
        )
        # world coords: scene_bbox [-1, 1]^3-ish box scaled per axis
        scene_bbox = np.array([-2.0, -2.0, -1.5, 2.0, 2.0, 1.5])
        diag = scene_bbox[3:] - scene_bbox[:3]
        world_boxes = boxes.copy().astype(np.float64)
        world_boxes[:, :3] = world_boxes[:, :3] / np.asarray(grid_size) * diag + scene_bbox[:3]
        world_boxes[:, 3:] = world_boxes[:, 3:] / np.asarray(grid_size) * diag + scene_bbox[:3]
        metadata = {
            "scene_bbox": scene_bbox.tolist(),
            "instances": [
                {
                    "id": j + 1,
                    "aabb": world_boxes[j].tolist(),
                    "class_id": int(cls[j]),
                }
                for j in range(boxes.shape[0])
            ],
        }
        with open(os.path.join(root, "metadata", scene + ".json"), "w") as f:
            json.dump(metadata, f)
        np.save(os.path.join(root, "masks", scene + ".npy"), mask)
        rois, levels = jittered_rois(rng, boxes, grid_size)
        np.savez(
            os.path.join(root, "rois", scene + ".npz"),
            proposals=rois,
            level_indices=levels,
        )

    n_train = max(1, int(num_scenes * splits[0]))
    n_val = max(1, int(num_scenes * splits[1]))
    split = {
        "train": scenes[:n_train],
        "val": scenes[n_train : n_train + n_val],
        "test": scenes[n_train + n_val :] or scenes[-1:],
    }
    with open(os.path.join(root, "dataset_split.json"), "w") as f:
        json.dump(split, f)
    return scenes
