"""Host-side scene augmentation (numpy, channels-last ``(W, L, H, C)``):
the port's copy of ``instance_nerf_tpu.data.augment``, unchanged.

Semantics parity with ``nerf_rcnn/datasets.py:121-175`` (per-axis flips,
z-up 90° rotation, extra rotate+scale trilinear resample with box
transforms incl. OBB theta negation); layout is channels-last because the
device pipeline is.
"""
from __future__ import annotations

import numpy as np


def rotate90_z(rgbsigma: np.ndarray, boxes: np.ndarray | None):
    """90° rotation about the z (up) axis: swap W/L then flip new W."""
    out = np.flip(np.swapaxes(rgbsigma, 0, 1), axis=0).copy()
    if boxes is not None:
        boxes = boxes.copy()
        if boxes.shape[1] == 6:
            boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
            boxes[:, [0, 3]] = out.shape[0] - boxes[:, [3, 0]]
        else:  # OBB
            boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
            boxes[:, 0] = out.shape[0] - boxes[:, 0]
    return out, boxes


def flip_axis(rgbsigma: np.ndarray, boxes: np.ndarray | None, axis: int):
    """Mirror along a horizontal axis (0=W or 1=L for z-up)."""
    out = np.flip(rgbsigma, axis=axis).copy()
    if boxes is not None:
        boxes = boxes.copy()
        if boxes.shape[1] == 6:
            boxes[:, [axis, axis + 3]] = out.shape[axis] - boxes[:, [axis + 3, axis]]
        else:
            boxes[:, axis] = out.shape[axis] - boxes[:, axis]
            boxes[:, -1] = -boxes[:, -1]
    return out, boxes


def _trilinear_sample(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample (W, L, H, C) volume at continuous coords (..., 3), zeros
    outside (mirrors grid_sample align_corners=True + zero padding)."""
    w, l, h, _ = vol.shape
    c = coords
    inside = np.all((c >= 0) & (c <= np.array([w - 1, l - 1, h - 1])), axis=-1)
    c = np.clip(c, 0, np.array([w - 1, l - 1, h - 1]))
    i0 = np.floor(c).astype(np.int64)
    i1 = np.minimum(i0 + 1, np.array([w - 1, l - 1, h - 1]))
    f = c - i0
    out = 0.0
    for dx, wx in ((0, 1 - f[..., 0:1]), (1, f[..., 0:1])):
        for dy, wy in ((0, 1 - f[..., 1:2]), (1, f[..., 1:2])):
            for dz, wz in ((0, 1 - f[..., 2:3]), (1, f[..., 2:3])):
                ix = i1[..., 0] if dx else i0[..., 0]
                iy = i1[..., 1] if dy else i0[..., 1]
                iz = i1[..., 2] if dz else i0[..., 2]
                out = out + vol[ix, iy, iz] * (wx * wy * wz)
    return out * inside[..., None]


def rotate_and_scale(
    rgbsigma: np.ndarray, boxes: np.ndarray | None, angle: float, scale: float
):
    """Resample the grid under a z-rotation + uniform scale about the grid
    center; boxes (OBB only) adjust theta/size/center accordingly
    (ref: datasets.py:459-497)."""
    if boxes is not None:
        assert boxes.shape[1] == 7, "rotate_and_scale expects OBB boxes"
    res = np.array(rgbsigma.shape[:3])
    rot = np.array(
        [
            [np.cos(angle), -np.sin(angle), 0],
            [np.sin(angle), np.cos(angle), 0],
            [0, 0, 1],
        ]
    ) * scale

    axes = [np.arange(r, dtype=np.float64) - (r - 1) / 2 for r in res]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)  # centered
    src = grid @ rot.T + (res - 1) / 2
    out = _trilinear_sample(rgbsigma, src).astype(rgbsigma.dtype)

    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 6] -= angle
        boxes[:, 3:6] /= scale
        center = res / 2
        offset = (boxes[:, :3] - center) @ (rot / (scale * scale))
        boxes[:, :3] = offset + center
    return out, boxes


def draw_augment(rng: np.random.Generator, obb: bool, flip_prob: float = 0.0,
                 rotate_prob: float = 0.0, rot_scale_prob: float = 0.0) -> tuple:
    """The draws of ``augment_rpn_inputs`` for one scene with (``obb``) or
    without OBB boxes, in its order: (rot90, flip W, flip L, (angle, scale)
    of the rotate+scale or None)."""
    rot = rng.random() < rotate_prob
    flips = tuple(rng.random() < flip_prob for _ in (0, 1))
    rs = None
    if obb and rng.random() < rot_scale_prob:
        rs = (rng.uniform(-np.pi / 18, np.pi / 18), rng.uniform(0.9, 1.1))
    return (rot, *flips, rs)


def apply_augment(rgbsigma: np.ndarray, boxes: np.ndarray | None, draws: tuple):
    rot, flip_w, flip_l, rs = draws
    if rot:
        rgbsigma, boxes = rotate90_z(rgbsigma, boxes)
    for axis, flip in ((0, flip_w), (1, flip_l)):
        if flip:
            rgbsigma, boxes = flip_axis(rgbsigma, boxes, axis)
    if rs is not None:
        rgbsigma, boxes = rotate_and_scale(rgbsigma, boxes, *rs)
    return rgbsigma, boxes


def augment_rpn_inputs(
    rng: np.random.Generator,
    rgbsigma: np.ndarray,
    boxes: np.ndarray | None,
    flip_prob: float = 0.0,
    rotate_prob: float = 0.0,
    rot_scale_prob: float = 0.0,
):
    """Compose the reference's augmentation schedule (z-up)."""
    obb = boxes is not None and boxes.shape[1] == 7
    return apply_augment(rgbsigma, boxes,
                         draw_augment(rng, obb, flip_prob, rotate_prob, rot_scale_prob))
