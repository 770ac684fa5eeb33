"""Project 3D voxel instance masks into the training views (PyTorch
counterpart of ``instance_nerf_tpu.masks2d.project_masks``).

For every camera view and every detected 3D voxel mask, the mask's 2D
projection is rendered for match_seg: a pixel belongs to instance i when i
holds the largest share of the ray's accumulated INSTANCE weight (the
scene's alpha grid marched through instance voxels only, so background fog
is transparent while one instance still occludes another). Rays, near/far
and the unjittered samples are the renderer's (``models/render.py``).

    python -m instance_nerf_tpu_torch.masks2d.project_masks --masks_npz DET.npz \\
        --features_npz FEATS.npz --scene SCENE --out_dir PROJ [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.models.render import camera_rays, ray_aabb, sample_points


@torch.no_grad()
def project_voxel_masks(inst_grid, alpha_grid, pose, intrinsics, hw, n_samples: int = 192,
                        weight_thresh: float = 0.3, sigma_scale: float = 30.0,
                        chunk: int = 8192, min_weight: float = 0.02,
                        device=None) -> np.ndarray:
    """-> ``(H, W)`` int32 instance id of each pixel (0 where none).

    ``inst_grid (W, L, H)`` int ids (0 = none) and ``alpha_grid (W, L, H)``
    (the occlusion density) are read on ``device`` (default: where a tensor
    ``inst_grid`` lies, else the card). A pixel takes the winning instance
    when its share of the ray's accumulated instance weight exceeds
    ``weight_thresh`` and its weight exceeds ``min_weight``."""
    inst = torch.as_tensor(np.asarray(inst_grid) if not torch.is_tensor(inst_grid)
                           else inst_grid)
    dev = (inst.device if device is None and torch.is_tensor(inst_grid)
           else resolve_device(device))
    inst = inst.to(dev, torch.int64)
    alpha = torch.as_tensor(np.asarray(alpha_grid) if not torch.is_tensor(alpha_grid)
                            else alpha_grid).to(dev, torch.float32)
    h, w = hw
    pose = torch.as_tensor(np.asarray(pose) if not torch.is_tensor(pose) else pose,
                           dtype=torch.float32).to(dev)
    o_all, d_all = camera_rays(pose, intrinsics, hw)
    shape = torch.as_tensor(inst.shape, device=dev)
    res = shape.to(torch.float32)
    num_ids = int(inst.max()) + 1
    out = []
    for s in range(0, h * w, chunk):
        o, d = o_all[s:s + chunk], d_all[s:s + chunk]
        near, far = ray_aabb(o, d)
        valid = (far > near).to(torch.float32)
        far = torch.maximum(far, near + 1e-4)
        xyz, _, dt = sample_points(o, d, n_samples, near, far, stratified=False)
        idx = torch.minimum(torch.clamp((xyz * res).to(torch.int32), min=0), shape - 1).long()
        ids = inst[idx[..., 0], idx[..., 1], idx[..., 2]]  # (R, S)
        alpha_v = alpha[idx[..., 0], idx[..., 1], idx[..., 2]]
        # march INSTANCE density only: fog is transparent, instances occlude
        sigma = alpha_v * sigma_scale * (ids > 0)
        a = 1.0 - torch.exp(-sigma * dt)
        trans = torch.cumprod(1.0 - a + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        wgt = a * trans * valid[:, None]
        # accumulated weight of each id along the ray
        acc = torch.zeros((o.shape[0], num_ids), device=dev).scatter_add_(1, ids, wgt)
        acc[:, 0] = 0.0  # id 0 = no instance
        total = acc.sum(dim=-1)
        best_w, best = acc.max(dim=-1)
        pick = (best_w > weight_thresh * total) & (best_w > min_weight)
        out.append(torch.where(pick, best, 0).to(torch.int32).cpu())
    return torch.cat(out).reshape(h, w).numpy()


def write_projections(out_dir: str, inst_grid, alpha_grid, poses, intrinsics, hw,
                      device=None, **kwargs) -> int:
    """Per view ``<view>.npy`` (the id map) and, per instance seen,
    ``<view>_<id>.npy`` (its binary projection): the layout match_seg reads.
    Returns the number of views."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    inst = torch.as_tensor(np.asarray(inst_grid)).to(dev)
    alpha = torch.as_tensor(np.asarray(alpha_grid, np.float32)).to(dev)
    for v in range(len(poses)):
        ids = project_voxel_masks(inst, alpha, np.asarray(poses[v], np.float32), intrinsics,
                                  hw, device=dev, **kwargs)
        np.save(os.path.join(out_dir, f"{v:04d}.npy"), ids)
        for k in np.unique(ids):
            if k > 0:
                np.save(os.path.join(out_dir, f"{v:04d}_{k}.npy"), ids == k)
    return len(poses)


def main(argv=None):
    p = argparse.ArgumentParser("project_3d_masks")
    p.add_argument("--masks_npz", required=True,
                   help="RCNN output npz with 'masks' (K, W, L, H) bools")
    p.add_argument("--features_npz", required=True,
                   help="scene features npz (for the alpha/occlusion grid)")
    p.add_argument("--scene", required=True, help="scene root with transforms.json")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from instance_nerf_tpu_torch.data.datasets import load_feature_grid
    from instance_nerf_tpu_torch.data.nerf_dataset import load_nerf_scene

    device = resolve_device(args.device)
    with np.load(args.masks_npz) as det:
        masks = det["masks"]  # (K, W, L, H)
    inst = np.zeros(masks.shape[1:], np.int32)
    for k in range(masks.shape[0]):
        inst[masks[k] > 0] = k + 1
    feats = load_feature_grid(args.features_npz)
    scene = load_nerf_scene(args.scene, downscale=args.downscale)
    n = write_projections(args.out_dir, inst, feats[..., 3], scene.poses, scene.intrinsics,
                          scene.hw, device=device)
    print(f"projected {masks.shape[0]} instances over {n} views -> {args.out_dir}")


if __name__ == "__main__":
    main()
