"""RGBσ grid -> PLY point cloud + gt/proposal box wireframes (a numpy copy of
``instance_nerf_tpu.scripts.visualize_rpn_input``).

Capability parity with ``nerf_rcnn/scripts/visualize_rpn_input.py``
(upstream writes ply point clouds + boxes). Pure-python PLY writer — no
GL dependency.
"""
from __future__ import annotations

import argparse

import numpy as np


def write_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray):
    n = xyz.shape[0]
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(header.encode())
        rec = np.zeros(
            n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
        )
        rec["xyz"] = xyz.astype(np.float32)
        rec["rgb"] = rgb.astype(np.uint8)
        rec.tofile(f)


BOX_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply_boxes(path: str, boxes: np.ndarray, color=(255, 0, 0)):
    """AABB wireframes as PLY edges."""
    verts, edges = [], []
    for b in boxes:
        base = len(verts)
        for dx in (0, 3):
            for dy in (1, 4):
                for dz in (2, 5):
                    verts.append([b[dx], b[dy], b[dz]])
        edges.extend([(base + i, base + j) for i, j in BOX_EDGES])
    verts = np.asarray(verts, np.float32)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        f.write(header.encode())
        verts.tofile(f)
        np.asarray(edges, np.int32).tofile(f)


def main(argv=None):
    p = argparse.ArgumentParser("visualize_rpn_input")
    p.add_argument("--features", required=True, help="scene features npz")
    p.add_argument("--boxes", default="", help="boxes npy or rois npz")
    p.add_argument("--output", required=True, help="output prefix (writes _pts.ply/_boxes.ply)")
    p.add_argument("--alpha_thresh", type=float, default=0.2)
    p.add_argument("--max_points", type=int, default=500000)
    args = p.parse_args(argv)

    from instance_nerf_tpu_torch.data.datasets import load_feature_grid

    grid = load_feature_grid(args.features)
    alpha = grid[..., 3]
    sel = np.argwhere(alpha > args.alpha_thresh)
    if sel.shape[0] > args.max_points:
        idx = np.random.default_rng(0).choice(sel.shape[0], args.max_points, False)
        sel = sel[idx]
    rgb = (grid[sel[:, 0], sel[:, 1], sel[:, 2], :3] * 255).clip(0, 255)
    write_ply_points(args.output + "_pts.ply", sel.astype(np.float32), rgb)
    print(f"wrote {sel.shape[0]} points -> {args.output}_pts.ply")

    if args.boxes:
        if args.boxes.endswith(".npz"):
            boxes = np.load(args.boxes)["proposals"]
        else:
            boxes = np.load(args.boxes)
        write_ply_boxes(args.output + "_boxes.ply", boxes[:, :6])
        print(f"wrote {boxes.shape[0]} boxes -> {args.output}_boxes.ply")


if __name__ == "__main__":
    main()
