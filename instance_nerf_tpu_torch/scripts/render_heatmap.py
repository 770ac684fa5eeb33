"""Objectness heatmap visualization (a numpy / matplotlib copy of
``instance_nerf_tpu.scripts.render_heatmap``).

Capability parity with ``nerf_rcnn/scripts/render_heatmap.py`` (pyvista
volume rendering upstream; this image has no pyvista/GL, so the renders
are matplotlib maximum-intensity projections + mid-slices per level —
the same voxel-score npz from ``run_rpn --output_voxel_scores`` /
FCOS objectness dumps as input).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def render_level(scores: np.ndarray, out_path: str, title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(12, 8))
    names = ["W", "L", "H"]
    for ax_i in range(3):
        mip = scores.max(axis=ax_i)
        axes[0, ax_i].imshow(mip.T, origin="lower", cmap="inferno")
        axes[0, ax_i].set_title(f"MIP along {names[ax_i]}")
        mid = scores.shape[ax_i] // 2
        sl = np.take(scores, mid, axis=ax_i)
        axes[1, ax_i].imshow(sl.T, origin="lower", cmap="inferno")
        axes[1, ax_i].set_title(f"slice {names[ax_i]}={mid}")
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser("render_heatmap")
    p.add_argument("--scores", required=True,
                   help="voxel-score npz (per-level arrays keyed '0','1',...)")
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    data = np.load(args.scores)
    stem = os.path.splitext(os.path.basename(args.scores))[0]
    for key in data.files:
        out = os.path.join(args.output_dir, f"{stem}_level{key}.png")
        render_level(data[key], out, title=f"{stem} level {key}")
        print("wrote", out)


if __name__ == "__main__":
    main()
