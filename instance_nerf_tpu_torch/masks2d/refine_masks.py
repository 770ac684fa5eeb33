"""2D mask refinement, the CascadePSP slot (PyTorch-side copy of
``instance_nerf_tpu.masks2d.refine_masks``).

The reference optionally refines rendered instance masks with CascadePSP
(an external pretrained network) and retrains. This module provides the
same pipeline slot with two backends:

  * ``cascadepsp``: uses the external ``segmentation_refinement`` package
    + pretrained weights when available locally (like the reference's
    external dependency), on the card unless ``device="cpu"`` is passed.
  * ``guided`` (default, self-contained): fast RGB-guided filtering of
    each binary mask followed by thresholding — a classical edge-snapping
    refinement with no learned weights.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.data.png import read_png


def _box_filter(x: np.ndarray, r: int) -> np.ndarray:
    """O(1) box filter via integral images; x (H, W[, C])."""
    h, w = x.shape[:2]
    pad = np.pad(x, ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))
    ii = pad.cumsum(0).cumsum(1)
    y0 = np.clip(np.arange(h) - r, 0, h)
    y1 = np.clip(np.arange(h) + r + 1, 0, h)
    x0 = np.clip(np.arange(w) - r, 0, w)
    x1 = np.clip(np.arange(w) + r + 1, 0, w)
    out = (
        ii[y1[:, None], x1[None, :]]
        - ii[y0[:, None], x1[None, :]]
        - ii[y1[:, None], x0[None, :]]
        + ii[y0[:, None], x0[None, :]]
    )
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float64)
    return out / area[(...,) + (None,) * (x.ndim - 2)]


def guided_filter(guide: np.ndarray, src: np.ndarray, r: int = 4,
                  eps: float = 1e-3) -> np.ndarray:
    """He et al. guided filter, gray guide; guide (H, W), src (H, W)."""
    mean_i = _box_filter(guide, r)
    mean_p = _box_filter(src, r)
    corr_ip = _box_filter(guide * src, r)
    corr_ii = _box_filter(guide * guide, r)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box_filter(a, r) * guide + _box_filter(b, r)


def refine_mask_guided(image: np.ndarray, mask: np.ndarray, r: int = 4,
                       eps: float = 1e-3, thresh: float = 0.5) -> np.ndarray:
    """Edge-snap a binary mask to image edges. image (H, W, 3) [0,1]."""
    gray = image.mean(-1).astype(np.float64)
    soft = guided_filter(gray, mask.astype(np.float64), r, eps)
    return soft >= thresh


def refine_instance_map(image: np.ndarray, id_map: np.ndarray,
                        backend: str = "guided", **kwargs) -> np.ndarray:
    """Refine every instance in an id map; ties broken by soft score."""
    ids = [i for i in np.unique(id_map) if i > 0]
    if not ids:
        return id_map.copy()
    if backend == "cascadepsp":
        return _refine_cascadepsp(image, id_map, ids, **kwargs)
    best = np.full(id_map.shape, -np.inf)
    out = np.where(id_map == 0, 0, -1).astype(id_map.dtype)
    gray = image.mean(-1).astype(np.float64)
    for i in ids:
        soft = guided_filter(gray, (id_map == i).astype(np.float64),
                             kwargs.get("r", 4), kwargs.get("eps", 1e-3))
        win = (soft >= kwargs.get("thresh", 0.5)) & (soft > best)
        out[win] = i
        best = np.maximum(best, np.where(soft >= kwargs.get("thresh", 0.5), soft, -np.inf))
    out[out == -1] = 0
    return out


def _refine_cascadepsp(image, id_map, ids, **kwargs):
    try:
        import segmentation_refinement as sr  # external, like the reference
    except ImportError as e:
        raise SystemExit(
            "CascadePSP backend needs the 'segmentation_refinement' package "
            "and its pretrained weights (external dependency, exactly like "
            "the reference). Use --backend guided for the self-contained "
            "refinement."
        ) from e
    refiner = sr.Refiner(device=str(resolve_device(kwargs.get("device", "cuda"))))
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    out = np.zeros_like(id_map)
    for i in ids:
        m = ((id_map == i) * 255).astype(np.uint8)
        ref = refiner.refine(img8, m, fast=True)
        out[ref > 127] = i
    return out


def main(argv=None):
    p = argparse.ArgumentParser("refine_masks")
    p.add_argument("--images", required=True, help="dir of view pngs")
    p.add_argument("--masks", required=True, help="dir of instance-id npys")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--backend", default="guided", choices=["guided", "cascadepsp"])
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(args.masks)):
        if not f.endswith(".npy"):
            continue
        stem = os.path.splitext(f)[0]
        img_path = os.path.join(args.images, stem + ".png")
        if not os.path.isfile(img_path):
            continue
        img = read_png(img_path).astype(np.float32) / 255.0
        ids = np.load(os.path.join(args.masks, f))
        out = refine_instance_map(img[..., :3], ids, backend=args.backend)
        np.save(os.path.join(args.out_dir, f), out)
        n += 1
    print(json.dumps({"refined": n, "out": args.out_dir}))


if __name__ == "__main__":
    main()
