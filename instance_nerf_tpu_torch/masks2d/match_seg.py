"""Align 2D panoptic segments with 3D-consistent instance ids (the port's
own copy of ``instance_nerf_tpu.masks2d.match_seg``; PNG projections are
read with ``data/png.py``).

Capability parity with ``Mask2Former_sample/match_seg.py``: convert a
panoptic segmentation (+ segments_info) to a NYU40-filtered instance map
(0 = background surfaces, -1 = unlabeled), then reassign each 2D segment
to the projected-3D-mask instance id with maximal IoU (threshold 0.05,
match_seg.py:94,133), else -1.

TPU/host redesign: the per-(segment, projection) IoU double loop becomes
one vectorized boolean matrix product per view.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from instance_nerf_tpu_torch.data.png import read_png
from instance_nerf_tpu_torch.masks2d.coco_nyu40 import (
    NYU40_BACKGROUND,
    map_category,
)


def convert_seg(
    panoptic_seg: np.ndarray, segments_info: list[dict], category_names=None
) -> np.ndarray:
    """Panoptic ids -> NYU40-filtered instance map (ref: match_seg.py:65-91).

    ``segments_info`` entries: {id, category_id, isthing} (+ optional
    'category_name'). ``category_names`` maps (isthing, category_id) ->
    name when names aren't embedded.
    """
    seg = panoptic_seg.astype(np.int32)
    result = np.zeros_like(seg)
    result[seg == 0] = -1  # unlabeled

    for info in segments_info:
        sid = info["id"]
        assert sid > 0
        name = info.get("category_name")
        if name is None and category_names is not None:
            name = category_names[(bool(info["isthing"]), info["category_id"])]
        nyu = map_category(name or "", bool(info["isthing"]))
        if nyu == NYU40_BACKGROUND:
            result[seg == sid] = 0
        else:
            result[seg == sid] = sid
    return result


def panoptic_to_semantic(
    panoptic_seg: np.ndarray, segments_info: list[dict], category_names=None
) -> np.ndarray:
    """Panoptic ids -> NYU40 SEMANTIC map (ref: coco2nyu40.py
    panoptic_to_semantic): per-pixel NYU40 class id with the reference's
    swap convention — mapped background surfaces (40) become 0 and
    panoptic void (0) becomes 40."""
    seg = panoptic_seg.astype(np.int32)
    out = np.zeros_like(seg)
    for info in segments_info:
        name = info.get("category_name")
        if name is None and category_names is not None:
            name = category_names[(bool(info["isthing"]), info["category_id"])]
        nyu = map_category(name or "", bool(info["isthing"]))
        if nyu == NYU40_BACKGROUND:
            nyu = 0
        out[seg == info["id"]] = nyu
    out[seg == 0] = NYU40_BACKGROUND
    return out


def match_view(
    seg_map: np.ndarray,  # (H, W) int, NYU40-filtered instance map
    proj_masks: np.ndarray,  # (P, H, W) bool projected 3D masks
    proj_ids: np.ndarray,  # (P,) 3D-consistent instance ids
    iou_thresh: float = 0.05,
) -> np.ndarray:
    """Reassign positive 2D segment ids to best-IoU 3D ids (vectorized)."""
    output = seg_map.copy()
    if proj_masks.shape[0] == 0:
        output[seg_map > 0] = -1
        return output

    ids = np.unique(seg_map)
    ids = ids[ids > 0]
    if ids.size == 0:
        return output

    seg_onehot = (seg_map[None] == ids[:, None, None]).reshape(ids.size, -1)
    proj_flat = proj_masks.reshape(proj_masks.shape[0], -1)
    inter = seg_onehot.astype(np.float64) @ proj_flat.T.astype(np.float64)
    area_s = seg_onehot.sum(1)[:, None]
    area_p = proj_flat.sum(1)[None, :]
    union = np.maximum(area_s + area_p - inter, 1.0)
    iou = inter / union  # (S, P)

    best = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    for k, sid in enumerate(ids):
        if best_iou[k] > iou_thresh:
            output[seg_map == sid] = proj_ids[best[k]]
        else:
            output[seg_map == sid] = -1
    return output


def load_projections(proj_dir: str, img_idx: str):
    """Per-instance projection masks 'IMGIDX_INSTID.png' (or .npy);
    instance id 0 files are skipped (ref: match_seg.py:96-99)."""
    files = sorted(
        f for f in os.listdir(proj_dir)
        if "_" in f and f.startswith(img_idx + "_")
        and f.split("_")[1].split(".")[0] != "0"
    )
    masks, ids = [], []
    for f in files:
        path = os.path.join(proj_dir, f)
        if f.endswith(".npy"):
            m = np.load(path) > 0
        elif f.endswith(".png"):
            m = read_png(path)
            m = (m[..., 0] if m.ndim == 3 else m) > 0
        else:
            continue
        masks.append(m)
        ids.append(int(f.split("_")[1].split(".")[0]))
    if not masks:
        return np.zeros((0, 1, 1), bool), np.zeros(0, np.int64)
    return np.stack(masks), np.asarray(ids)


def match_scene(proj_dir: str, seg_dir: str, out_dir: str, iou_thresh=0.05):
    os.makedirs(out_dir, exist_ok=True)
    seg_files = sorted(f for f in os.listdir(seg_dir) if f.endswith(".npy"))
    for seg_file in seg_files:
        seg = np.load(os.path.join(seg_dir, seg_file)).astype(np.int32)
        info_path = os.path.join(seg_dir, seg_file.replace(".npy", ".json"))
        with open(info_path) as f:
            segments_info = json.load(f)
        seg = convert_seg(seg, segments_info)
        img_idx = seg_file.split(".")[0]
        proj_masks, proj_ids = load_projections(proj_dir, img_idx)
        out = match_view(seg, proj_masks, proj_ids, iou_thresh)
        np.save(os.path.join(out_dir, seg_file), out)
    return len(seg_files)


def main(argv=None):
    p = argparse.ArgumentParser("match_seg")
    p.add_argument("--proj_dir", required=True)
    p.add_argument("--seg_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--iou_thresh", type=float, default=0.05)
    args = p.parse_args(argv)
    for scene in sorted(os.listdir(args.seg_dir)):
        n = match_scene(
            os.path.join(args.proj_dir, scene),
            os.path.join(args.seg_dir, scene),
            os.path.join(args.out_dir, scene),
            args.iou_thresh,
        )
        print(f"{scene}: matched {n} views")


if __name__ == "__main__":
    main()
