"""Export proposals as instant-ngp ``transforms.json`` bounding boxes (a
numpy copy of ``instance_nerf_tpu.scripts.proposals2ngp``).

Capability parity with ``nerf_rcnn/scripts/proposals2ngp.py``: convert
grid-coordinate proposals (AABB or OBB) into instant-ngp's GUI frame and
append them as box annotations to a transforms.json. The frame gymnastics
match the reference exactly (scripts/proposals2ngp.py:10-101):

  grid -> world            via the feature file's bbox_min/bbox_max
  world (z-up) -> y-up     rows permuted by ``PERM_ZUP_TO_YUP``
  y-up -> ngp/nerf         ``ngp_matrix_to_nerf``: axis cycle xyz->yzx
                           (or x/z sign flips when the scene came from
                           mitsuba), negate the y/z basis columns, then
                           undo instant-ngp's scale/offset on the
                           translation.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

# world z-up -> ngp y-up (ref: proposals2ngp.py:31-36)
PERM_ZUP_TO_YUP = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)


def ngp_matrix_to_nerf(
    m: np.ndarray, scale: float, offset: np.ndarray, from_mitsuba: bool
) -> np.ndarray:
    """(3, 4) pose in ngp convention -> nerf/GUI frame
    (ref: proposals2ngp.py:10-21)."""
    out = np.array(m, np.float64, copy=True)
    if from_mitsuba:
        out[:, [0, 2]] *= -1
    else:
        out = out[[2, 0, 1], :]  # cycle axes xyz -> yzx
    out[:, [1, 2]] *= -1
    out[:, 3] = (out[:, 3] - np.asarray(offset, np.float64)) / scale
    return out


def _frame_params(features: dict, metadata: dict | None):
    """instant-ngp frame parameters from the features npz, with a
    metadata fallback for datasets that only store scene_bbox."""
    if all(k in features for k in ("bbox_min", "bbox_max")):
        bbox_min = np.asarray(features["bbox_min"], np.float64)
        bbox_max = np.asarray(features["bbox_max"], np.float64)
    elif metadata is not None and "scene_bbox" in metadata:
        sb = np.asarray(metadata["scene_bbox"], np.float64)
        bbox_min, bbox_max = sb[:3], sb[3:]
    else:
        raise ValueError("need bbox_min/bbox_max in features npz or "
                         "scene_bbox in metadata")
    scale = float(features["scale"]) if "scale" in features else 1.0
    offset = (np.asarray(features["offset"], np.float64)
              if "offset" in features else np.zeros(3))
    from_mitsuba = bool(features["from_mitsuba"]) if "from_mitsuba" in features else False
    grid_res = np.asarray(
        features["resolution"] if "resolution" in features else [160, 160, 160],
        np.float64,
    )
    return bbox_min, bbox_max, scale, offset, from_mitsuba, grid_res


def proposals_to_ngp_boxes(proposals, features, metadata=None) -> list[dict]:
    """AABB proposals (N, 6) in grid coords -> ngp GUI box dicts
    (ref: proposals2ngp.py:24-60)."""
    bbox_min, bbox_max, scale, offset, from_mitsuba, grid_res = _frame_params(
        features, metadata
    )
    diag = bbox_max - bbox_min
    box_min = proposals[:, :3] / grid_res * diag + bbox_min
    box_max = proposals[:, 3:6] / grid_res * diag + bbox_min
    offset_y = PERM_ZUP_TO_YUP @ offset

    boxes = []
    for lo, hi in zip(box_min, box_max):
        center = (lo + hi) * 0.5
        extent = (hi - lo) / scale
        xform = np.concatenate([np.eye(3), center[:, None]], axis=1)
        xform = PERM_ZUP_TO_YUP @ xform
        xform = ngp_matrix_to_nerf(xform, scale, offset_y, from_mitsuba)
        boxes.append({
            "orientation": xform[:3, :3].tolist(),
            "position": xform[:3, 3].tolist(),
            "extents": extent.tolist(),
        })
    return boxes


def obb_to_ngp_boxes(proposals, features, metadata=None) -> list[dict]:
    """OBB proposals (N, 7) = (x, y, z, w, l, h, theta) -> ngp GUI boxes
    (ref: proposals2ngp.py:63-102)."""
    bbox_min, bbox_max, scale, offset, from_mitsuba, grid_res = _frame_params(
        features, metadata
    )
    diag = bbox_max - bbox_min
    pos = proposals[:, :3] / grid_res * diag + bbox_min
    ext = proposals[:, 3:6] / grid_res * diag / scale
    rot = proposals[:, 6]
    offset_y = PERM_ZUP_TO_YUP @ offset

    boxes = []
    for p, e, r in zip(pos, ext, rot):
        c, s = np.cos(r), np.sin(r)
        xform = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        xform = np.concatenate([xform, p[:, None]], axis=1)
        xform = PERM_ZUP_TO_YUP @ xform
        xform = ngp_matrix_to_nerf(xform, scale, offset_y, from_mitsuba)
        boxes.append({
            "orientation": xform[:3, :3].tolist(),
            "position": xform[:3, 3].tolist(),
            "extents": e.tolist(),
        })
    return boxes


def main(argv=None):
    p = argparse.ArgumentParser("proposals2ngp")
    p.add_argument("--proposals", required=True,
                   help="rois npz (proposals[, scores])")
    p.add_argument("--features", default=None,
                   help="features npz with resolution/bbox/scale/offset")
    p.add_argument("--metadata", default=None,
                   help="scene metadata json (scene_bbox fallback)")
    p.add_argument("--transforms", required=True,
                   help="instant-ngp transforms.json to annotate")
    p.add_argument("--output", required=True)
    p.add_argument("--bbox_format", choices=["aabb", "obb"], default="aabb")
    p.add_argument("--grid_res", type=int, nargs=3, default=None)
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=None)
    args = p.parse_args(argv)

    rois = np.load(args.proposals)
    boxes = rois["proposals" if "proposals" in rois else "proposal"]
    scores = None
    for k in ("scores", "score"):
        if k in rois:
            scores = rois[k]
    if scores is not None and args.threshold > 0:
        keep = scores > args.threshold
        boxes, scores = boxes[keep], scores[keep]
    if args.top_k and scores is not None:
        idx = np.argsort(-scores)[: args.top_k]
        boxes, scores = boxes[idx], scores[idx]

    features = dict(np.load(args.features)) if args.features else {}
    metadata = None
    if args.metadata:
        with open(args.metadata) as f:
            metadata = json.load(f)
    if args.grid_res is not None:
        features["resolution"] = np.asarray(args.grid_res)

    if args.bbox_format == "obb" or boxes.shape[1] == 7:
        entries = obb_to_ngp_boxes(boxes, features, metadata)
    else:
        entries = proposals_to_ngp_boxes(boxes, features, metadata)
    if scores is not None:
        for e, s in zip(entries, scores):
            e["score"] = float(s)

    with open(args.transforms) as f:
        transforms = json.load(f)
    transforms["bounding_boxes"] = entries
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(transforms, f, indent=2)
    print(f"wrote {len(entries)} boxes -> {args.output}")


if __name__ == "__main__":
    main()
