"""Instance-field quality metrics: 2D mask mIoU / panoptic quality (the
port's own copy of ``instance_nerf_tpu.eval.instance_field_metrics``).

Capability parity with SURVEY.md §6's instance-field quality row (the
reference's numbers live in the paper; the metric definitions here):
per-view instance-id maps (rendered vs gt) are greedily matched by IoU
per instance, then mIoU over matched pairs and PQ = SQ x RQ.
"""
from __future__ import annotations

import numpy as np


def instance_iou_matrix(pred: np.ndarray, gt: np.ndarray,
                        pred_ids, gt_ids) -> np.ndarray:
    p = np.stack([pred == i for i in pred_ids]).reshape(len(pred_ids), -1)
    g = np.stack([gt == i for i in gt_ids]).reshape(len(gt_ids), -1)
    inter = p.astype(np.float64) @ g.T.astype(np.float64)
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def evaluate_instance_masks(
    pred_maps, gt_maps, iou_thresh: float = 0.5, ignore_label: int = -1
) -> dict:
    """pred_maps/gt_maps: lists of (H, W) int id maps (0 = background).

    Returns mIoU over matched instances, PQ, SQ, RQ, and counts. Pixels
    labeled ``ignore_label`` in gt are excluded.
    """
    tp, fp, fn = 0, 0, 0
    iou_sum = 0.0
    ious_all = []
    for pred, gt in zip(pred_maps, gt_maps):
        valid = gt != ignore_label
        pred = np.where(valid, pred, 0)
        gt = np.where(valid, gt, 0)
        pred_ids = [i for i in np.unique(pred) if i > 0]
        gt_ids = [i for i in np.unique(gt) if i > 0]
        if not gt_ids and not pred_ids:
            continue
        if not pred_ids:
            fn += len(gt_ids)
            continue
        if not gt_ids:
            fp += len(pred_ids)
            continue
        iou = instance_iou_matrix(pred, gt, pred_ids, gt_ids)
        # greedy match (id-consistent fields usually have equal ids; the
        # greedy match makes the metric robust to re-labelled outputs)
        matched_p, matched_g = set(), set()
        pairs = sorted(
            ((iou[a, b], a, b) for a in range(len(pred_ids))
             for b in range(len(gt_ids))),
            reverse=True,
        )
        for v, a, b in pairs:
            if v < iou_thresh:
                break
            if a in matched_p or b in matched_g:
                continue
            matched_p.add(a)
            matched_g.add(b)
            tp += 1
            iou_sum += v
            ious_all.append(v)
        fp += len(pred_ids) - len(matched_p)
        fn += len(gt_ids) - len(matched_g)

    sq = iou_sum / tp if tp else 0.0
    rq = tp / max(tp + 0.5 * fp + 0.5 * fn, 1e-9)
    return {
        "miou": float(np.mean(ious_all)) if ious_all else 0.0,
        "pq": float(sq * rq),
        "sq": float(sq),
        "rq": float(rq),
        "tp": tp,
        "fp": fp,
        "fn": fn,
    }
