"""Detection evaluation metrics (host-side numpy): the port's copy of
``instance_nerf_tpu.eval.metrics``, unchanged.

Capability parity with ``nerf_rcnn/eval.py``: greedy-matched proposal
Recall/AR, precision, confidence-swept AP, VOC-style AP, and class-aware
mAP/AR over boxes or 3D voxel masks. These run once per eval epoch on
variable-length per-scene results, so numpy (not jit) is the right tool —
the per-scene work is tiny next to the device-side model.

All inputs are lists of per-scene numpy arrays:
  proposals[i]: (P_i, 6) AABBs, scores[i]: (P_i,), gt_boxes[i]: (G_i, 6).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def box_iou_3d_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, M) pairwise AABB IoU (numpy twin of ops.boxes.box_iou_3d)."""
    v1 = np.prod(np.clip(boxes1[:, 3:6] - boxes1[:, 0:3], 0, None), axis=1)
    v2 = np.prod(np.clip(boxes2[:, 3:6] - boxes2[:, 0:3], 0, None), axis=1)
    lt = np.maximum(boxes1[:, None, 0:3], boxes2[None, :, 0:3])
    rb = np.minimum(boxes1[:, None, 3:6], boxes2[None, :, 3:6])
    whd = np.clip(rb - lt, 0, None)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    union = v1[:, None] + v2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou_3d_np(masks1: np.ndarray, masks2: np.ndarray, chunk: int = 8) -> np.ndarray:
    """(N, M) pairwise voxel-mask IoU (ref: utils.py:786-802), chunked."""
    m1 = masks1.reshape(masks1.shape[0], -1).astype(bool)
    m2 = masks2.reshape(masks2.shape[0], -1).astype(bool)
    out = np.zeros((m1.shape[0], m2.shape[0]), np.float64)
    a1 = m1.sum(1)
    a2 = m2.sum(1)
    for s in range(0, m1.shape[0], chunk):
        block = m1[s : s + chunk]
        inter = block.astype(np.float64) @ m2.T.astype(np.float64)
        union = a1[s : s + chunk, None] + a2[None, :] - inter
        out[s : s + chunk] = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return out


def _greedy_gt_coverage(overlaps: np.ndarray) -> np.ndarray:
    """Detectron-style greedy bipartite match; returns per-gt best IoU."""
    overlaps = overlaps.copy()
    num_p, num_g = overlaps.shape
    cover = np.zeros(num_g)
    for j in range(min(num_p, num_g)):
        max_over_props = overlaps.max(axis=0)  # per gt
        gt_ind = int(max_over_props.argmax())
        box_ind = int(overlaps[:, gt_ind].argmax())
        cover[j] = overlaps[box_ind, gt_ind]
        overlaps[box_ind, :] = -1
        overlaps[:, gt_ind] = -1
    return cover


def evaluate_box_proposals_recall(
    proposals_list, scores_list, gt_boxes_list, thresholds=None, limit=None
):
    """Recall@IoU over greedy-matched proposals + AR (ref: eval.py:15-82)."""
    gt_overlaps = []
    num_pos = 0
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        gt = np.asarray(gt)
        order = np.argsort(-scores)
        proposals = proposals[order]
        if proposals.shape[0] == 0 or gt.shape[0] == 0:
            continue
        num_pos += gt.shape[0]
        if limit is not None:
            proposals = proposals[:limit]
        gt_overlaps.append(_greedy_gt_coverage(box_iou_3d_np(proposals, gt)))

    gt_overlaps = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    gt_overlaps = np.sort(gt_overlaps)
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    thresholds = np.asarray(thresholds)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / max(num_pos, 1) for t in thresholds]
    )
    return {
        "ar": recalls.mean(),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }


def evaluate_box_proposals_precision(
    proposals_list, scores_list, gt_boxes_list,
    score_thresh=0.0, thresholds=None, limit=None,
):
    """Precision@IoU of score-filtered proposals (ref: eval.py:85-163)."""
    box_overlaps = []
    num_det = 0
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        gt = np.asarray(gt)
        keep = scores >= score_thresh
        proposals, scores = proposals[keep], scores[keep]
        order = np.argsort(-scores)
        proposals = proposals[order]
        if proposals.shape[0] == 0:
            continue
        if limit is not None:
            proposals = proposals[:limit]
        num_det += proposals.shape[0]
        if gt.shape[0] == 0:
            box_overlaps.append(np.zeros(proposals.shape[0]))
            continue
        # greedy from the proposal side
        cover = _greedy_gt_coverage(box_iou_3d_np(gt, proposals))
        padded = np.zeros(proposals.shape[0])
        padded[: cover.shape[0]] = cover
        box_overlaps.append(padded)

    box_overlaps = np.concatenate(box_overlaps) if box_overlaps else np.zeros(0)
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    thresholds = np.asarray(thresholds)
    precisions = np.array(
        [(box_overlaps >= t).sum() / max(num_det, 1) for t in thresholds]
    )
    return {
        "precision": precisions,
        "thresholds": thresholds,
        "num_det": num_det,
    }


def evaluate_box_proposals_average_precision(
    proposals_list, scores_list, gt_boxes_list, iou_thresh=0.25, top_k=None
):
    """Confidence-threshold-swept AP (ref: eval.py:229-317)."""
    box_overlaps, box_scores = [], []
    num_gt = 0
    for proposals, scores, gt in zip(proposals_list, scores_list, gt_boxes_list):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        gt = np.asarray(gt)
        if scores.ndim > 1:
            scores = scores[..., 1]
        order = np.argsort(-scores)
        proposals, scores = proposals[order], scores[order]
        num_gt += gt.shape[0]
        if proposals.shape[0] == 0:
            continue
        if top_k is not None:
            proposals, scores = proposals[:top_k], scores[:top_k]

        overlaps = box_iou_3d_np(proposals, gt) if gt.shape[0] else np.zeros(
            (proposals.shape[0], 0)
        )
        _ovr = np.zeros(proposals.shape[0])
        _scr = np.zeros(proposals.shape[0])
        ov = overlaps.copy()
        for j in range(min(proposals.shape[0], gt.shape[0])):
            max_per_prop = ov.max(axis=1)
            box_ind = int(max_per_prop.argmax())
            gt_ind = int(ov[box_ind].argmax())
            _ovr[j] = ov[box_ind, gt_ind]
            _scr[j] = scores[box_ind]
            ov[box_ind, :] = -1
            ov[:, gt_ind] = -1
        box_overlaps.append(_ovr)
        box_scores.append(_scr)

    box_overlaps = np.concatenate(box_overlaps) if box_overlaps else np.zeros(0)
    box_scores = np.concatenate(box_scores) if box_scores else np.zeros(0)

    conf = np.arange(0.01, 0.99 + 1e-5, 0.01)
    hits = box_overlaps >= iou_thresh
    precisions = np.zeros_like(conf)
    recalls = np.zeros_like(conf)
    for i, t in enumerate(conf):
        sel = box_scores >= t
        nd = sel.sum()
        precisions[i] = hits[sel].sum() / nd if nd > 0 else 0.0
        recalls[i] = hits[sel].sum() / num_gt if num_gt > 0 else 0.0
    ap = float(np.sum((recalls[:-1] - recalls[1:]) * precisions[:-1]))
    return {
        "ap": ap,
        "precisions": precisions,
        "recalls": recalls,
        "thresholds": iou_thresh,
        "score_thresh": conf,
    }


def _voc_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    mrec = np.concatenate(([0.0], recalls, [1.0]))
    mpre = np.concatenate(([0.0], np.nan_to_num(precisions), [0.0]))
    for i in range(mpre.shape[0] - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_box_proposals_ap(
    proposals_list, scores_list, gt_boxes_list, iou_thresh=0.25, top_k=None
):
    """VOC-style AP with per-gt dedup across the full set (ref: eval.py:320-396)."""
    scene_ids, all_dets, all_scores = [], [], []
    num_gt = 0
    gts = [np.asarray(g) for g in gt_boxes_list]
    for i, (proposals, scores) in enumerate(zip(proposals_list, scores_list)):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        if top_k is not None and proposals.shape[0] > top_k:
            ids = np.argsort(-scores)[:top_k]
            proposals, scores = proposals[ids], scores[ids]
        scene_ids.extend([i] * proposals.shape[0])
        all_dets.append(proposals)
        all_scores.append(scores)
        num_gt += gts[i].shape[0]

    scene_ids = np.asarray(scene_ids, np.int64)
    all_dets = np.concatenate(all_dets) if all_dets else np.zeros((0, 6))
    all_scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    order = np.argsort(-all_scores)
    all_dets, scene_ids = all_dets[order], scene_ids[order]

    gt_used = [np.zeros(g.shape[0], bool) for g in gts]
    tp = np.zeros(all_dets.shape[0], bool)
    for i in range(all_dets.shape[0]):
        g = gts[scene_ids[i]]
        if g.shape[0] == 0:
            continue
        overlaps = box_iou_3d_np(all_dets[i : i + 1], g)[0]
        j = int(overlaps.argmax())
        if overlaps[j] > iou_thresh and not gt_used[scene_ids[i]][j]:
            tp[i] = True
            gt_used[scene_ids[i]][j] = True

    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(~tp)
    recalls = tp_c / max(num_gt, 1)
    precisions = tp_c / np.maximum(tp_c + fp_c, 1)
    return {
        "ap": _voc_ap(recalls, precisions),
        "precisions": precisions,
        "recalls": recalls,
        "thresholds": iou_thresh,
    }


def evaluate_labels(proposals_list, gt_boxes_list, ap_thresholds=(0.25, 0.5)):
    """Binary objectness labels per proposal at IoU thresholds (legacy
    classification path; ref: eval.py:166-180)."""
    out = []
    for thr in ap_thresholds:
        per_thr = []
        for props, gts in zip(proposals_list, gt_boxes_list):
            props = np.asarray(props)
            gts = np.asarray(gts)
            if props.shape[0] == 0:
                per_thr.append(np.zeros(0, np.int32))
                continue
            if gts.shape[0] == 0:
                per_thr.append(np.zeros(props.shape[0], np.int32))
                continue
            best = box_iou_3d_np(props, gts).max(axis=1)
            per_thr.append((best >= thr).astype(np.int32))
        out.append(per_thr)
    return out


def evaluate_classification_accuracy(scores_list, gt_label_list, threshold):
    """Mean per-scene accuracy of thresholded objectness (ref: eval.py:183-200)."""
    accs = []
    for scores, labels in zip(scores_list, gt_label_list):
        pred = (np.asarray(scores) > threshold).astype(np.int32)
        accs.append((pred == np.asarray(labels)).mean() if pred.size else 0.0)
    return float(np.mean(accs)) if accs else 0.0


def evaluate_classification(scores_list, gt_label_list, threshold):
    """Precision / accuracy / precision@100 (ref: eval.py:203-226)."""
    precisions, accs, p100 = [], [], []
    for scores, labels in zip(scores_list, gt_label_list):
        scores = np.asarray(scores)
        labels = np.asarray(labels)
        if scores.ndim > 1:
            scores = scores[..., 1]
        order = np.argsort(-scores)[:100]
        if order.size:
            p100.append(labels[order].sum() / order.size)
        pos = scores > threshold
        if pos.sum() > 0:
            precisions.append(labels[pos].sum() / pos.sum())
        accs.append((labels == pos.astype(labels.dtype)).mean() if labels.size else 0.0)
    return {
        "precision": float(np.mean(precisions)) if precisions else 0.0,
        "accuracy": float(np.mean(accs)) if accs else 0.0,
        "precision_100": float(np.mean(p100)) if p100 else 0.0,
    }


def evaluate_map_recall(
    pred_boxes_list, pred_scores_list, pred_labels_list,
    gt_boxes_list, gt_labels_list,
    iou_thresh=0.25, top_k=None, iou_type="box",
):
    """Class-aware mAP/AR for boxes or 3D voxel masks (ref: eval.py:399-512).

    Returns (ap, recalls): arrays of length n_classes (index = label id),
    NaN for labels with no gt.
    """
    assert iou_type in ("box", "mask")
    iou_fn = box_iou_3d_np if iou_type == "box" else mask_iou_3d_np

    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)

    for preds, scores, plabels, gts, glabels in zip(
        pred_boxes_list, pred_scores_list, pred_labels_list,
        gt_boxes_list, gt_labels_list,
    ):
        preds = np.asarray(preds)
        scores = np.asarray(scores)
        plabels = np.asarray(plabels).astype(np.int64)
        gts = np.asarray(gts)
        glabels = np.asarray(glabels).astype(np.int64)
        if top_k is not None and preds.shape[0] > top_k:
            ids = np.argsort(-scores)[:top_k]
            preds, scores, plabels = preds[ids], scores[ids], plabels[ids]

        for lab in np.unique(np.concatenate([plabels, glabels])):
            lab = int(lab)
            pm = plabels == lab
            pb, ps = preds[pm], scores[pm]
            order = np.argsort(-ps)
            pb, ps = pb[order], ps[order]
            gb = gts[glabels == lab]
            n_pos[lab] += gb.shape[0]
            score[lab].extend(ps.tolist())
            if pb.shape[0] == 0:
                continue
            if gb.shape[0] == 0:
                match[lab].extend([0] * pb.shape[0])
                continue
            iou = iou_fn(pb, gb)
            gt_idx = iou.argmax(axis=1)
            gt_idx[iou.max(axis=1) < iou_thresh] = -1
            used = np.zeros(gb.shape[0], bool)
            for gi in gt_idx:
                if gi >= 0 and not used[gi]:
                    match[lab].append(1)
                    used[gi] = True
                else:
                    match[lab].append(0)

    n_classes = max(n_pos.keys()) + 1 if n_pos else 0
    ap = np.full(n_classes, np.nan)
    recalls = np.full(n_classes, np.nan)
    for lab in n_pos:
        s = np.asarray(score[lab])
        m = np.asarray(match[lab])
        order = np.argsort(-s)
        m = m[order]
        tp = np.cumsum(m == 1).astype(np.float64)
        fp = np.cumsum(m == 0).astype(np.float64)
        prec = tp / np.maximum(fp + tp, 1e-12)
        if n_pos[lab] > 0:
            rec = tp / n_pos[lab]
            # no predictions for a class with gt: AP 0, recall undefined
            recalls[lab] = rec[-1] if rec.shape[0] > 0 else np.nan
            ap[lab] = _voc_ap(rec, prec)
    return ap, recalls
