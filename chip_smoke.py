#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. ``env``: torch / CUDA versions and the card's name and power limit.
2. ``build``: builds every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source, all started together).
3. ``kernel_nms``: kernel B1 (``nms_boxes``) against its plain PyTorch
   version on the card; keep masks must be bit-identical. Times both.
4. ``kernel_nms_iou``: kernel B2 (``nms_sweep``) against its plain version
   on rotated-IoU matrices of random overlapping OBBs; keep masks must be
   bit-identical. Times both at K = 4000.
5. ``slice_rcnn`` (main path of slice 1): NeRF-RCNN full inference through
   ``RCNNTrainer.predict_scene`` at the bench configuration (a 200x200x132
   grid, VGG-EF, 11 classes, 20 rois, NMS 0.15, 25 detections, bf16
   compute, seeded random weights). The detections must equal a re-run of
   the post-processing with the plain NMS sweep.
6. ``small_reference``: the same path in f32 on a small input, card
   against the port's CPU reference.
7. ``slice_rpn`` (main path of slice 2): rotated anchor NeRF-RPN proposal
   inference through ``RPNTrainer.predict_scene`` at the RPN's benchmark
   shape (a 200x200x130 grid padded to 224x224x160, VGG-EF, 13 anchors,
   1000 proposals per level before and 1000 after the NMS at 0.7, bf16
   compute, seeded random weights). The NMS sees K = 4000 candidates; the
   proposals must equal a re-run of the filtering with the plain sweep.
   Reports the time by stage.
8. ``small_reference_rpn``: the RPN in f32 on a small input, rotated and
   AABB, card against the port's CPU reference.
9. ``kernels``: one line ``{"kernels": [...]}`` with every kernel's
   launches on its path, error, times and bound.

Before each main path every launch count is set to 0 and it is read just
after; each path must have launched its kernel. Before the last line the
script prints the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s, for the kernels' bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per box pair in the NMS IoU test: per axis min, max, sub,
# max-with-0 (12), two products, add and subtract, divide, compare
NMS_OPS_PER_PAIR = 18


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_sorted_boxes(rng, shape, size, p_valid=0.9):
    """Score-ordered AABBs that overlap, about 10% invalid."""
    lo = rng.uniform(0, size * 0.7, (*shape, 3))
    whd = rng.uniform(1.0, size * 0.3, (*shape, 3))
    boxes = np.concatenate([lo, lo + whd], -1).astype(np.float32)
    valid = rng.uniform(size=shape) < p_valid
    return boxes, valid


def zero_launches() -> None:
    from instance_nerf_tpu_torch.kernels import nms_cuda

    nms_cuda.nms_boxes.launches = 0
    nms_cuda.nms_sweep.launches = 0


def read_launches() -> dict:
    from instance_nerf_tpu_torch.kernels import nms_cuda

    return {"nms_boxes": nms_cuda.nms_boxes.launches,
            "nms_sweep": nms_cuda.nms_sweep.launches}


def phase_env():
    import torch

    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build():
    from instance_nerf_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(["nms_sweep", "nms_sweep_iou"])
    info = {n: {"seconds": round(v["seconds"], 3),
                "ptxas": [l for l in v["ptxas"].splitlines() if "registers" in l
                          or "spill" in l]}
            for n, v in build.build_info.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "kernels": info})


def phase_kernel_nms():
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes, nms_boxes_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [("k200", (200,), 40.0, 0.9), ("k1000", (1000,), 80.0, 0.9),
             ("k4097", (4097,), 120.0, 0.9), ("k10400", (10400,), 160.0, 0.9),
             ("k1", (1,), 10.0, 1.0), ("all_invalid", (300,), 40.0, 0.0),
             ("batched_4x2000", (4, 2000), 100.0, 0.9)]
    results, inputs = [], {}
    for name, shape, size, p_valid in cases:
        boxes, valid = random_sorted_boxes(rng, shape, size, p_valid)
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(valid).to(dev)
        got = nms_boxes(b, v, 0.15)
        want = nms_boxes_plain(b, v, 0.15)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        results.append({"case": name, "shape": list(shape), "kept": int(got.sum()),
                        "mismatches": mismatches})
        if mismatches:
            raise AssertionError(f"nms kernel disagrees with the plain sweep: {results[-1]}")
        if name == "all_invalid" and bool(got.any()):
            raise AssertionError("all-invalid input kept a box")
        inputs[name] = (b, v, got)
    timing = {}
    for name in ("k200", "k10400"):
        b, v, keep = inputs[name]
        timing[name] = {
            "kernel_ms": cuda_ms(lambda: nms_boxes(b, v, 0.15), reps=200 if name == "k200" else 20),
            "plain_ms": cuda_ms(lambda: nms_boxes_plain(b, v, 0.15), reps=3, warmup=1),
            "bound_ms": nms_bound_ms(keep)[0],
        }
    emit({"phase": "kernel_nms", "cases": results, "timing": timing})
    return timing


def nms_bound_ms(keep):
    """Least time for the sweep on these inputs: the boxes (24 B) and valid
    flag (1 B) read once and the keep flag (1 B) written once per box, and
    the IoU tests this data needs (each kept box against every later box)."""
    k = keep.shape[-1]
    kept_idx = keep.reshape(-1, k).nonzero()[:, 1].double()
    pairs = float((k - 1 - kept_idx).sum())
    byte_s = keep.numel() * 26 / PEAK_BYTES_PER_S
    ops_s = pairs * NMS_OPS_PER_PAIR / PEAK_F32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, "bytes" if byte_s > ops_s else "operations"


def bench_inputs(rng, w=200, l=200, h=132, p=20):
    grid = rng.uniform(0, 1, (w, l, h, 4)).astype(np.float32)
    lo = rng.uniform(0, 100, (p, 3))
    hi = lo + rng.uniform(20, 60, (p, 3))
    rois = np.concatenate([lo, np.minimum(hi, [w, l, h])], 1).astype(np.float32)
    return grid, rois


def phase_slice_rcnn():
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes_plain
    from instance_nerf_tpu_torch.models.rcnn import postprocess_detections
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer

    cfg = RCNNConfig(resolution=200, num_classes=11, dtype="bfloat16", eval_rois=20,
                     box_nms_thresh=0.15, detections_per_img=25, seed=0)
    trainer = RCNNTrainer(cfg, device="cuda")
    trainer.init_state()
    grid_np, rois = bench_inputs(np.random.default_rng(0))
    grid = torch.from_numpy(grid_np).to("cuda")

    # the main path: counts zeroed just before, read just after
    zero_launches()
    t0 = time.perf_counter()
    det, masks = trainer.predict_scene(grid, rois)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if launches["nms_boxes"] < 1:
        raise AssertionError(f"the main path launched no NMS kernel: {launches}")

    n_det = int(det.valid.sum())
    if tuple(masks.shape) != (25, 200, 200, 132) or masks.dtype != torch.bool:
        raise AssertionError(f"masks {tuple(masks.shape)} {masks.dtype}")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores.float()).all()):
        raise AssertionError("non-finite detections")
    if n_det < 1:
        raise AssertionError("no detections")

    # the same logits and deltas post-processed with the kernel and with
    # the plain sweep must give identical detections
    feats, logits, deltas, rois_t, sizes = trainer.box_outputs(grid, rois)
    pvalid = torch.ones(rois_t.shape[:2], dtype=torch.bool, device="cuda")
    kw = dict(score_thresh=cfg.box_score_thresh, nms_thresh=cfg.box_nms_thresh,
              detections_per_img=cfg.detections_per_img)
    captured = []

    def plain_sweep(sboxes, svalid, thr):  # records the scene's NMS input
        captured.append((sboxes, svalid))
        return nms_boxes_plain(sboxes, svalid, thr)

    det_k = postprocess_detections(logits, deltas, rois_t, pvalid, sizes, **kw)
    det_p = postprocess_detections(logits, deltas, rois_t, pvalid, sizes,
                                   nms_sweep=plain_sweep, **kw)
    for f in det_k._fields:
        if not torch.equal(getattr(det_k, f), getattr(det_p, f)):
            raise AssertionError(f"kernel vs plain NMS detections differ in {f}")
    same_as_predict = all(torch.equal(getattr(det_k, f)[0], getattr(det, f))
                          for f in det._fields)
    nms_in = captured[0]
    del feats, logits, deltas

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.predict_scene(grid, rois)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times = times[2:]  # two more warm-up runs
    peak = int(torch.cuda.max_memory_allocated())

    emit({"phase": "slice_rcnn", "grid": [200, 200, 132], "backbone": "vgg_EF",
          "num_classes": 11, "rois": 20, "nms_candidates": int(nms_in[0].shape[0]),
          "dtype": "bfloat16", "launches": launches, "first_call_s": round(first_s, 3),
          "predict_scene_ms_median": float(np.median(times)),
          "predict_scene_ms_all": [round(t, 3) for t in times],
          "peak_mem_bytes": peak, "detections": n_det,
          "mask_shape": list(masks.shape), "plain_nms_identical": True,
          "same_as_predict_scene": same_as_predict})
    del trainer, grid, masks
    torch.cuda.empty_cache()
    return launches, nms_in


def phase_small_reference():
    """f32 on the card (TF32 off) against the port's CPU reference on a
    small input with the same seeded weights."""
    import torch

    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer

    cfg = RCNNConfig(resolution=48, num_classes=11, dtype="float32", seed=1)
    rng = np.random.default_rng(1)
    grid = rng.uniform(0, 1, (48, 40, 36, 4)).astype(np.float32)
    lo = rng.uniform(0, 22, (6, 3))
    rois = np.concatenate([lo, np.minimum(lo + rng.uniform(8, 22, (6, 3)), [48, 40, 36])],
                          1).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        tr = RCNNTrainer(cfg, device=device)
        tr.init_state()
        feats, logits, deltas, _, _ = tr.box_outputs(grid, rois)
        det, masks = tr.predict_scene(grid, rois)
        outs[device] = ([f.cpu() for f in feats] + [logits.cpu(), deltas.cpu()], det, masks)
    errs = []
    for a, b in zip(outs["cuda"][0], outs["cpu"][0]):
        scale = float(b.abs().max()) or 1.0
        errs.append(float((a - b).abs().max()) / scale)
    if max(errs) > 1e-4:
        raise AssertionError(f"f32 card vs CPU relative error {max(errs)} > 1e-4")
    dc, dp = outs["cuda"][1], outs["cpu"][1]
    same = {f: bool(torch.equal(getattr(dc, f).cpu(), getattr(dp, f))) for f in
            ("valid", "labels", "roi_index")}
    box_err = float((dc.boxes.cpu() - dp.boxes).abs().max())
    mask_agree = float((outs["cuda"][2].cpu() == outs["cpu"][2]).float().mean())
    emit({"phase": "small_reference", "grid": [48, 40, 36], "dtype": "float32",
          "max_rel_err_raw_outputs": max(errs), "discrete_identical": same,
          "max_abs_box_err": box_err, "mask_voxel_agreement": mask_agree})
    if not all(same.values()) or box_err > 1e-2 or mask_agree < 0.999:
        raise AssertionError("f32 card detections disagree with the CPU reference")

def random_sorted_obbs(rng, shape, size, p_valid=0.9):
    """Score-ordered OBBs (x, y, z, w, l, h, theta), about 10% invalid: a
    quarter are drawn at random, the rest are jittered copies of those, so
    many pairs overlap above the 0.7 threshold."""
    n = shape[-1]
    lead = shape[:-1]
    m = max(1, n // 4)
    base = np.concatenate([rng.uniform(0, size, (*lead, m, 3)),
                           rng.uniform(4.0, 16.0, (*lead, m, 3)),
                           rng.uniform(-np.pi, np.pi, (*lead, m, 1))], -1)
    pick = rng.integers(0, m, (*lead, n))
    boxes = np.take_along_axis(base, pick[..., None], axis=-2)
    jitter = np.concatenate([rng.normal(0, 0.5, (*lead, n, 3)),
                             np.zeros((*lead, n, 3)),
                             rng.normal(0, 0.05, (*lead, n, 1))], -1)
    boxes = boxes + jitter
    boxes[..., 3:6] *= rng.uniform(0.9, 1.1, (*lead, n, 3))
    valid = rng.uniform(size=shape) < p_valid
    return boxes.astype(np.float32), valid


def obb_iou_matrix(boxes):
    """The port's rotated IoU of score-ordered boxes against themselves:
    ``(K, K)`` or ``(B, K, K)``."""
    import torch

    from instance_nerf_tpu_torch.ops.rotated_iou import pairwise_iou_3d

    if boxes.dim() == 2:
        return pairwise_iou_3d(boxes, boxes)
    return torch.stack([pairwise_iou_3d(b, b) for b in boxes])


def sweep_bound_ms(keep):
    """Least time for the IoU sweep on these inputs: the later columns of
    every kept row read once (4 B each) and the valid and keep flags (1 B
    each per box), or one comparison per such entry, the larger."""
    k = keep.shape[-1]
    kept_idx = keep.reshape(-1, k).nonzero()[:, 1].double()
    entries = float((k - 1 - kept_idx).sum())
    byte_s = (entries * 4 + keep.numel() * 2) / PEAK_BYTES_PER_S
    ops_s = entries / PEAK_F32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, "bytes" if byte_s > ops_s else "operations"


def phase_kernel_nms_iou():
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep, nms_sweep_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cases = [("k200", (200,), 30.0, 0.9), ("k1000", (1000,), 60.0, 0.9),
             ("k4000", (4000,), 120.0, 0.9), ("k4096", (4096,), 120.0, 0.9),
             ("k4097", (4097,), 120.0, 0.9), ("k1", (1,), 10.0, 1.0),
             ("all_invalid", (300,), 30.0, 0.0), ("batched_4x1000", (4, 1000), 60.0, 0.9)]
    results, inputs = [], {}
    for name, shape, size, p_valid in cases:
        boxes, valid = random_sorted_obbs(rng, shape, size, p_valid)
        iou = obb_iou_matrix(torch.from_numpy(boxes).to(dev)).contiguous()
        v = torch.from_numpy(valid).to(dev)
        got = nms_sweep(iou, v, 0.7)
        want = nms_sweep_plain(iou, v, 0.7)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        results.append({"case": name, "shape": list(shape), "kept": int(got.sum()),
                        "valid": int(v.sum()), "mismatches": mismatches})
        if mismatches:
            raise AssertionError(f"nms_sweep kernel disagrees with the plain sweep: {results[-1]}")
        if name == "all_invalid" and bool(got.any()):
            raise AssertionError("all-invalid input kept a box")
        if name == "k1" and not bool(got.all()):
            raise AssertionError("a single valid box was not kept")
        inputs[name] = (iou, v, got)
    iou, v, keep = inputs["k4000"]
    if not 0 < int(keep.sum()) < int(v.sum()):
        raise AssertionError("K = 4000 case suppresses nothing: not a test of the sweep")
    timing = {"k4000": {
        "kernel_ms": cuda_ms(lambda: nms_sweep(iou, v, 0.7), reps=20),
        "plain_ms": cuda_ms(lambda: nms_sweep_plain(iou, v, 0.7), reps=3, warmup=1),
        "bound_ms": sweep_bound_ms(keep)[0],
    }}
    emit({"phase": "kernel_nms_iou", "cases": results, "timing": timing})
    return timing


def phase_slice_rpn():
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep_plain
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer, pad_to_32

    cfg = RPNConfig(rotated_bbox=True, dtype="bfloat16", resolution=160, seed=0)
    trainer = RPNTrainer(cfg, device="cuda")
    trainer.init_state()
    shape = (200, 200, 130)
    grid_np = np.random.default_rng(0).uniform(0, 1, (*shape, 4)).astype(np.float32)
    grid = torch.from_numpy(grid_np).to("cuda")

    # the main path: counts zeroed just before, read just after
    zero_launches()
    t0 = time.perf_counter()
    boxes, scores, lvls, feats, obj = trainer.predict_scene(grid)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if launches["nms_sweep"] < 1:
        raise AssertionError(f"the RPN path launched no nms_sweep kernel: {launches}")

    n = int(boxes.shape[0])
    if boxes.dim() != 2 or boxes.shape[1] != 7 or not 1 <= n <= cfg.post_nms_top_n:
        raise AssertionError(f"proposals {tuple(boxes.shape)}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores.float()).all()):
        raise AssertionError("non-finite proposals")

    # the same objectness and deltas filtered with the kernel and with the
    # plain sweep must give identical proposals
    obj, reg, anchors, feats, sizes, pm = trainer.head_outputs(grid)
    captured = []

    def plain_sweep(iou, svalid, thr):  # records the scene's NMS input
        captured.append((iou, svalid))
        return nms_sweep_plain(iou, svalid, thr)

    props_k = trainer.filter(obj, reg, anchors, sizes, pm)
    props_p = trainer.filter(obj, reg, anchors, sizes, pm, nms_sweep=plain_sweep)
    for f in props_k._fields:
        if not torch.equal(getattr(props_k, f), getattr(props_p, f)):
            raise AssertionError(f"kernel vs plain NMS proposals differ in {f}")
    v = props_k.valid[0]
    same_as_predict = (torch.equal(props_k.boxes[0][v], boxes)
                       and torch.equal(props_k.level_ids[0][v], lvls))
    iou, svalid = captured[0]
    k = int(iou.shape[0])
    if k != 4 * cfg.pre_nms_top_n:
        raise AssertionError(f"NMS input has K = {k}, expected {4 * cfg.pre_nms_top_n}")
    del feats, obj, reg, props_k, props_p

    bench = trainer.benchmark(reps=10, shape=shape)
    prof = trainer.profile(reps=5, shape=shape)
    emit({"phase": "slice_rpn", "grid": list(shape), "padded": [pad_to_32(d) for d in shape],
          "backbone": "vgg_EF", "anchors_per_location": 13, "rotated_bbox": True,
          "pre_nms_top_n": cfg.pre_nms_top_n, "post_nms_top_n": cfg.post_nms_top_n,
          "nms_thresh": cfg.nms_thresh, "nms_candidates": k, "dtype": "bfloat16",
          "launches": launches, "first_call_s": round(first_s, 3),
          "proposals": n, "levels": torch.bincount(lvls, minlength=4).tolist(),
          "plain_nms_identical": True, "same_as_predict_scene": same_as_predict,
          "predict_scene": bench, "profile": prof})
    del trainer, grid
    torch.cuda.empty_cache()
    return launches, (iou, svalid)


def phase_small_reference_rpn():
    """f32 on the card (TF32 off) against the port's CPU reference on a
    small input with the same seeded weights, rotated and AABB. 128
    proposals per level before the NMS and 100 after keep the CPU's dense
    rotated IoU small. The seeded head draws its objectness kernel from
    normal(0.01), whose sigmoid scores sit an ulp or two apart; both runs
    scale that kernel by 5, which puts the proposals' scores at least 2e-6
    (about 35 ulps) apart, so their order is decided by more than
    rounding."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep_plain
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer

    grid = np.random.default_rng(2).uniform(0, 1, (48, 40, 36, 4)).astype(np.float32)
    report = {"phase": "small_reference_rpn", "grid": [48, 40, 36], "dtype": "float32"}
    failed = []
    for rotated in (True, False):
        cfg = RPNConfig(rotated_bbox=rotated, dtype="float32", resolution=160, seed=3,
                        pre_nms_top_n=128, post_nms_top_n=100)
        outs = {}
        for device in ("cuda", "cpu"):
            tr = RPNTrainer(cfg, device=device)
            tr.init_state()
            with torch.no_grad():
                tr.model.rpn_head.cls_logits.weight.mul_(5.0)
            obj, reg, anchors, feats, sizes, pm = tr.head_outputs(grid)
            captured = []

            def sweep(iou, svalid, thr, _cap=captured):  # records the NMS input
                _cap.append((iou, svalid))
                return nms_sweep_plain(iou, svalid, thr)

            props = tr.filter(obj, reg, anchors, sizes, pm,
                              nms_sweep=sweep if rotated and device == "cpu" else None)
            outs[device] = (obj.cpu(), reg.cpu(), [p.cpu() for p in props], captured)
        (oc, rc, pc, _), (op, rp, pp, cap) = outs["cuda"], outs["cpu"]
        raw_err = max(float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
                      for a, b in ((oc, op), (rc, rp)))
        same = {f: bool(torch.equal(a, b)) for f, a, b in
                zip(("valid", "level_ids"), (pc[3], pc[2]), (pp[3], pp[2]))}
        box_err = float((pc[0] - pp[0]).abs().max())
        sc = torch.sort(pp[1][0][pp[3][0]].float()).values
        score_gap = float((sc[1:] - sc[:-1]).min()) if sc.numel() > 1 else 1.0
        mode = "rotated" if rotated else "aabb"
        report[mode] = {"max_rel_err_raw_outputs": raw_err, "discrete_identical": same,
                        "max_abs_box_err": box_err, "proposals": int(pp[3].sum()),
                        "min_score_gap": score_gap}
        if rotated:
            # the entries the sweep decides on: valid rows against later
            # valid columns
            iou, svalid = cap[0]
            pairs = torch.triu(svalid[:, None] & svalid[None, :], diagonal=1)
            iou_margin = float((iou[pairs] - 0.7).abs().min())
            report[mode]["iou_margin_to_0.7"] = iou_margin
            if iou_margin < 1e-5:
                failed.append(f"{mode}: an OBB IoU lies within 1e-5 of 0.7")
        if raw_err > 1e-4:
            failed.append(f"{mode}: raw outputs differ by {raw_err} > 1e-4 relative")
        if not all(same.values()) or box_err > 1e-3:
            failed.append(f"{mode}: f32 card proposals disagree with the CPU reference")
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import instance_nerf_tpu_torch  # noqa: F401  (absent: ImportError, exit 1)

    smi = phase_env()
    phase_build()
    timing = phase_kernel_nms()
    timing_iou = phase_kernel_nms_iou()
    launches_rcnn, (sboxes, svalid) = phase_slice_rcnn()

    from instance_nerf_tpu_torch.kernels.nms_cuda import (
        nms_boxes,
        nms_boxes_plain,
        nms_sweep,
        nms_sweep_plain,
    )

    keep_k = nms_boxes(sboxes, svalid, 0.15)
    keep_p = nms_boxes_plain(sboxes, svalid, 0.15)
    err = float((keep_k.int() - keep_p.int()).abs().max())
    if err:
        raise AssertionError("kernel disagrees on the scene's own NMS input")
    k_ms = cuda_ms(lambda: nms_boxes(sboxes, svalid, 0.15), reps=200)
    bound_ms, bound_by = nms_bound_ms(keep_k)
    p_ms = cuda_ms(lambda: nms_boxes_plain(sboxes, svalid, 0.15), reps=5, warmup=1)
    phase_small_reference()

    launches_rpn, (iou, ivalid) = phase_slice_rpn()
    keep_k = nms_sweep(iou, ivalid, 0.7)
    keep_p = nms_sweep_plain(iou, ivalid, 0.7)
    err_iou = float((keep_k.int() - keep_p.int()).abs().max())
    if err_iou:
        raise AssertionError("nms_sweep kernel disagrees on the scene's own NMS input")
    ki_ms = cuda_ms(lambda: nms_sweep(iou, ivalid, 0.7), reps=20)
    bound_iou_ms, bound_iou_by = sweep_bound_ms(keep_k)
    pi_ms = cuda_ms(lambda: nms_sweep_plain(iou, ivalid, 0.7), reps=3, warmup=1)
    kept = int(keep_k.sum())
    phase_small_reference_rpn()

    emit({"kernels": [{
        "name": "nms_boxes", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "instance_nerf_tpu/kernels/nms_pallas.py:113",
        "launches": launches_rcnn["nms_boxes"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "k": int(sboxes.shape[0]),
        "k10400": timing["k10400"],
    }, {
        "name": "nms_sweep", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/nms_sweep_iou.cu",
        "replaces": "instance_nerf_tpu/kernels/nms_pallas.py:157",
        "launches": launches_rpn["nms_sweep"], "max_abs_err": err_iou,
        "ms": ki_ms, "plain_ms": pi_ms, "bound_ms": bound_iou_ms,
        "bound_by": bound_iou_by, "library_ms": None,
        "k": int(iou.shape[0]), "kept": kept,
        "random_k4000": timing_iou["k4000"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
