#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. ``env``: torch / CUDA versions and the card's name and power limit.
2. ``build``: builds every CUDA kernel of the port from ``csrc/`` (one
   ``nvcc`` per source, all started together).
3. ``kernel_nms``: kernel B1 (``nms_boxes``) against its plain PyTorch
   version on the card; keep masks must be bit-identical: K from 1 to the
   wrappers' limit of 32768 (63, 64, 65, 127, 128, 129, 257 among them),
   boxes whose IoU is exactly the threshold and one ulp above it, one box
   repeated, batched problems with different valid masks; a K above the
   limit must raise. Times both (``device_ms`` of both phases, each phase's
   beside it) at K = 200 and 10400.
4. ``kernel_nms_iou``: kernel B2 (``nms_sweep``) against its plain version
   on rotated-IoU matrices of random overlapping OBBs and on the same edge
   cases (entries exactly at the threshold and one ulp above, all kept,
   one row suppressing all); keep masks must be bit-identical. Times both
   at K = 4000.
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
8a. ``slice_fcos`` (main path of slice 4): FCOS proposal inference through
   ``FCOSTrainer.predict_scene`` at the JAX trainer's defaults (VGG-EF, 4
   tower convs of 256 channels, strides 4..32, 2500 candidates a level
   and 2500 after the NMS at 0.3, bf16, seeded random weights) on a 160^3
   grid, AABB (B1, K = 10,000 of which 6,125 valid) then rotated (the
   rotated IoU of the 6,125 valid candidates, swept by B2). Each must
   launch its kernel once and equal a re-run of the post-processing with
   the plain sweep; reports ``benchmark``, ``profile`` and each kernel's
   times on the scene's own NMS input beside its plain version and bound.
8b. ``small_reference_fcos``: FCOS in f32 on a 64^3 grid, both box modes,
   card against the port's CPU reference.
8b1. ``slice_backbones`` (main path of slice 5b): the detectors with the
   Swin and ResNet backbones, full width, bf16, seeded random weights:
   FCOS with ``swin_s`` at 160^3, AABB (B1, K = 10,000) and rotated (B2);
   the rotated anchor RPN with ``resnet`` at 200x200x130 padded to
   224x224x160 (B2, K = 4000); the RCNN with ``resnet`` at 200x200x132 (20
   rois, B1). Each run's kernel must launch, its outputs equal a re-run
   with the plain sweep; reports ``predict_scene`` ms (median of 10 warmed
   runs), stage spans, peak bytes, busy share, top kernels and the device
   time of the window attention and of the first conv (patch embed, stem).
8b2. ``small_reference_backbones``: a swin_t-shaped Swin and the ResNet-FPN
   at reduced depth and ``VGG_FPN(conv_at_start=True)``, f32 card against
   CPU on every pyramid level (1e-4 of the level's max); one FCOS train
   step with each of the first two in f64 (losses and gradients 1e-4); OBB
   ``postprocess_detections(box_dim=8)`` on the card through B2 against the
   CPU (keep set, labels, roi indices exact, OBBs 1e-5 of their max).
8c. ``eval``: the eval modes through the CLIs on a 4-scene dataset
   written by the port's ``write_dataset``: ``run_fcos`` (both box modes),
   ``run_rpn`` exporting proposals, level features and voxel scores, and
   ``run_rcnn`` on those proposals; metrics with the JAX trainers' keys,
   finite, and files in the JAX package's layout.
8d. ``slice_train`` (main path of slice 5a): detector training at the JAX
   trainers' defaults, full width, batch 4, bf16, seeded random weights:
   FCOS AABB and rotated at 160^3, the rotated anchor RPN at 200x200x130
   padded to 224x224x160, the RCNN at 160^3; each trainer's
   ``benchmark_train_step`` (18 timed steps, CUDA events; scenes/s, peak
   bytes) and ``profile_train`` (spans forward, loss, backward, optimizer;
   busy share; top kernels). Every loss finite, ``total`` after 20 steps on
   the fixed batch below step 0.
8e. ``small_reference_train``: one step of each trainer (VGG-AF, the
   cells' VGG-EF cut in depth) on the card against the port's CPU run from
   the same weights, inputs and sampling draws, in f64 (losses 1e-4, every
   gradient 1e-4 of its max), and one f32 FCOS step's losses (1e-4).
8f. ``train_loop``: ``--mode train`` of the three CLIs on a 4-scene
   dataset, 2 epochs with an eval each (B1 must launch in the AABB FCOS and
   RCNN evals, B2 in the rotated FCOS and RPN ones), the RCNN grafting the
   FCOS run's backbone, one checkpoint and ``best/`` kept, then
   ``--resume`` starting at the saved step; then FCOS and the RCNN with
   ``--device_data --steps_per_call 4`` (4 steps in 2 dispatches).
9. ``slice_field`` (main path of slice 3): instance-field training through
   ``InstanceFieldTrainer.train`` at the JAX CLI's default model (hash
   encoding, 16 levels, T = 2^19, F = 2, resolutions 16..1024, width 64,
   33 instances, 4096 rays x 128 candidates of which 32 are queried,
   occupancy 128^3 refreshed every 16 steps, f32) with ``pallas_grad``
   (the table gradient is kernel B3), seeded random weights and a synthetic
   scene: 64 rgb steps (B3 launched on every one), one step's table
   gradient against the plain scatter, 32 instance steps (nothing outside
   ``inst_*`` may move), a rendered view whose PSNR must have risen, then
   ``benchmark_train`` of both stages and the step's stage profile.
10. ``slice_field_fast``: the same, shorter, for the JAX package's benchmark
   field (brick encoding, 3 levels x 4 features, T = 2^15, coarse occupancy
   32^3, bf16 MLPs), with the bf16 run against an f32 run on the card.
11. ``kernel_scatter``: kernel B3 against its plain version on random,
   collision-heavy, odd-N, clamping, replica and multi-level inputs; on
   adversarial ones: indices past T on every level, all updates on one
   row, W in {2, 3, 4, 16, 32}, the hash and brick layouts with stray
   indices, replicas; at the two shapes of the JAX package's scatter
   probes (B6) and on the index streams of the two slices' own steps (all
   levels, and levels 0 and 15 of the main config). Times the kernel, the
   plain version and ``index_add_``: ``ms`` by CUDA events,
   ``device_ms`` the kernel's own device time from ``torch.profiler``, and
   ``call_device_ms`` / ``library_device_ms`` all the device work of the
   wrapper's and the library's call, each table's zeroing included.
12. ``kernel_coarse_occ``: kernel B5 on the fast config's own sample points,
   equal to its plain version and to the renderer's
   ``coarse_occupancy_mxu``, and exact at N = 1, N = 1001, on ``cells``
   sliced off its 16-byte boundary and on cells outside the grid; times
   (``ms``, ``device_ms``, ``call_device_ms``) beside advanced indexing.
13. ``small_reference_field``: a small f32 field, card against the port's
   CPU run from the same weights, rays and draws: losses, gradients and
   params over rgb -> instance -> rgb.
13a. ``field_cli`` (main path of slice 6): ``cli/run_instance_field`` on a
   synthetic scene written to disk, at the JAX CLI's defaults with
   ``--pallas_grad``: ``train`` (64 rgb steps, B3 launched on each),
   ``train_instance`` from the scene's masks (only ``inst_*`` moves),
   ``render`` (the PSNR of view 0 must rise over the untrained field's),
   ``extract_features`` at 160^3 (shape and finite values), ``benchmark``;
   then ``--preset tpu_fast --k_buckets auto`` (64 rgb steps, B3 launched
   on each; its measured ladder sums to 1, no K above ``n_samples``), a
   checkpoint restored bit-identical, and one tpu_fast rgb step on that
   ladder whose B3 launch is held against the plain scatter (1e-5 of its
   largest entry) and timed on its own index stream beside ``index_add_``.
13b. ``slice_fleet`` (main path of slice 6's fleets): a B = 32 fleet of
   synthetic scenes (14 views at 64^2) through ``cli/run_fleet`` at its
   defaults with ``--pallas_grad``: 64 rgb steps with ONE B3 launch a step
   for all scenes (a background save midway), one step's fleet table
   gradient against the plain scatter (1e-5 of its largest entry), 32
   instance steps (only ``inst_*`` moves, in every scene), save / restore
   bit-identical (params, Adam moments and count, occupancy grids; one
   save in the background while training goes on), ``--mode benchmark``
   (aggregate rays/s, step ms, peak bytes, busy share, top kernels); B3
   timed on the fleet step's own index stream beside ``index_add_``.
13c. ``small_reference_fleet``: an f32 fleet of 3 scenes, card against the
   port's CPU run from the same weights, rays and draws, rgb -> instance
   -> rgb: losses 1e-5, every gradient 1e-5 of its max (the dense grid's,
   rounded to bf16 by design, to one bf16 ulp), params 1e-5.
13d. ``project_masks``: a 96^3 voxel instance grid and alpha grid projected
   into 8 views at 128^2 on the card and on the CPU: the files equal.
13e. ``slice_dist`` (main path of slice 7a): training over every visible
   card, one rank a card under ``torch.distributed.run`` (NCCL); the script
   starts itself there (``--dist-child slice_dist``). FCOS AABB at the JAX
   trainer's defaults (global batch 4, 160^3, bf16, VGG-EF): after 3 steps
   in deterministic mode the launched params must equal this process's
   one-process trainer's bit for bit with one rank; 18 timed steps (ms,
   global scenes/s, peak bytes), the ``allreduce`` span and the gradient
   bytes it moves. The B = 32 fleet of ``slice_fleet`` at run_fleet's
   defaults with ``--pallas_grad``, split over the ranks: B3 once per rank
   per step, aggregate rays/s, saved on the ranks and restored
   bit-identical here in one process and on the ranks. ``run_fcos --mode train`` (2 epochs, B1 in rank
   0's evals, one checkpoint and ``best/``), its ``--resume`` to a third
   epoch, ``run_rpn --rotated_bbox --mode train`` (B2 in rank 0's evals).
13f. ``small_reference_dist``: 2 ranks on the card over gloo against this
   process's one-process card run on the same global inputs: one step of
   FCOS AABB, the rotated RPN and the RCNN (f64 gradients 1e-5 of their
   max, f32 losses 1e-5; f32 gradients reported), the ray-sharded field
   step (B3 once a rank) and a B = 4 fleet step (f32, 1e-5).
13g. ``pipeline`` (main path of slice 7c): the five-stage pipeline
   through ``python -m instance_nerf_tpu_torch.pipeline``'s ``main`` at the
   JAX example's defaults (a 10-view 64^2 scene, 2 held out; the brick
   field's 1500 rgb steps, the RGBσ grid at 64^3; 200 RCNN steps, VGG-AF, 5
   classes; inference with B1 over the per-class candidates of 16 rois;
   projection and match_seg; 500 instance steps, the held-out views'
   mIoU / PQ): every stage's keys finite, the files in the example's
   layout, B1 launched, its detections equal to a re-run of the
   post-processing with the plain sweep; the per-stage walls and peak
   bytes.
13h. ``slice_legacy``: the legacy classification path at full width: the
   rotated RPN's ``predict_scene`` at 224x224x160 (B2, K = 4000) gives the
   FPN levels (256 channels) and up to 1000 proposals, mapped to levels by
   FPN eq. (1); ``LegacyProposalScorer`` (the legacy pool, rotated,
   pooling, enlarge 0.2, ``max_grid`` 32, then the classifier 256, 256,
   512, 2 classes, bf16) at output 1^3 and 5^3: median ms of 10 warmed
   runs, peak bytes, the chunk size; a small f32 case card against CPU
   (pooled features and scores 1e-5).
13i. ``utils``: the FCOS AABB train step at batch 4 and 160^3 (bf16):
   FLOPs a step, achieved TFLOP/s and MFU against the H100's bf16 peak
   (``benchmark_train_step``), ``memory_stats`` of one step within 5% of
   the benchmark's peak; ``chained_latency_ms`` of the RCNN's
   ``predict_scene`` at 200x200x132 beside ``benchmark``'s median; a
   ``torch.profiler`` trace written with its kernels.
14. ``kernels``: one line ``{"kernels": [...]}`` with every kernel's
   launches on its path, error, times (``ms``, ``device_ms``) and bound;
   B1's and B2's entries also hold the FCOS path's (``launches_fcos``,
   ``k_fcos``, ``fcos_ms``, ``fcos_device_ms``, ``fcos_bound_ms``, ...)
   and their launches in the train loops' evals (``launches_train_loop``),
   B1's in the pipeline's stage 3 (``launches_pipeline``, ``k_pipeline``),
   B2's on the legacy path (``launches_legacy``)
   and on the Swin and ResNet paths (``launches_backbones``), and in rank
   0's evals under the launcher (``launches_dist_train_loop``);
   B3's its launches on the field CLI's and the fleet's paths
   (``launches_field_cli``, ``launches_field_cli_fast``,
   ``launches_fleet``), in the fleet split over the ranks
   (``launches_fleet_dist``) and in the ray-sharded field step
   (``launches_field_sharded``, one a rank), and the cases of the fleet
   step and the tpu_fast CLI step (``fleet``, ``field_cli_fast``).

Before each main path every launch count is set to 0 and it is read just
after; each path must have launched its kernel. Before the last line the
script prints the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s, for the kernels' bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per box pair in the NMS IoU test: per axis min, max, sub,
# max-with-0 (12), two products, add and subtract, divide, compare
NMS_OPS_PER_PAIR = 18
# the synthetic scene of the field slices: 16 orbit views at 128 x 128
FIELD_SCENE = dict(n_views=16, hw=(128, 128), n_blobs=3)


def emit(obj) -> None:
    """One JSON line; a phase's line carries the monotonic clock at its end
    (``clock_s``), so that consecutive lines give each phase's seconds."""
    if "phase" in obj:
        obj = {**obj, "clock_s": time.monotonic()}
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


def device_ms(fn, reps: int, marker: str, match: str | None = None) -> dict:
    """Device time per call of ``fn`` from ``torch.profiler`` (CUDA
    activity): the summed durations of the device activities (kernels,
    memsets) whose name contains ``match``, or of all of them, over the
    calls the trace holds (``ms``).

    A trace around a run of calls misses the first call's activities, and
    they turn up in the next trace of the process. So only activities that
    start inside this trace's window of calls count (the window's own
    annotation on the device timeline not among them), and the time is
    divided by the calls seen, each counted by its one launch of the kernel
    named ``marker``, not by the calls made. A trace that holds fewer than
    all of them is taken again, up to three times, and the fullest is kept.
    Where it still holds fewer, only a reading of the marker's own
    activities (``match == marker``) counts each call it sums; any other
    may sum activities of a call whose marker was lost, so ``ms`` is None.
    ``per_call`` is the activities per call counted (what the time sums),
    ``calls_seen`` the calls counted of ``reps``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    best = (-1, [])
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("device_ms_calls"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events if e.name == "device_ms_calls"),
                 default=float("-inf"))
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.time_range.start >= t0 and e.name != "device_ms_calls"]
        calls = sum(marker in e.name for e in device)
        if calls > best[0]:
            best = (calls, device)
        if calls >= reps:
            break
    calls, device = best
    us = [e.time_range.elapsed_us() for e in device if match is None or match in e.name]
    counted = calls >= reps or match == marker
    return {"ms": sum(us) / calls / 1e3 if calls and us and counted else None,
            "per_call": len(us) / calls if calls else None, "calls_seen": calls}


def profiled(out, key, fn, reps, marker, match=None):
    """``device_ms`` of ``fn`` into ``out[key]``, with its activities per
    call and calls counted under ``out[key + "_activities"]`` and
    ``out[key + "_calls_seen"]``."""
    d = device_ms(fn, reps, marker, match)
    out[key] = d["ms"]
    out[key + "_activities"], out[key + "_calls_seen"] = d["per_call"], d["calls_seen"]


def random_sorted_boxes(rng, shape, size, p_valid=0.9):
    """Score-ordered AABBs that overlap, about 10% invalid."""
    lo = rng.uniform(0, size * 0.7, (*shape, 3))
    whd = rng.uniform(1.0, size * 0.3, (*shape, 3))
    boxes = np.concatenate([lo, lo + whd], -1).astype(np.float32)
    valid = rng.uniform(size=shape) < p_valid
    return boxes, valid


def _counted():
    from instance_nerf_tpu_torch.kernels import coarse_occ_cuda, nms_cuda, scatter_cuda

    return {"nms_boxes": nms_cuda.nms_boxes, "nms_sweep": nms_cuda.nms_sweep,
            "scatter_add": scatter_cuda.scatter_add,
            "coarse_occ_lookup": coarse_occ_cuda.coarse_occ_lookup}


def zero_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


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
    build.build_all(build.SOURCES)
    info = {n: {"seconds": round(v["seconds"], 3),
                "ptxas": [l for l in v["ptxas"].splitlines() if "registers" in l
                          or "spill" in l]}
            for n, v in build.build_info.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "kernels": info})


def check_sweep(results, name, kernel, plain, data, valid, thr):
    """One NMS kernel case: the kernel's keep mask must equal the plain
    sweep's bit for bit; the plain sweep's one run is timed (``plain_ms``,
    CUDA events). Returns the kernel's keep."""
    import torch

    got = kernel(data, valid, thr)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(data, valid, thr)
    end.record()
    end.synchronize()
    mismatches = int((got != want).sum())
    results.append({"case": name, "shape": list(valid.shape), "thr": thr,
                    "kept": int(got.sum()), "valid": int(valid.sum()),
                    "mismatches": mismatches, "plain_ms": start.elapsed_time(end)})
    if mismatches:
        raise AssertionError(f"{kernel.__name__} kernel disagrees with the plain sweep: "
                             f"{results[-1]}")
    return got


def nms_times(out, fn, reps, dev_reps):
    """Into ``out``: ``kernel_ms`` of an NMS wrapper call by CUDA events, and
    from the profiler ``mask_device_ms`` and ``scan_device_ms`` (each phase's
    kernel counted by its own launches), ``device_ms`` their sum, and
    ``call_device_ms`` (all the call's device work, the summary's zeroing
    included; None where the trace lost a call)."""
    out["kernel_ms"] = cuda_ms(fn, reps=reps)
    for key, marker, match in (("mask_device_ms", "mask_kernel", "mask_kernel"),
                               ("scan_device_ms", "nms_sweep_scan", "nms_sweep_scan"),
                               ("call_device_ms", "nms_sweep_scan", None)):
        profiled(out, key, fn, dev_reps, marker, match)
    phases = (out["mask_device_ms"], out["scan_device_ms"])
    out["device_ms"] = None if None in phases else sum(phases)
    return out


def check_limit(kernel, matrix):
    """A K above ``MAX_K`` must raise ValueError before any launch: boxes
    ``(K, 6)``, or with ``matrix`` an IoU matrix ``(K, K)``."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import MAX_K

    k = MAX_K + 1
    data = torch.empty((k, k if matrix else 6), device="cuda")
    before = kernel.launches
    try:
        kernel(data, torch.ones(k, dtype=torch.bool, device="cuda"), 0.5)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{kernel.__name__} took K = {k} > MAX_K = {MAX_K}")
    if kernel.launches != before:
        raise AssertionError(f"{kernel.__name__} counted a launch above MAX_K")
    return {"k": k, "raised": "ValueError"}


def tie_boxes(rng, k):
    """AABBs with integer corners in [0, 4): many pairs' IoU is exactly 1/2."""
    lo = rng.integers(0, 3, (k, 3))
    return np.concatenate([lo, lo + rng.integers(1, 3, (k, 3))], 1).astype(np.float32)


def phase_kernel_nms():
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes, nms_boxes_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # k20000 and k32768 exceed the scan's shared-memory prefetch (K <= 14400)
    # and read the mask through L2; k32768 is the wrappers' limit
    cases = [("k200", (200,), 40.0, 0.9), ("k1000", (1000,), 80.0, 0.9),
             ("k4097", (4097,), 120.0, 0.9), ("k10400", (10400,), 160.0, 0.9),
             ("k20000", (20000,), 200.0, 0.9), ("k32768", (32768,), 240.0, 0.9),
             ("k1", (1,), 10.0, 1.0), ("all_invalid", (300,), 40.0, 0.0),
             ("batched_4x2000", (4, 2000), 100.0, 0.9)]
    cases += [(f"k{k}", (k,), 20.0, 0.9) for k in (63, 64, 65, 127, 128, 129, 257)]
    results, inputs = [], {}
    for name, shape, size, p_valid in cases:
        boxes, valid = random_sorted_boxes(rng, shape, size, p_valid)
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(valid).to(dev)
        got = check_sweep(results, name, nms_boxes, nms_boxes_plain, b, v, 0.15)
        if name == "all_invalid" and bool(got.any()):
            raise AssertionError("all-invalid input kept a box")
        inputs[name] = (b, v, got)
    # IoUs exactly on the threshold (kept) and one ulp above it (suppressed)
    ties = torch.from_numpy(tie_boxes(rng, 300)).to(dev)
    tv = torch.from_numpy(rng.uniform(size=300) < 0.9).to(dev)
    half = np.float32(0.5)
    kept = {}
    for name, thr in (("iou_at_thr", half), ("iou_one_ulp_above_thr",
                                             np.nextafter(half, np.float32(0)))):
        kept[name] = int(check_sweep(results, name, nms_boxes, nms_boxes_plain, ties, tv,
                                     float(thr)).sum())
    if not kept["iou_one_ulp_above_thr"] < kept["iou_at_thr"]:
        raise AssertionError(f"the tie case does not test the tie: {kept}")
    same = torch.from_numpy(np.repeat(tie_boxes(rng, 1), 300, 0)).to(dev)
    if int(check_sweep(results, "one_suppresses_all", nms_boxes, nms_boxes_plain, same,
                       torch.ones(300, dtype=torch.bool, device=dev), 0.15).sum()) != 1:
        raise AssertionError("one box repeated 300 times kept more than one")
    boxes, _ = random_sorted_boxes(rng, (4, 1000), 100.0)
    valid = np.stack([rng.uniform(size=1000) < p for p in (1.0, 0.6, 0.2, 0.0)])
    check_sweep(results, "batched_valid_masks", nms_boxes, nms_boxes_plain,
                torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev), 0.15)
    limit = check_limit(nms_boxes, matrix=False)
    timing = {}
    for name in ("k200", "k10400"):
        b, v, keep = inputs[name]
        timing[name] = nms_times({}, lambda: nms_boxes(b, v, 0.15),
                                 reps=200 if name == "k200" else 20, dev_reps=20)
        # at K = 10400 the check's one run (seconds); K = 200 warmed, since the
        # check ran the process's first plain sweep there
        timing[name]["plain_ms"] = (
            next(r["plain_ms"] for r in results if r["case"] == name) if name == "k10400"
            else cuda_ms(lambda: nms_boxes_plain(b, v, 0.15), reps=3, warmup=1))
        timing[name]["bound_ms"] = nms_bound_ms(keep, v)[0]
    emit({"phase": "kernel_nms", "cases": results, "limit": limit, "timing": timing})
    return timing


def later_valid_pairs(keep, valid):
    """The pairs a greedy sweep must test on these inputs: each kept box
    against every later valid box (an invalid box never suppresses, so its
    tests are not needed)."""
    k = keep.shape[-1]
    v = valid.reshape(-1, k).long()
    later = v.sum(1, keepdim=True) - v.cumsum(1)  # valid boxes after each row
    return float((later * keep.reshape(-1, k)).sum())


def nms_bound_ms(keep, valid):
    """Least time for the sweep on these inputs: the valid flag (1 B) read
    and the keep flag (1 B) written once per box, the valid boxes (24 B)
    read once, and the IoU tests this data needs (``later_valid_pairs``)."""
    byte_s = (keep.numel() * 2 + int(valid.sum()) * 24) / PEAK_BYTES_PER_S
    ops_s = later_valid_pairs(keep, valid) * NMS_OPS_PER_PAIR / PEAK_F32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, "bytes" if byte_s > ops_s else "operations"


def bench_inputs(rng, w=200, l=200, h=132, p=20):
    grid = rng.uniform(0, 1, (w, l, h, 4)).astype(np.float32)
    lo = rng.uniform(0, 100, (p, 3))
    hi = lo + rng.uniform(20, 60, (p, 3))
    rois = np.concatenate([lo, np.minimum(hi, [w, l, h])], 1).astype(np.float32)
    return grid, rois


def phase_slice_rcnn(backbone="vgg_EF", phase="slice_rcnn"):
    """NeRF-RCNN full inference at the bench configuration; with another
    ``backbone`` (a line of ``phase``) also its stage profile and the
    device time of its first conv."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes_plain
    from instance_nerf_tpu_torch.models.rcnn import postprocess_detections
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer

    cfg = RCNNConfig(resolution=200, num_classes=11, dtype="bfloat16", eval_rois=20,
                     box_nms_thresh=0.15, detections_per_img=25, seed=0,
                     backbone_type=backbone)
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
    if launches["nms_boxes"] != 1:  # one image: one NMS call
        raise AssertionError(f"the main path's one NMS call launched B1 "
                             f"{launches['nms_boxes']} times: {launches}")

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
    if not same_as_predict:
        raise AssertionError("the re-run post-processing differs from predict_scene's")
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

    line = {"phase": phase, "grid": [200, 200, 132], "backbone": backbone,
            "num_classes": 11, "rois": 20, "nms_candidates": int(nms_in[0].shape[0]),
            "dtype": "bfloat16", "launches": launches, "first_call_s": round(first_s, 3),
            "predict_scene_ms_median": float(np.median(times)),
            "predict_scene_ms_all": [round(t, 3) for t in times],
            "peak_mem_bytes": peak, "detections": n_det,
            "mask_shape": list(masks.shape), "plain_nms_identical": True,
            "same_as_predict_scene": same_as_predict}
    if backbone != "vgg_EF":
        line["run"] = f"rcnn_{backbone}"
        line["profile"] = trainer.profile(reps=5, shape=(200, 200, 132), top=16)
        line["module_ms"] = module_times(trainer.model.backbone,
                                         lambda: trainer.predict_scene(grid, rois))
    emit(line)
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


def sweep_bound_ms(keep, valid):
    """Least time for the IoU sweep on these inputs: the entries of every
    kept row at the later valid columns read once (4 B each) and the valid
    and keep flags (1 B each per box), or one comparison per such entry,
    the larger."""
    entries = later_valid_pairs(keep, valid)
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
    cases += [(f"k{k}", (k,), 15.0, 0.9) for k in (63, 64, 65, 127, 128, 129, 257)]
    results, inputs = [], {}
    for name, shape, size, p_valid in cases:
        boxes, valid = random_sorted_obbs(rng, shape, size, p_valid)
        iou = obb_iou_matrix(torch.from_numpy(boxes).to(dev)).contiguous()
        v = torch.from_numpy(valid).to(dev)
        got = check_sweep(results, name, nms_sweep, nms_sweep_plain, iou, v, 0.7)
        if name == "all_invalid" and bool(got.any()):
            raise AssertionError("all-invalid input kept a box")
        if name == "k1" and not bool(got.all()):
            raise AssertionError("a single valid box was not kept")
        inputs[name] = (iou, v, got)
    # entries exactly at the threshold (no suppression) and one ulp above it
    thr = np.float32(0.7)
    above = np.nextafter(thr, np.float32(1))
    values = np.asarray([thr, above, np.nextafter(thr, np.float32(0)), 0.0], np.float32)
    m = torch.from_numpy(rng.choice(values, (1000, 1000), p=[0.3, 0.03, 0.3, 0.37])).to(dev)
    v = torch.from_numpy(rng.uniform(size=1000) < 0.9).to(dev)
    got = check_sweep(results, "at_and_ulp_above_thr", nms_sweep, nms_sweep_plain, m, v,
                      float(thr))
    if not 0 < int(got.sum()) < int(v.sum()):
        raise AssertionError("the tie case suppresses nothing or everything")
    low = torch.from_numpy(rng.uniform(0, 0.7, (1000, 1000)).astype(np.float32)).to(dev)
    ones = torch.ones(1000, dtype=torch.bool, device=dev)
    if not bool(check_sweep(results, "all_kept", nms_sweep, nms_sweep_plain, low, ones,
                            0.7).all()):
        raise AssertionError("no IoU above the threshold, yet a box was suppressed")
    low[0] = 1.0
    if int(check_sweep(results, "one_suppresses_all", nms_sweep, nms_sweep_plain, low, ones,
                       0.7).sum()) != 1:
        raise AssertionError("row 0 above the threshold everywhere, yet more than one kept")
    boxes, _ = random_sorted_obbs(rng, (4, 1000), 60.0)
    valid = np.stack([rng.uniform(size=1000) < p for p in (1.0, 0.6, 0.2, 0.0)])
    check_sweep(results, "batched_valid_masks", nms_sweep, nms_sweep_plain,
                obb_iou_matrix(torch.from_numpy(boxes).to(dev)).contiguous(),
                torch.from_numpy(valid).to(dev), 0.7)
    del low, m
    limit = check_limit(nms_sweep, matrix=True)
    iou, v, keep = inputs["k4000"]
    if not 0 < int(keep.sum()) < int(v.sum()):
        raise AssertionError("K = 4000 case suppresses nothing: not a test of the sweep")
    timing = {"k4000": nms_times({}, lambda: nms_sweep(iou, v, 0.7), reps=20, dev_reps=20)}
    timing["k4000"]["plain_ms"] = next(r["plain_ms"] for r in results if r["case"] == "k4000")
    timing["k4000"]["bound_ms"] = sweep_bound_ms(keep, v)[0]
    emit({"phase": "kernel_nms_iou", "cases": results, "limit": limit, "timing": timing})
    return timing


def phase_slice_rpn(backbone="vgg_EF", phase="slice_rpn"):
    """Rotated anchor NeRF-RPN proposal inference at the RPN's benchmark
    shape; with another ``backbone`` (a line of ``phase``) also the device
    time of its first conv."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep_plain
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer, pad_to_32

    cfg = RPNConfig(rotated_bbox=True, dtype="bfloat16", resolution=160, seed=0,
                    backbone_type=backbone)
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
    if launches["nms_sweep"] != 1:  # all levels in one NMS call
        raise AssertionError(f"the RPN path's one NMS call launched B2 "
                             f"{launches['nms_sweep']} times: {launches}")

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
    if not (torch.equal(props_k.boxes[0][v], boxes)
            and torch.equal(props_k.level_ids[0][v], lvls)):
        raise AssertionError("the re-run filter differs from predict_scene's proposals")
    # the rotated IoU of the valid ones of the 4 x pre_nms_top_n candidates
    iou, svalid = captured[0]
    k, swept = 4 * cfg.pre_nms_top_n, int(iou.shape[0])
    if not (1 <= swept <= k and bool(svalid.all())):
        raise AssertionError(f"NMS input {tuple(iou.shape)} with {int(svalid.sum())} valid; "
                             f"expected the valid ones of K = {k}")
    del feats, obj, reg, props_k, props_p

    bench = trainer.benchmark(reps=10, shape=shape)
    prof = trainer.profile(reps=5, shape=shape, top=12 if backbone == "vgg_EF" else 16)
    line = {"phase": phase, "grid": list(shape), "padded": [pad_to_32(d) for d in shape],
            "backbone": backbone, "anchors_per_location": 13, "rotated_bbox": True,
            "pre_nms_top_n": cfg.pre_nms_top_n, "post_nms_top_n": cfg.post_nms_top_n,
            "nms_thresh": cfg.nms_thresh, "nms_candidates": k, "nms_swept": swept,
            "dtype": "bfloat16",
            "launches": launches, "first_call_s": round(first_s, 3),
            "proposals": n, "levels": torch.bincount(lvls, minlength=4).tolist(),
            "plain_nms_identical": True, "same_as_predict_scene": True,
            "predict_scene": bench, "profile": prof}
    if backbone != "vgg_EF":
        line["run"] = f"rpn_rotated_{backbone}"
        line["module_ms"] = module_times(trainer.model.backbone,
                                         lambda: trainer.predict_scene(grid))
    emit(line)
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


# FCOS: 160^3 grid, 4 levels (40^3, 20^3, 10^3, 5^3) at the trainer's
# defaults; each level takes min(2500, R) of the whole location vector R
def module_times(backbone, run, reps=3) -> dict:
    """Device ms per ``run()`` inside the backbone's window attention (all
    blocks), its first conv (the Swin patch embed or the ResNet stem) and
    the whole backbone, from CUDA events that forward hooks record around
    each call (median of ``reps`` runs after one warm-up)."""
    import torch

    from instance_nerf_tpu_torch.models.swin import ShiftedWindowAttention3D

    groups = {"backbone": [backbone],
              "attention": [m for m in backbone.modules()
                            if isinstance(m, ShiftedWindowAttention3D)],
              "first_conv": [getattr(backbone, "patch_embed", None)
                             or backbone.stem.conv]}
    spans = {name: [] for name in groups}
    handles = []

    def hooks(name):
        def pre(mod, args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans[name].append([e])

        def post(mod, args, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans[name][-1].append(e)

        return pre, post

    for name, mods in groups.items():
        pre, post = hooks(name)
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        run()
        torch.cuda.synchronize()
        per_run = {name: [] for name in groups}
        for _ in range(reps):
            for v in spans.values():
                v.clear()
            run()
            torch.cuda.synchronize()
            for name, v in spans.items():
                per_run[name].append(sum(a.elapsed_time(b) for a, b in v))
    finally:
        for h in handles:
            h.remove()
    out = {f"{name}_ms": float(np.median(v)) for name, v in per_run.items()}
    out["attention_calls"] = len(groups["attention"])
    return out


FCOS_GRID = (160, 160, 160)
# small_reference_fcos: the seeded cls and centerness kernels times these
# put the 64^3 grid's proposal scores 1e-5 apart or more (the CPU run reads
# 1.13e-5 for AABBs at 5 and 3.2e-5 for OBBs at 7)
FCOS_REF_SCALE = {"aabb": 5.0, "rotated": 7.0}


def fcos_mode(rotated, grid, backbone="vgg_EF", time_nms=True):
    """One box mode of the FCOS slice: the main path with its launches
    counted, the post-processing re-run with the plain sweep (outputs must
    be equal), then the scene's NMS input (the kernel timed on it with
    ``time_nms``), ``benchmark`` and ``profile``; for a Swin or ResNet
    backbone also the device time of its attention and its first conv
    (``module_times``)."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import (
        nms_boxes,
        nms_boxes_plain,
        nms_sweep,
        nms_sweep_plain,
    )
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

    cfg = FCOSConfig(rotated_bbox=rotated, dtype="bfloat16", seed=0, backbone_type=backbone)
    trainer = FCOSTrainer(cfg, device="cuda")
    trainer.init_state()
    mode = "obb" if rotated else "aabb"
    kernel, plain = (nms_sweep, nms_sweep_plain) if rotated else (nms_boxes, nms_boxes_plain)

    # the main path: counts zeroed just before, read just after
    zero_launches()
    t0 = time.perf_counter()
    boxes, scores, lvls = trainer.predict_scene(grid)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    want = {"nms_boxes": 0 if rotated else 1, "nms_sweep": 1 if rotated else 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"FCOS {mode}: one NMS call must launch {want}: {launches}")
    n = int(boxes.shape[0])
    if boxes.dim() != 2 or boxes.shape[1] != (7 if rotated else 6) or not (
            1 <= n <= cfg.fpn_post_nms_top_n):
        raise AssertionError(f"FCOS {mode}: proposals {tuple(boxes.shape)}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores.float()).all()):
        raise AssertionError(f"FCOS {mode}: non-finite proposals")

    # the same head outputs post-processed with the kernel and with the
    # plain sweep must give equal proposals
    info, logits, reg, ctr, feats, sizes, pm = trainer.head_outputs(grid)
    captured = []

    def plain_sweep(x, svalid, thr):  # records the scene's NMS input, output and ms
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        keep = plain(x, svalid, thr)
        end.record()
        end.synchronize()
        captured.append((x, svalid, keep, start.elapsed_time(end)))
        return keep

    props_k = trainer.postprocess(info, logits, reg, ctr, sizes, pm)
    props_p = trainer.postprocess(info, logits, reg, ctr, sizes, pm, nms_sweep=plain_sweep)
    for f in props_k._fields:
        if not torch.equal(getattr(props_k, f), getattr(props_p, f)):
            raise AssertionError(f"FCOS {mode}: kernel vs plain NMS proposals differ in {f}")
    v = props_k.valid[0]
    same_as_predict = all(torch.equal(a, b) for a, b in (
        (props_k.boxes[0][v], boxes), (props_k.scores[0][v], scores),
        (props_k.level_ids[0][v], lvls)))
    if not same_as_predict:
        raise AssertionError(f"FCOS {mode}: the re-run post-processing differs from "
                             "predict_scene's proposals")
    x, svalid, keep_plain, plain_ms = captured[0]
    r = int(logits.shape[1])
    k = len(cfg.fpn_strides) * min(cfg.pre_nms_top_n, r)  # candidates into the NMS
    n_valid = sum(min(cfg.pre_nms_top_n, int(f.shape[1] * f.shape[2] * f.shape[3]))
                  for f in feats)  # every real location scores > 0 (no padding at 160^3)
    swept = int(x.shape[0])
    if rotated:  # the IoU of the valid candidates alone, all valid
        ok = swept == n_valid and bool(svalid.all())
    else:  # B1 takes all K sorted boxes and their valid flags
        ok = swept == k and int(svalid.sum()) == n_valid
    if not ok:
        raise AssertionError(f"FCOS {mode}: NMS input {tuple(x.shape)} with "
                             f"{int(svalid.sum())} valid; expected K = {k}, {n_valid} valid")
    del feats, logits, reg, ctr, props_k, props_p

    # the kernel on the scene's own NMS input, beside its plain sweep (the
    # re-run's, timed there: seconds at K = 10,000)
    keep = kernel(x, svalid, cfg.nms_thresh)
    if not torch.equal(keep, keep_plain):
        raise AssertionError(f"FCOS {mode}: kernel disagrees on the scene's NMS input")
    timing = {}
    if time_nms:
        timing = nms_times({}, lambda: kernel(x, svalid, cfg.nms_thresh), reps=20,
                           dev_reps=20)
        timing["plain_ms"] = plain_ms
        bound = (sweep_bound_ms if rotated else nms_bound_ms)(keep, svalid)
        timing["bound_ms"], timing["bound_by"] = bound
    nms = {"k": k, "valid": n_valid, "swept": swept, "kept": int(keep.sum()),
           "launches": launches["nms_sweep" if rotated else "nms_boxes"], **timing}
    del x, svalid, keep

    bench = trainer.benchmark(reps=10, shape=FCOS_GRID)
    prof = trainer.profile(reps=5, shape=FCOS_GRID, top=16)
    report = {"box_mode": mode, "backbone": backbone, "launches": launches,
              "first_call_s": round(first_s, 3),
              "proposals": n, "levels": torch.bincount(lvls, minlength=4).tolist(),
              "plain_nms_identical": True, "same_as_predict_scene": same_as_predict,
              "nms": nms, "predict_scene": bench, "profile": prof}
    if backbone != "vgg_EF":
        report["module_ms"] = module_times(trainer.model.backbone,
                                           lambda: trainer.predict_scene(grid))
    del trainer
    torch.cuda.empty_cache()
    return report


def phase_slice_fcos():
    """FCOS proposal inference through ``FCOSTrainer.predict_scene`` at the
    JAX trainer's defaults (VGG-EF, 4 tower convs of 256 channels with
    GroupNorm(32), strides 4..32, 2500 candidates a level and 2500 after
    the NMS at 0.3, bf16, seeded random weights) on a 160^3 grid: AABB
    through B1, then rotated through the rotated IoU and B2."""
    import torch

    grid = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (*FCOS_GRID, 4)).astype(np.float32)).to("cuda")
    modes = {"aabb": fcos_mode(False, grid), "obb": fcos_mode(True, grid)}
    emit({"phase": "slice_fcos", "grid": list(FCOS_GRID), "backbone": "vgg_EF",
          "num_convs": 4, "pre_nms_top_n": 2500, "fpn_post_nms_top_n": 2500,
          "nms_thresh": 0.3, "dtype": "bfloat16", **modes})
    return modes


def phase_slice_backbones(smi):
    """The detectors with the ResNet and Swin backbones (main path of slice
    5b), full width, seeded random weights, bf16: FCOS with ``swin_s`` at
    160^3, AABB through B1 (K = 10,000) and rotated through the rotated IoU
    and B2; the rotated anchor RPN with ``resnet`` at 200x200x130 padded to
    224x224x160 (K = 4000 into B2); the RCNN with ``resnet`` at 200x200x132
    (20 rois, 25 detections, B1). Each run: its launches counted (the
    counts zeroed just before it, at least one launch of its kernel), its
    proposals or detections equal to a re-run with the plain sweep,
    ``predict_scene`` ms (median of 10 warmed runs), the stage spans, peak
    bytes, the busy share, and the device time of the attention and of the
    first conv."""
    import torch

    grid = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (*FCOS_GRID, 4)).astype(np.float32)).to("cuda")
    out = {}
    for rotated in (False, True):
        name = f"fcos_{'rotated' if rotated else 'aabb'}_swin_s"
        rep = fcos_mode(rotated, grid, backbone="swin_s", time_nms=False)
        emit({"phase": "slice_backbones", "run": name, "grid": list(FCOS_GRID),
              "dtype": "bfloat16", "nvidia_smi": smi, **rep})
        out[name] = rep["launches"]
    del grid
    torch.cuda.empty_cache()
    out["rpn_rotated_resnet"], _ = phase_slice_rpn("resnet", phase="slice_backbones")
    out["rcnn_resnet"], _ = phase_slice_rcnn("resnet", phase="slice_backbones")
    torch.cuda.empty_cache()
    return out


def phase_small_reference_fcos():
    """f32 on the card (TF32 off) against the port's CPU reference on a
    64^3 grid with the same seeded weights, AABB and rotated. 128
    candidates a level before the NMS and 100 after keep the CPU's rotated
    IoU small. The seeded head draws its cls and centerness kernels from
    normal(0.01), whose scores sit an ulp or two apart; both runs scale
    those kernels by ``FCOS_REF_SCALE``, which puts the proposals' scores
    1e-5 apart or more, ten times the two devices' rounding (checked)."""
    import torch

    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_sweep_plain
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

    grid = np.random.default_rng(4).uniform(0, 1, (64, 64, 64, 4)).astype(np.float32)
    report = {"phase": "small_reference_fcos", "grid": [64, 64, 64], "dtype": "float32",
              "tolerance": {"raw_outputs_rel": 1e-4, "boxes_abs": 1e-3,
                            "discrete": "identical", "min_score_gap": 1e-5,
                            "iou_margin_to_0.3": 1e-5}}
    failed = []
    for rotated in (False, True):
        mode = "rotated" if rotated else "aabb"
        cfg = FCOSConfig(rotated_bbox=rotated, dtype="float32", seed=3, pre_nms_top_n=128,
                         fpn_post_nms_top_n=100)
        outs = {}
        for device in ("cuda", "cpu"):
            tr = FCOSTrainer(cfg, device=device)
            tr.init_state()
            with torch.no_grad():
                tr.model.head.cls_logits.weight.mul_(FCOS_REF_SCALE[mode])
                tr.model.head.centerness.weight.mul_(FCOS_REF_SCALE[mode])
            info, logits, reg, ctr, _, sizes, pm = tr.head_outputs(grid)
            captured = []

            def sweep(iou, svalid, thr, _cap=captured):  # records the NMS input
                _cap.append((iou, svalid))
                return nms_sweep_plain(iou, svalid, thr)

            props = tr.postprocess(info, logits, reg, ctr, sizes, pm,
                                   nms_sweep=sweep if rotated and device == "cpu" else None)
            outs[device] = ([t.cpu() for t in (logits, reg, ctr)], [p.cpu() for p in props],
                            captured)
        (rc, pc, _), (rp, pp, cap) = outs["cuda"], outs["cpu"]
        raw_err = max(float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
                      for a, b in zip(rc, rp))
        same = {f: bool(torch.equal(a, b)) for f, a, b in
                zip(("valid", "level_ids"), (pc[3], pc[2]), (pp[3], pp[2]))}
        box_err = float((pc[0] - pp[0]).abs().max())
        sc = torch.sort(pp[1][0][pp[3][0]].float()).values
        score_gap = float((sc[1:] - sc[:-1]).min()) if sc.numel() > 1 else 1.0
        report[mode] = {"max_rel_err_raw_outputs": raw_err, "discrete_identical": same,
                        "max_abs_box_err": box_err, "proposals": int(pp[3].sum()),
                        "min_score_gap": score_gap}
        if rotated:
            iou, svalid = cap[0]
            pairs = torch.triu(svalid[:, None] & svalid[None, :], diagonal=1)
            iou_margin = float((iou[pairs] - cfg.nms_thresh).abs().min())
            report[mode]["iou_margin_to_0.3"] = iou_margin
            if iou_margin < 1e-5:
                failed.append(f"{mode}: an OBB IoU lies within 1e-5 of 0.3")
        if score_gap < 1e-5:
            failed.append(f"{mode}: two scores lie within 1e-5 of each other")
        if raw_err > 1e-4:
            failed.append(f"{mode}: raw outputs differ by {raw_err} > 1e-4 relative")
        if not all(same.values()) or box_err > 1e-3:
            failed.append(f"{mode}: f32 card proposals disagree with the CPU reference")
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))


# the keys each trainer's eval writes (the JAX trainers' own)
# small_reference_backbones: a swin_t-shaped Swin and the resnet ResNet-FPN,
# each cut to depth (2, 2, 2, 2) and (1, 1, 1, 1), on a 32^3 grid
REF_SWIN = dict(embed_dim=96, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24))
REF_RESNET = dict(layers=(1, 1, 1, 1), in_planes=64, is_max_pool=True)


def phase_small_reference_backbones():
    """The new backbones on the card (f32, TF32 off) against the port's CPU
    run from the same seeded weights, on a 32^3 grid, batch 2:

    * every pyramid level of a swin_t-shaped Swin (embed 96, heads (3, 6,
      12, 24), depths cut to (2, 2, 2, 2)), of the ``resnet`` ResNet-FPN cut
      to one bottleneck a stage, and of ``VGG_FPN(conv_at_start=True)``
      (vgg_AF): to 1e-4 of the level's largest entry;
    * one FCOS train step with each of the first two, in f64: losses to 1e-4
      relative, every gradient to 1e-4 of its tensor's largest entry;
    * ``postprocess_detections(box_dim=8)`` of 200 rois x 10 classes: the
      card through B2 (launched), the CPU through its plain sweep; keep set,
      labels and roi indices exact, OBBs to 1e-5 of their largest entry
      (the card's and the CPU's sin, cos and atan2 differ by an ulp), the
      decided IoUs at least 1e-5 from the threshold."""
    import copy

    import torch

    from instance_nerf_tpu_torch.models.backbones import ResNet_FPN_256, VGG_FPN
    from instance_nerf_tpu_torch.models.fcos import FCOSOverNeRF, init_fcos_head
    from instance_nerf_tpu_torch.models.rcnn import postprocess_detections
    from instance_nerf_tpu_torch.models.swin import SwinTransformerFPN
    from instance_nerf_tpu_torch.ops.boxes import small_box_mask
    from instance_nerf_tpu_torch.ops.coders import MidpointOffsetCoder
    from instance_nerf_tpu_torch.ops.rotated_iou import pairwise_iou_3d
    from instance_nerf_tpu_torch.parallel.train_step import (
        TrainState,
        make_fcos_train_step,
        make_optimizer,
    )
    from instance_nerf_tpu_torch.train.loop import synthetic_batch
    from instance_nerf_tpu_torch.train.rcnn_trainer import init_rcnn_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"phase": "small_reference_backbones", "grid": [32, 32, 32], "batch": 2,
              "swin": REF_SWIN, "resnet": REF_RESNET,
              "tolerance": {"levels_rel_f32": 1e-4, "losses_rel_f64": 1e-4,
                            "grads_of_max_f64": 1e-4, "obb_boxes_rel": 1e-5,
                            "discrete": "identical"}}
    failed = []
    x = torch.from_numpy(np.random.default_rng(12).uniform(
        0, 1, (2, 32, 32, 32, 4)).astype(np.float32))
    factories = {"swin": lambda: SwinTransformerFPN(**REF_SWIN),
                "resnet": lambda: ResNet_FPN_256(**REF_RESNET),
                "vgg_conv_at_start": lambda: VGG_FPN("AF", conv_at_start=True)}
    for seed, (name, build) in enumerate(factories.items()):
        cpu = build()
        init_rcnn_params(cpu, seed)
        card = copy.deepcopy(cpu).to("cuda")
        with torch.no_grad():
            want, got = cpu(x), card(x.to("cuda"))
        errs = [float((g.cpu() - w).abs().max()) / (float(w.abs().max()) or 1.0)
                for g, w in zip(got, want)]
        report[f"{name}_levels_max_rel_err"] = errs
        if max(errs) > 1e-4:
            failed.append(f"{name}: a level differs by {max(errs)} of its max")
    # one FCOS step in f64
    arrays = synthetic_batch(2, (32, 32, 32), 6, 6)
    for seed, name in enumerate(("swin", "resnet")):
        cpu = FCOSOverNeRF(factories[name](), num_convs=2)
        init_rcnn_params(cpu.backbone, seed)
        init_fcos_head(cpu.head, torch.Generator().manual_seed(seed + 1))
        run = {}
        for device in ("cuda", "cpu"):
            model = copy.deepcopy(cpu).to(device=device, dtype=torch.float64)
            args = [torch.as_tensor(a, device=device) for a in arrays]
            args = [a.double() if a.is_floating_point() else a for a in args]
            state = TrainState(model, make_optimizer(model.named_parameters()))
            _, metrics = make_fcos_train_step(model)(state, *args)
            run[device] = (model, {k: float(v) for k, v in metrics.items()})
        (mc, lc), (mp, lp) = run["cuda"], run["cpu"]
        loss_err = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lp)
        grads = dict(mp.named_parameters())
        grad_err = max(float((p.grad.cpu() - grads[n].grad).abs().max())
                       / max(float(grads[n].grad.abs().max()), 1e-30)
                       for n, p in mc.named_parameters() if p.grad is not None
                       and float(grads[n].grad.abs().max()) > 1e-12)
        report[f"fcos_step_{name}"] = {"losses": lp, "max_rel_err_losses": loss_err,
                                       "max_grad_err": grad_err}
        if loss_err > 1e-4 or grad_err > 1e-4:
            failed.append(f"fcos step with {name}: losses {loss_err}, gradients {grad_err}")
    # OBB detections through B2
    rng = np.random.default_rng(13)
    p, c = 200, 11
    lo = rng.uniform(0, 120, (1, p, 3))
    props = np.concatenate([lo, lo + rng.uniform(8, 40, (1, p, 3))], -1).astype(np.float32)
    args = [rng.normal(0, 2.0, (1, p, c)).astype(np.float32),
            rng.normal(0, 0.2, (1, p, c, 8)).astype(np.float32), props,
            np.ones((1, p), bool), np.asarray([[160.0, 160, 130]], np.float32)]
    kw = dict(score_thresh=0.0, nms_thresh=0.15, detections_per_img=100, box_dim=8)
    zero_launches()
    det_c = postprocess_detections(*(torch.from_numpy(a).to("cuda") for a in args), **kw)
    launches = read_launches()
    det_p = postprocess_detections(*map(torch.from_numpy, args), **kw)
    same = {f: bool(torch.equal(getattr(det_c, f).cpu(), getattr(det_p, f)))
            for f in ("valid", "labels", "roi_index")}
    box_err = float((det_c.boxes.cpu() - det_p.boxes).abs().max()) / float(
        det_p.boxes.abs().max())
    # the IoUs the sweep decides on: the valid decoded OBBs of each class
    dec = MidpointOffsetCoder().decode(torch.from_numpy(args[1][0]),
                                       torch.from_numpy(props[0])[:, None])
    margin = 1.0
    for cls in range(1, c):
        b = dec[:, cls][small_box_mask(dec[:, cls], 1e-2)].double()
        iou = pairwise_iou_3d(b, b)
        off = ~torch.eye(b.shape[0], dtype=torch.bool)
        margin = min(margin, float((iou[off] - 0.15).abs().min()))
    report["obb_detections"] = {"launches": launches, "discrete_identical": same,
                                "max_rel_box_err": box_err, "kept": int(det_p.valid.sum()),
                                "candidates": p * (c - 1), "iou_margin_to_0.15": margin}
    if launches["nms_sweep"] < 1:
        failed.append(f"OBB detections did not launch B2: {launches}")
    if margin < 1e-5:
        failed.append("an OBB IoU lies within 1e-5 of 0.15")
    if not all(same.values()) or box_err > 1e-5:
        failed.append(f"OBB detections: card vs CPU {same}, boxes {box_err}")
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


PROPOSAL_METRICS = sorted([f"recall_{t}_top{n}" for t in (25, 50) for n in (300, 1000, "all")]
                          + ["recall_25", "recall_50", "ar", "ap_25", "ap_50"])
RCNN_METRICS = sorted([f"{k}_{t}" for k in ("box_mAP", "box_AR", "mask_mAP", "mask_AR")
                       for t in (25, 50)] + ["box_AP_25_per_class"])


def run_cli(main, argv, out_dir, keys):
    """One CLI eval run on the card (its printout kept out of this
    script's), then its ``eval.json``: every key the JAX trainer writes,
    every value finite. Returns the metrics and the seconds it took."""
    import contextlib
    import io
    import os

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv + ["--save_path", out_dir])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "eval.json")) as f:
        metrics = json.load(f)
    values = [x for k, v in metrics.items() for x in (v if isinstance(v, list) else [v])
              if x is not None]
    if sorted(metrics) != keys or not all(np.isfinite(x) for x in values):
        raise AssertionError(f"{main.__module__}: eval.json {metrics}")
    return metrics, seconds


def npz_layout(root, sub):
    """{file: {key: shape}} of the ``.npz`` files under ``root/sub``."""
    import os

    out = {}
    for name in sorted(os.listdir(os.path.join(root, sub))):
        with np.load(os.path.join(root, sub, name)) as z:
            out[name] = {k: list(z[k].shape) for k in z.files}
    return out


def files_summary(layout):
    """Per directory: the number of files and the first one's arrays."""
    return {sub: {"files": len(f), "first": next(iter(f.values()), None)}
            for sub, f in layout.items()}


def phase_eval():
    """The eval modes through the CLIs on the card, chained as a user runs
    them, with seeded random weights: a dataset of 4 scenes at 64x64x48
    written by the port's ``write_dataset`` (boxes, and a rotated one),
    ``run_fcos --mode eval`` in both box modes, ``run_rpn --mode eval``
    exporting the proposals, level features and voxel scores, then
    ``run_rcnn --mode eval`` over those proposals as the dataset's
    ``rois/``. The metrics must have the JAX trainers' keys and finite
    values; the files written must have the JAX package's layout."""
    import os
    import tempfile

    from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn
    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    report = {"phase": "eval", "scenes": 4, "grid": [64, 64, 48]}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        data = {}
        for kind, rotated in (("aabb", False), ("obb", True)):
            root = os.path.join(tmp, kind)
            scenes = write_dataset(root, num_scenes=4, grid_size=(64, 64, 48), seed=0,
                                   style="room" if rotated else "boxes", rotated=rotated)
            # every scene in every split: the CLIs evaluate the test (FCOS,
            # RPN) or the val split (RCNN), and the RCNN needs the RPN's rois
            with open(os.path.join(root, "all.json"), "w") as f:
                json.dump({m: scenes for m in ("train", "val", "test")}, f)
            data[kind] = root

        def check(name, layout, keys, shape_of=None, shape=None):
            for f, arrays in layout.items():
                if sorted(arrays) != keys or (shape_of and arrays[shape_of] != shape):
                    bad.append(f"{name}/{f}: {arrays}")

        for kind, root in data.items():
            out = os.path.join(tmp, f"fcos_{kind}")
            argv = ["--mode", "eval", "--features_path", os.path.join(root, "features"),
                    "--boxes_path", os.path.join(root, "boxes_obb" if kind == "obb"
                                                 else "metadata"),
                    "--dataset_split", os.path.join(root, "all.json"),
                    "--save_results", "--output_voxel_scores"]
            metrics, secs = run_cli(run_fcos.main, argv + (["--rotated_bbox"] if kind == "obb"
                                                           else []), out, PROPOSAL_METRICS)
            layout = {sub: npz_layout(out, sub) for sub in ("proposals", "voxel_scores")}
            check(f"fcos_{kind}/proposals", layout["proposals"],
                  ["level_indices", "proposals", "scores"])
            if any(a["proposals"][1:] != [7 if kind == "obb" else 6]
                   for a in layout["proposals"].values()):
                bad.append(f"fcos_{kind}: proposal boxes of another width")
            # per level, cropped to the grid: ceil(64 / 4), ceil(48 / 4)
            check(f"fcos_{kind}/voxel_scores", layout["voxel_scores"], ["0", "1", "2", "3"],
                  "0", [16, 16, 12])
            report[f"fcos_{kind}"] = {"metrics": metrics, "seconds": secs,
                                      "files": files_summary(layout)}
        root = data["aabb"]
        export = os.path.join(tmp, "rpn")
        metrics, secs = run_cli(run_rpn.main, [
            "--mode", "eval", "--features_path", os.path.join(root, "features"),
            "--boxes_path", os.path.join(root, "metadata"),
            "--dataset_split", os.path.join(root, "all.json"),
            "--save_results", "--output_voxel_scores"], export, PROPOSAL_METRICS)
        layout = {sub: npz_layout(export, sub)
                  for sub in ("rois", "level_features", "voxel_scores")}
        check("rpn/rois", layout["rois"], ["level_indices", "proposals", "scores"])
        # the FPN levels of the grid padded to 64^3
        check("rpn/level_features", layout["level_features"],
              ["level_0", "level_1", "level_2", "level_3", "resolution"], "level_0",
              [16, 16, 16, 256])
        check("rpn/voxel_scores", layout["voxel_scores"], ["0", "1", "2", "3"], "0",
              [16, 16, 12])
        report["rpn"] = {"metrics": metrics, "seconds": secs, "files": files_summary(layout)}
        # the RCNN reads the RPN's export as the dataset's rois/
        chained = os.path.join(tmp, "chained")
        os.makedirs(chained)
        for sub in ("features", "masks", "metadata"):
            os.symlink(os.path.join(root, sub), os.path.join(chained, sub))
        os.symlink(os.path.join(export, "rois"), os.path.join(chained, "rois"))
        out = os.path.join(tmp, "rcnn")
        metrics, secs = run_cli(run_rcnn.main, [
            "--mode", "eval", "--dataset_root", chained,
            "--dataset_split", os.path.join(root, "all.json")], out, RCNN_METRICS)
        layout = npz_layout(out, "masks")
        check("rcnn/masks", layout, ["boxes", "labels", "masks", "scores"])
        if any(a["masks"][1:] != [64, 64, 48] for a in layout.values()):
            bad.append("rcnn: masks not of the full grid")
        if len(layout) != 4:
            bad.append(f"rcnn: masks of {len(layout)} scenes, not 4")
        report["rcnn"] = {"metrics": metrics, "seconds": secs,
                          "files": files_summary({"masks": layout})}
    report["layout_errors"] = bad
    emit(report)
    if bad:
        raise AssertionError(f"eval files differ from the JAX layout: {bad}")


def psnr(img, ref) -> float:
    return float(-10.0 * np.log10(max(float(np.mean((img - ref) ** 2)), 1e-10)))


class LaunchRecorder:
    """Records the inputs and output of every scatter-add kernel launch
    (``scatter_cuda._launch``) while it is installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from instance_nerf_tpu_torch.kernels import scatter_cuda

        self._orig = orig = scatter_cuda._launch

        def launch(indices, updates, n_levels, trailing, rows, replicas):
            out = orig(indices, updates, n_levels, trailing, rows, replicas)
            self.calls.append((indices.clone(), updates.clone(), n_levels, trailing, rows,
                               out.clone()))
            return out

        scatter_cuda._launch = launch
        return self

    def __exit__(self, *exc):
        from instance_nerf_tpu_torch.kernels import scatter_cuda

        scatter_cuda._launch = self._orig


def scatter_bound_ms(n, w, rows):
    """Least time for a scatter-add: the updates (4 B a float) and indices
    (4 B) read once and the table, its output, written once, at 3.35 TB/s
    (its n * w adds at 67 TFLOP/s take far less). Zeroing the table first
    is the kernel's choice, not the function's work."""
    byte_s = (n * w * 4 + n * 4 + rows * w * 4) / PEAK_BYTES_PER_S
    ops_s = n * w / PEAK_F32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, "bytes" if byte_s > ops_s else "operations"


def check_scatter(name, idx, upd, rows, n_levels=1, trailing=1, replicas=1, tol=1e-5,
                  mag_rtol=None, timed=False):
    """Kernel B3 against its plain version on the card (and, timed, the
    kernel, the plain version and ``index_add_`` into a zeroed table: ``ms``
    by CUDA events around back-to-back calls; from the profiler,
    ``device_ms`` the kernel alone, ``call_device_ms`` all the device work
    of the wrapper's call and ``library_device_ms`` all of the library
    call's, each with its table's zeroing). Held to ``tol`` absolute, or
    with ``mag_rtol`` to that share of each entry's sum of |updates| (f32
    summation error grows with it)."""
    import torch

    from instance_nerf_tpu_torch.kernels import scatter_cuda

    def kernel():
        return scatter_cuda._launch(idx, upd, n_levels, trailing, rows, replicas)

    def plain():
        return scatter_cuda.level_scatter_add_plain(idx, upd, n_levels, trailing, rows)

    plan = scatter_cuda.scatter_plan(idx.shape[0], upd.shape[1], n_levels, trailing,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max()) if got.numel() else 0.0
    out = {"case": name, "n": int(idx.shape[0]), "w": int(upd.shape[1]),
           "rows": n_levels * rows, "levels": n_levels, "trailing": trailing,
           "replicas": replicas, "plan": plan._asdict(), "max_abs_err": err}
    if mag_rtol is None:
        out["tolerance"] = tol
        bad = err > tol
    else:
        mag = scatter_cuda.level_scatter_add_plain(idx, upd.abs(), n_levels, trailing, rows)
        ratio = torch.where(mag > 0, diff / mag.clamp_min(1e-30), diff)
        out["max_err_per_abs_sum"] = float(ratio.max()) if got.numel() else 0.0
        out["tolerance_per_abs_sum"] = mag_rtol
        bad = out["max_err_per_abs_sum"] > mag_rtol
    if bad:
        raise AssertionError(f"scatter_add kernel disagrees with its plain version: {out}")
    if timed:
        idx_l = idx.long()

        def library():
            return torch.zeros_like(want).index_add_(0, idx_l, upd)

        out["ms"] = cuda_ms(kernel, reps=100)
        out["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
        out["library_ms"] = cuda_ms(library, reps=100)
        profiled(out, "device_ms", kernel, 20, "scatter_add_kernel", "scatter_add_kernel")
        profiled(out, "call_device_ms", kernel, 20, "scatter_add_kernel")
        profiled(out, "library_device_ms", library, 20, "indexFunc")
        out["bound_ms"], out["bound_by"] = scatter_bound_ms(idx.shape[0], upd.shape[1],
                                                            n_levels * rows)
    return out


def level_stream(idx, upd, n_levels, trailing, rows, level):
    """The updates of one level of a multi-level gradient, rebased to
    ``[0, rows)``, in their layout (points, trailing)."""
    import torch

    pos = torch.arange(idx.shape[0], device=idx.device)
    sel = (pos // trailing) % n_levels == level
    return (idx[sel] - level * rows).contiguous(), upd[sel].contiguous()


def train_and_check(cfg, label, rgb_steps, inst_steps, bench_reps):
    """The field slice's main path for one config: train ``rgb_steps`` rgb
    steps (the launch counts zeroed just before and read just after; B3
    must launch on every step), check one step's table gradient against
    the plain scatter, train ``inst_steps`` instance steps (only ``inst_*``
    may move), render a view (PSNR must rise), then benchmark and profile.
    Returns the report, the trainer, the scene and the step's recorded B3
    launch."""
    import torch

    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.kernels import scatter_cuda
    from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer

    scene, _ = make_synthetic_nerf_scene(np.random.default_rng(0), device="cuda",
                                         **FIELD_SCENE)
    trainer = InstanceFieldTrainer(cfg, seed=0, device="cuda")
    view = trainer.render_image(scene.poses[0], scene.intrinsics, scene.hw)
    psnr0 = psnr(view["rgb"], scene.images[0])

    # the main path: counts zeroed just before, read just after
    zero_launches()
    t0 = time.perf_counter()
    m_rgb = trainer.train(scene, rgb_steps, stage="rgb", log_every=0)
    torch.cuda.synchronize()
    rgb_s = time.perf_counter() - t0
    launches = read_launches()
    if launches["scatter_add"] != rgb_steps:
        raise AssertionError(f"{label}: B3 launched {launches['scatter_add']} times in "
                             f"{rgb_steps} rgb steps")

    # one step's table gradient, kernel against the plain scatter-add
    o, d, rgb, inst = trainer._batch(scene, torch.as_tensor(scene.poses, device="cuda"))
    with LaunchRecorder() as rec:
        _, grads = trainer.loss_and_grads("rgb", o, d, rgb, inst)
    table = "hash_table" if cfg.encoding == "hash" else "brick_table"
    idx, upd, n_levels, trailing, rows, out = rec.calls[0]
    g = grads[table].reshape(out.shape)
    plain = scatter_cuda.level_scatter_add_plain(idx, upd, n_levels, trailing, rows)
    g_err = float((g - plain).abs().max())
    g_scale = float(plain.abs().max())
    if not torch.equal(g, out) or g_err > 1e-5 * g_scale:
        raise AssertionError(f"{label}: table gradient differs from the plain scatter by "
                             f"{g_err} (largest entry {g_scale})")
    del grads, g

    zero_launches()
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    m_inst = trainer.train(scene, inst_steps, stage="instance", log_every=0)
    torch.cuda.synchronize()
    inst_launches = read_launches()
    moved = sorted(k for k, v in trainer.params.items() if not torch.equal(v, before[k]))
    if not moved or any(not k.startswith("inst_") for k in moved):
        raise AssertionError(f"{label}: the instance stage moved {moved}")
    del before

    view = trainer.render_image(scene.poses[0], scene.intrinsics, scene.hw)
    psnr1 = psnr(view["rgb"], scene.images[0])
    if not (np.isfinite(view["rgb"]).all() and view["rgb"].shape == (*scene.hw, 3)
            and view["instance"].shape == scene.hw):
        raise AssertionError(f"{label}: rendered view {view['rgb'].shape} not finite")
    if not psnr1 > psnr0:
        raise AssertionError(f"{label}: PSNR did not rise ({psnr0} -> {psnr1})")
    feats = trainer.extract_rgbsigma(32)
    if feats.shape != (32, 32, 32, 4) or not np.isfinite(feats).all():
        raise AssertionError(f"{label}: extract_rgbsigma {feats.shape}")
    if not all(np.isfinite(v) for v in (*m_rgb.values(), *m_inst.values())):
        raise AssertionError(f"{label}: non-finite losses {m_rgb} {m_inst}")

    bench = {stage: trainer.benchmark_train(reps=bench_reps, stage=stage)
             for stage in ("rgb", "instance")}
    prof = trainer.profile(scene, stage="rgb", reps=5)
    report = {"launches_rgb": launches, "launches_instance": inst_launches,
              "rgb_steps": rgb_steps, "instance_steps": inst_steps,
              "train_rgb_s": rgb_s, "losses_rgb": m_rgb, "losses_instance": m_inst,
              "table_grad_vs_plain_max_abs_err": g_err, "table_grad_max_abs": g_scale,
              "moved_in_instance_stage": moved, "psnr_view0_before": psnr0,
              "psnr_view0_after": psnr1, "benchmark": bench, "profile": prof}
    return report, trainer, scene, (idx, upd, n_levels, trailing, rows)


def phase_slice_field():
    import torch

    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig

    cfg = NGPConfig(k_occupied=32, pallas_grad=True)
    report, trainer, scene, step = train_and_check(cfg, "slice_field", rgb_steps=64,
                                                   inst_steps=32, bench_reps=20)
    emit({"phase": "slice_field", "config": "NGPConfig(k_occupied=32, pallas_grad=True)",
          "encoding": "hash", "levels": cfg.n_levels, "table_size": cfg.table_size,
          "features": cfg.n_features, "resolutions": [int(r) for r in
                                                      trainer.model.resolutions],
          "n_rays": cfg.n_rays, "n_samples": cfg.n_samples, "k_occupied": cfg.k_occupied,
          "occ_res": cfg.occ_res, "dtype": cfg.dtype, "scene": FIELD_SCENE, **report})
    del trainer, scene
    torch.cuda.empty_cache()
    return report["launches_rgb"], step


def phase_slice_field_fast():
    import torch

    from instance_nerf_tpu_torch.models.render import (
        coarse_cells,
        ray_aabb,
        sample_points,
        update_occupancy,
    )
    from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer, fast_ngp_config

    kw = dict(k_occupied=32, occ_coarse_res=32, table_size=2 ** 15, n_levels=3, n_features=4,
              pallas_grad=True)
    cfg = fast_ngp_config(**kw)
    report, trainer, scene, step = train_and_check(cfg, "slice_field_fast", rgb_steps=32,
                                                   inst_steps=16, bench_reps=20)

    # bf16 MLPs against the same field in f32, on one batch with one draw
    poses = torch.as_tensor(scene.poses, device="cuda")
    o, d, rgb, inst = trainer._batch(scene, poses)
    jitter = torch.rand((cfg.n_rays, cfg.n_samples), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    f32 = InstanceFieldTrainer(fast_ngp_config(**kw, dtype="float32"), seed=0, device="cuda")
    f32.model.load_state_dict(trainer.model.state_dict())
    f32.occ = trainer.occ
    with torch.no_grad():
        out16 = trainer.render(o, d, with_instance=True, jitter=jitter)
        out32 = f32.render(o, d, with_instance=True, jitter=jitter)
    bf16 = {"rgb_max_abs_diff": float((out16.rgb - out32.rgb).abs().max()),
            "rgb_mean_abs_diff": float((out16.rgb - out32.rgb).abs().mean()),
            "acc_max_abs_diff": float((out16.acc - out32.acc).abs().max()),
            "tolerance_max_abs": 0.05}
    if bf16["rgb_max_abs_diff"] > 0.05 or bf16["acc_max_abs_diff"] > 0.05:
        raise AssertionError(f"bf16 field departs from the f32 field: {bf16}")
    del f32

    # B5's inputs: the coarse cells of this config's own candidate samples
    with torch.no_grad():
        near, far = ray_aabb(o, d)
        far = torch.maximum(far, near + 1e-4)
        xyz, _, _ = sample_points(o, d, cfg.n_samples, near, far, generator=trainer.gen)
        xyz_c = torch.clamp(xyz, 0.0, 1.0)
        # the field's own density at jittered cell centers (no EMA): a grid
        # with empty space, beside the path's grid, still fully occupied
        dens = update_occupancy(trainer.occ, trainer.sigma, generator=trainer.gen, decay=0.0)
    b5_inputs = (coarse_cells(xyz_c, cfg.occ_coarse_res), xyz_c, cfg.occ_coarse_res,
                 {"path_grid": trainer.occ, "field_density": dens})
    emit({"phase": "slice_field_fast", "config": f"fast_ngp_config({kw})", "encoding": "fast",
          "n_rays": cfg.n_rays, "n_samples": cfg.n_samples, "dtype": cfg.dtype,
          "scene": FIELD_SCENE, "bf16_vs_f32": bf16, **report})
    del trainer, scene
    torch.cuda.empty_cache()
    return report["launches_rgb"], step, b5_inputs


def adversarial_scatter_cases(rng, hash_idx, hash_upd):
    """B3 against the plain version where it could go wrong: indices far
    below and past T on every level of the hash layout (N also cut to no
    multiple of the layout), all updates on one row, every row width the
    kernel treats apart, the brick layout with stray indices, and
    replicas."""
    import torch

    dev = torch.device("cuda")

    def normal(n, w):
        return torch.as_tensor(rng.normal(size=(n, w)).astype(np.float32), device=dev)

    cases = []
    # hash layout (trailing 8), T = 4096: most indices in a level's first
    # 64 rows (runs of equal rows), 10% anywhere in [-40, T + 40), and 400
    # points a level on row 0, T - 1, T or far past T
    t, pts = 4096, 8192
    local = rng.integers(0, 64, (pts, 3, 8))
    stray = rng.uniform(size=local.shape) < 0.1
    local[stray] = rng.integers(-40, t + 40, int(stray.sum()))
    for l in range(3):
        edge = rng.integers(0, pts, 400)
        local[edge, l, :] = rng.choice([-t, 0, t - 1, t, t + 5000], (400, 1))
    idx = (torch.as_tensor(local, device=dev) + torch.arange(3, device=dev).view(1, 3, 1) * t
           ).reshape(-1).to(torch.int32)
    upd = normal(idx.shape[0], 2)
    cases.append(check_scatter("stray_hash_layout", idx, upd, t, 3, 8, mag_rtol=1e-5))
    cases.append(check_scatter("stray_hash_layout_odd_n", idx[:-5], upd[:-5], t, 3, 8,
                               mag_rtol=1e-5))
    # every update on one row
    one = torch.full((2 ** 18,), 7, dtype=torch.int32, device=dev)
    cases.append(check_scatter("one_row", one, normal(2 ** 18, 2), 1024, mag_rtol=1e-5))
    # the row widths: float2 (2), scalar (3), float4 (4), float4 with
    # several threads a row (16: 4, 32: 8)
    for w in (2, 3, 4, 16, 32):
        idx = torch.as_tensor(rng.integers(-8, 520, 65536).astype(np.int32), device=dev)
        cases.append(check_scatter(f"w{w}", idx, normal(65536, w), 512, mag_rtol=1e-5))
    cases.append(check_scatter("levels_hash_layout_w4", hash_idx,
                               normal(hash_idx.shape[0], 4), 256, 3, 8, mag_rtol=1e-5))
    brick_idx = (torch.as_tensor(rng.integers(-10, 266, (20000, 3)), device=dev)
                 + torch.arange(3, device=dev).view(1, 3) * 256).reshape(-1).to(torch.int32)
    cases.append(check_scatter("levels_brick_layout", brick_idx,
                               normal(brick_idx.shape[0], 32), 256, 3, 1, mag_rtol=1e-5))
    idx = torch.as_tensor(rng.integers(0, 16, 16384).astype(np.int32), device=dev)
    cases.append(check_scatter("replicas_4_hot_rows", idx, normal(16384, 2), 1024,
                               replicas=4, mag_rtol=1e-5))
    return cases


def phase_kernel_scatter(main_step, fast_step):
    """B3 against its plain version on synthetic cases, the B6 probe shapes
    and the slices' own index streams; returns the timed cases."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def rand(n, t, w, lo=0):
        idx = torch.as_tensor(rng.integers(lo, t, n).astype(np.int32), device=dev)
        upd = torch.as_tensor(rng.normal(size=(n, w)).astype(np.float32), device=dev)
        return idx, upd

    cases = []
    # the shapes and tolerances of tests/test_scatter_pallas.py (unit-normal
    # updates, 8 per row; ~256 per row at T = 64), then a large one held
    # relative to its largest entry
    cases.append(check_scatter("random", *rand(32768, 4096, 16), 4096))
    cases.append(check_scatter("collision_heavy_t64", *rand(16384, 64, 8), 64, tol=2e-4))
    cases.append(check_scatter("replicas_4", *rand(16384, 1024, 16), 1024, replicas=4))
    cases.append(check_scatter("odd_n_1000", *rand(1000, 512, 4), 512))
    cases.append(check_scatter("clamp", *rand(4099, 70, 3, lo=-30), 40, mag_rtol=1e-5))
    cases.append(check_scatter("random_1M", *rand(2 ** 20, 2 ** 16, 16), 2 ** 16, mag_rtol=1e-5))
    hash_idx = (torch.as_tensor(rng.integers(-20, 276, (4096, 3, 8)), device=dev)
                + torch.arange(3, device=dev).view(1, 3, 1) * 256)
    hash_upd = torch.as_tensor(rng.normal(size=(4096 * 24, 2)).astype(np.float32), device=dev)
    cases.append(check_scatter("levels_hash_layout", hash_idx.reshape(-1).to(torch.int32),
                               hash_upd, 256, n_levels=3, trailing=8, mag_rtol=1e-5))
    cases += adversarial_scatter_cases(rng, hash_idx.reshape(-1).to(torch.int32), hash_upd)
    timed = {
        # the kernel's worst case: 2^20 random updates of 2 floats into 64
        # rows, 16,384 per row in no order (no runs to sum in registers)
        "collision_t64": check_scatter("collision_t64", *rand(2 ** 20, 64, 2), 64,
                                       mag_rtol=1e-5, timed=True),
        # the two shapes of examples/probe9_scatter_variants.py (B6)
        "probe9_n131072_w16": check_scatter("probe9_n131072_w16", *rand(131072, 2 ** 15, 16),
                                            2 ** 15, timed=True),
        "probe9_n65536_w32": check_scatter("probe9_n65536_w32", *rand(65536, 2 ** 15, 32),
                                           2 ** 15, timed=True),
    }
    idx, upd, n_levels, trailing, rows = main_step
    timed["main_all_levels"] = check_scatter("main_all_levels", idx, upd, rows, n_levels,
                                             trailing, mag_rtol=1e-5, timed=True)
    for lvl in (0, n_levels - 1):
        li, lu = level_stream(idx, upd, n_levels, trailing, rows, lvl)
        name = f"main_level_{lvl}"
        timed[name] = check_scatter(name, li, lu, rows, 1, trailing, mag_rtol=1e-5,
                                    timed=True)
        timed[name]["distinct_rows"] = int(torch.unique(li).numel())
    # B4's forward is the library's row gather itself (``index_select``), at
    # the main step's shapes: the table's rows read at the step's indices
    table = torch.randn((n_levels * rows, upd.shape[1]), device=dev)
    gidx = idx.clamp(0, n_levels * rows - 1)

    def gather():
        return table.index_select(0, gidx)

    fwd = {"n": int(gidx.shape[0]), "w": int(upd.shape[1]), "rows": n_levels * rows,
           "ms": cuda_ms(gather, reps=50)}
    # the gather is one kernel a call, whatever its name: each device
    # activity counts as a call
    profiled(fwd, "device_ms", gather, 20, "", "")
    # the indices (4 B) read and the rows written once, the table read once
    n_g, w_g = gidx.shape[0], upd.shape[1]
    byte_s = (n_g * (4 + w_g * 4) + min(n_g, n_levels * rows) * w_g * 4) / PEAK_BYTES_PER_S
    fwd["bound_ms"], fwd["bound_by"] = byte_s * 1e3, "bytes"
    timed["b4_forward_index_select"] = fwd
    del table, gidx
    idx, upd, n_levels, trailing, rows = fast_step
    timed["fast_all_levels"] = check_scatter("fast_all_levels", idx, upd, rows, n_levels,
                                             trailing, mag_rtol=1e-5, timed=True)
    emit({"phase": "kernel_scatter", "cases": cases, "timed": timed})
    return timed


def phase_kernel_coarse_occ(b5_inputs):
    import torch

    from instance_nerf_tpu_torch.kernels.coarse_occ_cuda import (
        coarse_occ_lookup,
        coarse_occ_lookup_plain,
    )
    from instance_nerf_tpu_torch.models.render import (
        OccupancyGrid,
        coarse_grid,
        coarse_occupancy_mxu,
    )

    cells, xyz_c, cr, occs = b5_inputs
    rng = np.random.default_rng(6)
    # fine cells occupied with p such that 30% of the coarse cells are
    res = occs["path_grid"].res
    p_fine = 1.0 - 0.7 ** (1.0 / (res // cr) ** 3)
    fine = np.where(rng.uniform(size=(res,) * 3) < p_fine, 1.0, 0.0)
    occs["random_30pct"] = OccupancyGrid(torch.as_tensor(fine, dtype=torch.float32,
                                                         device="cuda"), 0.01)
    cases = {}
    for name, occ in occs.items():
        grid = coarse_grid(occ, cr)
        got = coarse_occ_lookup(cells, grid)
        want = coarse_occ_lookup_plain(cells, grid)
        mxu = coarse_occupancy_mxu(occ, xyz_c, cr).reshape(-1)
        # no block-multiple contract: N = 1, N = 1001, and cells sliced off
        # their 16-byte boundary (each of the three offsets)
        parts = {"n1": (cells[:1], want[:1]), "n1001": (cells[:1001], want[:1001])}
        parts.update({f"slice_{k}": (cells[k:], want[k:]) for k in (1, 2, 3)})
        r_grid = grid.shape[0]
        wild = cells[:4099].clone()  # cells outside the grid on every side
        wild[::7, 0] = -1
        wild[3::11, 2] = r_grid
        wild[5::13, 1] = r_grid + 7
        parts["outside"] = (wild, coarse_occ_lookup_plain(wild, grid))
        mismatches = int((got != want).sum()) + int((got != mxu).sum())
        part_mismatches = {}
        for k, (c, w) in parts.items():
            part_mismatches[k] = int((coarse_occ_lookup(c, grid) != w).sum())
        mismatches += sum(part_mismatches.values())
        torch.cuda.synchronize()
        cases[name] = {"grid_occupied_share": float(grid.float().mean()),
                       "samples_occupied_share": float(got.mean()), "mismatches": mismatches,
                       "mismatches_by_part": part_mismatches}
        if mismatches:
            raise AssertionError(f"coarse_occ kernel disagrees on {name}: {cases[name]}")
    grid = coarse_grid(occs["field_density"], cr)
    n, r = int(cells.shape[0]), int(grid.shape[0])
    cl = cells.long()
    byte_s = (n * 12 + r ** 3 + n * 4) / PEAK_BYTES_PER_S

    def kernel():
        return coarse_occ_lookup(cells, grid)

    def library():
        return grid[cl[:, 0], cl[:, 1], cl[:, 2]]

    timing = {
        "ms": cuda_ms(kernel, reps=100),
        "plain_ms": cuda_ms(lambda: coarse_occ_lookup_plain(cells, grid), reps=20),
        "library_ms": cuda_ms(library, reps=100),
        "renderer_ms": cuda_ms(lambda: coarse_occupancy_mxu(occs["field_density"], xyz_c, cr),
                               reps=20),
        "bound_ms": byte_s * 1e3, "bound_by": "bytes",
    }
    profiled(timing, "device_ms", kernel, 50, "coarse_occ_kernel", "coarse_occ_kernel")
    profiled(timing, "call_device_ms", kernel, 50, "coarse_occ_kernel")
    profiled(timing, "library_device_ms", library, 50, "index_elementwise")
    emit({"phase": "kernel_coarse_occ", "n": n, "coarse_res": r, "grids": cases, **timing})
    return {"n": n, "coarse_res": r, **timing}


def phase_small_reference_field():
    """f32 on the card against the port's CPU run: the same seeded weights,
    rays, draws and random occupancy; rgb -> instance -> rgb."""
    import torch

    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.models.render import OccupancyGrid
    from instance_nerf_tpu_torch.train.ngp_trainer import (
        InstanceFieldTrainer,
        NGPConfig,
        rays_multi,
    )

    cfg = NGPConfig(n_levels=4, table_size=2 ** 12, max_res=64, hidden=16, num_instances=5,
                    n_rays=256, n_samples=32, k_occupied=8, occ_res=16, pallas_grad=True)
    scene, _ = make_synthetic_nerf_scene(np.random.default_rng(0), n_views=4, hw=(24, 24),
                                         n_blobs=2)
    occ = np.where(np.random.default_rng(1).uniform(size=(16,) * 3) < 0.5, 1e3, 0.0)
    rng = np.random.default_rng(2)
    batches = [(*scene.ray_batch(rng, cfg.n_rays), rng.uniform(size=(cfg.n_rays, 32)))
               for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        tr = InstanceFieldTrainer(cfg, seed=1, device=device)
        tr.occ = OccupancyGrid(torch.as_tensor(occ, dtype=torch.float32, device=device), 0.01)
        poses = torch.as_tensor(scene.poses, device=device)
        losses, grads = [], []
        for stage, (v, pix, rgb, inst, draw) in zip(("rgb", "instance", "rgb"), batches):
            o, d = rays_multi(poses, v, pix, scene)
            l, g = tr.loss_and_grads(stage, o, d, rgb, inst,
                                     jitter=torch.as_tensor(draw, dtype=torch.float32,
                                                            device=device))
            tr.apply_grads(stage, g)
            losses.append({k: float(x) for k, x in l.items()})
            grads.append({k: x.cpu() for k, x in g.items() if x is not None})
        runs[device] = (losses, grads, {k: v.detach().cpu() for k, v in tr.params.items()})
    (lc, gc, pc), (lp, gp, pp) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(lc, lp) for k in b)
    grad_err = max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
                   for a, b in zip(gc, gp) for k in b)
    diff = {k: (pc[k] - pp[k]).abs() for k in pp}
    off = sum(int((v > 1e-6).sum()) for v in diff.values())
    total = sum(v.numel() for v in diff.values())
    report = {"phase": "small_reference_field", "dtype": "float32",
              "max_rel_loss_err": loss_err, "max_grad_err_rel_to_largest": grad_err,
              "params_off_by_more_than_1e-6": off, "params_total": total,
              "params_max_abs_diff": max(float(v.max()) for v in diff.values())}
    emit(report)
    if loss_err > 1e-5 or grad_err > 1e-4 or off > 1e-3 * total:
        raise AssertionError(f"f32 card field disagrees with the CPU run: {report}")


# the field CLI's scene and the fleet's: synthetic scenes written to disk
FIELD_CLI_STEPS = {"rgb": 64, "instance": 32, "fast": 64}
FIELD_CLI_FLAGS = []  # the JAX CLI's defaults
FIELD_CLI_RESOLUTION = 160  # extract_features
FLEET_B = 32
FLEET_SCENE = dict(n_views=14, hw=(64, 64), n_blobs=2)
FLEET_STEPS = {"rgb": 64, "instance": 32, "bench": 32}
FLEET_FLAGS = []  # run_fleet's defaults
FLEET_REF = dict(n_levels=2, table_size=2 ** 10, n_features=4, base_res=8, max_res=64,
                 dense_res=4, dense_features=2, hidden=16, num_instances=4, n_rays=128,
                 n_samples=16, k_occupied=6, occ_res=16, occ_coarse_res=8, dtype="float32",
                 pallas_grad=True)
PROJECT_GRID, PROJECT_VIEWS, PROJECT_HW = 96, 8, (128, 128)


def _ckpt_params(path):
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    state, _ = CheckpointManager(path).restore_any(map_location="cpu")
    return state["params"]


def _moved(before, after):
    import torch

    return sorted(k for k in before if not torch.equal(before[k], after[k]))


def _view_psnr(render_dir, scene) -> float:
    from instance_nerf_tpu_torch.data.png import read_png

    img = read_png(f"{render_dir}/rgb_000.png").astype(np.float32) / 255.0
    return psnr(img, scene.images[0])


def phase_field_cli(work):
    """The field CLI's main path at the JAX CLI's defaults with
    ``--pallas_grad``: train (B3 once a step), train_instance from masks
    (only ``inst_*`` moves), render (the PSNR of view 0 rises), extract_features
    at 160^3, benchmark; then ``--preset tpu_fast --k_buckets auto`` (B3
    once a step, its ladder chosen after warm-up), a checkpoint restored
    bit-identical, and one tpu_fast step's B3 launch on the chosen ladder
    against the plain scatter, timed."""
    import torch

    from instance_nerf_tpu_torch.cli import run_instance_field as cli
    from instance_nerf_tpu_torch.data.nerf_dataset import (
        load_nerf_scene,
        make_synthetic_nerf_scene,
        write_nerf_scene,
    )
    from instance_nerf_tpu_torch.kernels import scatter_cuda

    scene, _ = make_synthetic_nerf_scene(np.random.default_rng(0), device="cuda",
                                         **FIELD_SCENE)
    root = write_nerf_scene(f"{work}/field_scene", scene)
    base = ["--scene", root, "--log_every", "0", "--pallas_grad"] + FIELD_CLI_FLAGS
    out = {"scene": FIELD_SCENE}
    t0 = time.perf_counter()
    cli.main(["--mode", "render", "--save_path", f"{work}/render0"] + base)
    psnr0 = _view_psnr(f"{work}/render0", scene)

    # the main path: counts zeroed just before, read just after
    zero_launches()
    t1 = time.perf_counter()
    m_rgb = cli.main(["--mode", "train", "--steps", str(FIELD_CLI_STEPS["rgb"]),
                      "--save_path", f"{work}/field_rgb"] + base)
    torch.cuda.synchronize()
    out["train_rgb_s"] = time.perf_counter() - t1
    out["launches_rgb"] = read_launches()
    if out["launches_rgb"]["scatter_add"] != FIELD_CLI_STEPS["rgb"]:
        raise AssertionError(f"field_cli: B3 launched {out['launches_rgb']} in "
                             f"{FIELD_CLI_STEPS['rgb']} rgb steps")
    zero_launches()
    m_inst = cli.main(["--mode", "train_instance", "--steps", str(FIELD_CLI_STEPS["instance"]),
                       "--masks_dir", f"{root}/masks", "--checkpoint", f"{work}/field_rgb",
                       "--save_path", f"{work}/field_inst"] + base)
    out["launches_instance"] = read_launches()
    moved = _moved(_ckpt_params(f"{work}/field_rgb"), _ckpt_params(f"{work}/field_inst"))
    if not moved or any(not k.startswith("inst_") for k in moved):
        raise AssertionError(f"field_cli: the instance stage moved {moved}")
    cli.main(["--mode", "render", "--checkpoint", f"{work}/field_inst", "--save_path",
              f"{work}/render1"] + base)
    psnr1 = _view_psnr(f"{work}/render1", scene)
    if not psnr1 > psnr0:
        raise AssertionError(f"field_cli: PSNR did not rise ({psnr0} -> {psnr1})")
    inst_map = np.load(f"{work}/render1/instance_000.npy")
    feats = cli.main(["--mode", "extract_features", "--checkpoint", f"{work}/field_inst",
                      "--resolution", str(FIELD_CLI_RESOLUTION), "--out_features",
                      f"{work}/feats.npz"] + base)
    with np.load(f"{work}/feats.npz") as z:
        grid = z["rgbsigma"]
    if grid.shape != (FIELD_CLI_RESOLUTION,) * 3 + (4,) or not np.isfinite(grid).all():
        raise AssertionError(f"field_cli: features {grid.shape}, finite "
                             f"{np.isfinite(grid).all()}")
    bench = cli.main(["--mode", "benchmark"] + base)
    if not all(np.isfinite(v) for v in (*m_rgb.values(), *m_inst.values())):
        raise AssertionError(f"field_cli: non-finite losses {m_rgb} {m_inst}")
    out.update(losses_rgb=m_rgb, losses_instance=m_inst, moved_in_instance_stage=moved,
               psnr_view0_before=psnr0, psnr_view0_after=psnr1,
               instance_ids_view0=sorted(int(i) for i in np.unique(inst_map)),
               features=feats["shape"], benchmark=bench)

    # tpu_fast with the ladder measured after warm-up
    fast = ["--preset", "tpu_fast", "--k_buckets", "auto"] + base
    zero_launches()
    m_fast = cli.main(["--mode", "train", "--steps", str(FIELD_CLI_STEPS["fast"]),
                       "--save_path", f"{work}/field_fast"] + fast)
    out["launches_fast"] = read_launches()
    if out["launches_fast"]["scatter_add"] != FIELD_CLI_STEPS["fast"]:
        raise AssertionError(f"field_cli: B3 launched {out['launches_fast']} in "
                             f"{FIELD_CLI_STEPS['fast']} tpu_fast rgb steps")
    ladder = [(float(f), int(k)) for f, k in
              (p.split(":") for p in m_fast["k_buckets_auto"].split(","))]
    args = cli.parse_with_provenance(fast)
    if abs(sum(f for f, _ in ladder) - 1.0) > 1e-6 or any(
            k > cli.make_config(args).n_samples for _, k in ladder):
        raise AssertionError(f"field_cli: bad ladder {ladder}")
    a, b = cli.make_trainer(args), cli.make_trainer(args)
    cli.load_state(a, f"{work}/field_fast")
    cli.save_state(a, f"{work}/field_fast2", args)
    cli.load_state(b, f"{work}/field_fast2")
    same = all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    if not (same and torch.equal(a.occ.grid, b.occ.grid)):
        raise AssertionError("field_cli: a checkpoint did not restore bit-identical")
    # one tpu_fast rgb step on the chosen ladder: its B3 launch against the plain scatter
    a.set_sampling(k_buckets=tuple(ladder))
    sc = load_nerf_scene(root, args.transforms, downscale=args.downscale)
    o, d, rgb, inst = a._batch(sc, torch.as_tensor(sc.poses, device="cuda"))
    with LaunchRecorder() as rec:
        _, grads = a.loss_and_grads("rgb", o, d, rgb, inst)
    idx, upd, n_levels, trailing, rows, kout = rec.calls[0]
    g = grads["brick_table"].reshape(kout.shape)
    plain = scatter_cuda.level_scatter_add_plain(idx, upd, n_levels, trailing, rows)
    g_err, g_scale = float((g - plain).abs().max()), float(plain.abs().max())
    if len(rec.calls) != 1 or not torch.equal(g, kout) or g_err > 1e-5 * g_scale:
        raise AssertionError(f"field_cli: tpu_fast table gradient differs from the plain "
                             f"scatter by {g_err} (largest {g_scale}; {len(rec.calls)} launches)")
    del grads, g, plain
    out["b3_fast_step"] = check_scatter("field_cli_fast_step", idx, upd, rows, n_levels,
                                        trailing, mag_rtol=1e-5, timed=True)
    out.update(fast_table_grad_vs_plain_max_abs_err=g_err, fast_table_grad_max_abs=g_scale)
    del idx, upd, kout, rec
    bench_fast = cli.main(["--mode", "benchmark"] + fast)
    out.update(losses_fast=m_fast, ladder=ladder, benchmark_fast=bench_fast,
               checkpoint_bit_identical=True, phase_s=time.perf_counter() - t0)
    emit({"phase": "field_cli", **out})
    del a, b
    torch.cuda.empty_cache()
    return out


def _fleet_scenes(work):
    """``FLEET_B`` synthetic scenes from as many seeds, written to disk."""
    from instance_nerf_tpu_torch.data.nerf_dataset import (
        make_synthetic_nerf_scene,
        write_nerf_scene,
    )

    roots, scenes = [], []
    for i in range(FLEET_B):
        sc, _ = make_synthetic_nerf_scene(np.random.default_rng(100 + i), device="cuda",
                                          **FLEET_SCENE)
        roots.append(write_nerf_scene(f"{work}/fleet/scene_{i:03d}", sc))
        scenes.append(sc)
    return roots, scenes


def _fleet_state(tr):
    import torch

    out = {f"p/{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v.clone() for k, v in tr.opt_state[m].items()})
    out["occ"] = tr.occ_grids.clone()
    return out, tr.opt_state["count"]


def _same_state(a, b) -> bool:
    import torch

    return a[1] == b[1] and all(torch.equal(v, b[0][k]) for k, v in a[0].items())


def phase_slice_fleet(work, smi):
    """The B = 32 fleet at run_fleet's defaults with ``--pallas_grad``:
    train (B3 once a step for the whole fleet, a background save midway),
    one step's fleet table gradient against the plain scatter, train_instance
    (only ``inst_*`` moves in every scene), save / restore bit-identical
    (one save in the background while training goes on), ``--mode
    benchmark``; B3 timed on the fleet step's own index stream."""
    import torch

    from instance_nerf_tpu_torch.cli import run_fleet
    from instance_nerf_tpu_torch.kernels import scatter_cuda

    t0 = time.perf_counter()
    roots, scenes = _fleet_scenes(work)
    flags = ["--scenes", f"{work}/fleet/scene_*", "--log_every", "0", "--pallas_grad",
             "--masks_subdir", "masks"] + FLEET_FLAGS
    out = {"B": FLEET_B, "scene": FLEET_SCENE, "write_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t1 = time.perf_counter()
    m_rgb = run_fleet.main(["--mode", "train", "--steps", str(FLEET_STEPS["rgb"]),
                            "--save_every", str(FLEET_STEPS["rgb"] // 2),
                            "--save_path", f"{work}/fleet_rgb"] + flags)
    torch.cuda.synchronize()
    out["train_rgb_s"] = time.perf_counter() - t1
    out["launches_rgb"] = read_launches()
    out["peak_mem_bytes_train"] = int(torch.cuda.max_memory_allocated())
    if out["launches_rgb"]["scatter_add"] != FLEET_STEPS["rgb"]:
        raise AssertionError(f"slice_fleet: B3 launched {out['launches_rgb']} in "
                             f"{FLEET_STEPS['rgb']} fleet steps")
    zero_launches()
    m_inst = run_fleet.main(["--mode", "train_instance", "--steps",
                             str(FLEET_STEPS["instance"]), "--checkpoint", f"{work}/fleet_rgb",
                             "--save_path", f"{work}/fleet_inst"] + flags)
    out["launches_instance"] = read_launches()
    before, after = _ckpt_params(f"{work}/fleet_rgb"), _ckpt_params(f"{work}/fleet_inst")
    moved = _moved(before, after)
    still = [k for k in moved if not all(not torch.equal(before[k][i], after[k][i])
                                         for i in range(FLEET_B))]
    if not moved or any(not k.startswith("inst_") for k in moved) or still:
        raise AssertionError(f"slice_fleet: the instance stage moved {moved} "
                             f"(unmoved in some scene: {still})")
    del before, after

    # the fleet as a trainer: one step's table gradient, save / restore
    args = run_fleet.build_parser().parse_args(["--mode", "train"] + flags)
    tr = run_fleet.make_trainer(args, scenes)
    tr.restore(f"{work}/fleet_inst")
    o, d, rgb, inst = tr._device_batch()
    with LaunchRecorder() as rec:
        _, grads = tr.loss_and_grads("rgb", o, d, rgb, inst)
    idx, upd, n_levels, trailing, rows, kout = rec.calls[0]
    g = grads["brick_table"].reshape(kout.shape)
    plain = scatter_cuda.level_scatter_add_plain(idx, upd, n_levels, trailing, rows)
    g_err, g_scale = float((g - plain).abs().max()), float(plain.abs().max())
    if len(rec.calls) != 1 or not torch.equal(g, kout) or g_err > 1e-5 * g_scale:
        raise AssertionError(f"slice_fleet: fleet table gradient differs from the plain "
                             f"scatter by {g_err} (largest {g_scale}; {len(rec.calls)} launches)")
    del grads, g, plain
    fleet_case = check_scatter("fleet_step", idx, upd, rows, n_levels, trailing,
                               mag_rtol=1e-5, timed=True)
    del idx, upd, kout, rec
    snap = _fleet_state(tr)
    tr.save(f"{work}/fleet_bg", step=1, background=True)
    tr.train(4, stage="rgb", log_every=0)  # moves the live tensors while the thread writes
    tr.wait_for_save()
    if _same_state(snap, _fleet_state(tr)):
        raise AssertionError("slice_fleet: training after the save moved nothing")
    tr.restore(f"{work}/fleet_bg")
    if not _same_state(snap, _fleet_state(tr)):
        raise AssertionError("slice_fleet: the background save is not the call-time state")
    tr.save(f"{work}/fleet_fg", step=2)
    tr.train(2, stage="instance", log_every=0)
    tr.restore(f"{work}/fleet_fg")
    if not _same_state(snap, _fleet_state(tr)):
        raise AssertionError("slice_fleet: save / restore is not bit-identical")
    del tr, snap
    torch.cuda.empty_cache()
    bench = run_fleet.main(["--mode", "benchmark", "--steps", str(FLEET_STEPS["bench"])]
                           + flags)
    tables = FLEET_B * 3 * 2 ** 15 * 32 * 4  # run_fleet's brick tables, f32 bytes
    out.update(losses_rgb=m_rgb, losses_instance=m_inst, moved_in_instance_stage=moved,
               table_grad_vs_plain_max_abs_err=g_err, table_grad_max_abs=g_scale,
               save_restore_bit_identical=True, background_save_call_time=True,
               table_bytes=tables, benchmark=bench, b3_fleet_step=fleet_case, nvidia_smi=smi,
               phase_s=time.perf_counter() - t0)
    emit({"phase": "slice_fleet", **out})
    torch.cuda.empty_cache()
    return out, fleet_case


def phase_small_reference_fleet():
    """A small f32 fleet (B = 3) on the card against the port's CPU run: the
    same seeded weights, numpy rays, uniform draws and random occupancy;
    losses, gradients and params over rgb -> instance -> rgb."""
    import torch

    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer
    from instance_nerf_tpu_torch.train.ngp_trainer import adam_update, fast_ngp_config

    rng = np.random.default_rng(0)
    scenes = [make_synthetic_nerf_scene(rng, n_views=3, hw=(24, 24), n_blobs=2)[0]
              for _ in range(3)]
    cfg = fast_ngp_config(**FLEET_REF)
    occ = np.where(np.random.default_rng(1).uniform(size=(3, 16, 16, 16)) < 0.2, 1e3, 0.0)
    draws = np.random.default_rng(2).uniform(size=(3, 3, cfg.n_rays, cfg.n_samples))
    runs = {}
    for device in ("cuda", "cpu"):
        tr = MultiSceneFieldTrainer(scenes, cfg, seed=1, device=device)
        tr.occ_grids = torch.as_tensor(occ, dtype=torch.float32, device=device)
        losses, grads = [], []
        for i, stage in enumerate(("rgb", "instance", "rgb")):
            l, g = tr.loss_and_grads(stage, *tr._batch(),
                                     jitter=torch.as_tensor(draws[i], dtype=torch.float32,
                                                            device=device))
            adam_update(tr.model, g, tr.opt_state, stage, cfg.lr)
            losses.append({k: v.cpu() for k, v in l.items()})
            grads.append({k: x.cpu() for k, x in g.items() if x is not None})
        runs[device] = (losses, grads, {k: v.detach().cpu()
                                        for k, v in tr.model.state_dict().items()})
    (lc, gc, pc), (lp, gp, pp) = runs["cuda"], runs["cpu"]
    loss_err = max(float(((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-12)).max())
                   for a, b in zip(lc, lp) for k in b)
    by_param = {}
    for a, b in zip(gc, gp):
        for k in b:
            e = float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
            by_param[k] = max(by_param.get(k, 0.0), e)
    # the dense grid's gradient is rounded to bf16 once, after accumulation
    # (the JAX cast's VJP): a summation order of its own can move an entry
    # across a bf16 rounding boundary, one bf16 ulp (at most 2^-7 of it)
    dense_ulps = max(float(((a[k] - b[k]).abs() / (2.0 ** -7 * b[k].abs()).clamp_min(1e-30))
                           .max()) for a, b in zip(gc, gp) for k in b if k == "dense_grid")
    grad_err = max(v for k, v in by_param.items() if k != "dense_grid")
    diff = {k: (pc[k] - pp[k]).abs() for k in pp}
    off = sum(int((v > 1e-5).sum()) for v in diff.values())
    total = sum(v.numel() for v in diff.values())
    report = {"phase": "small_reference_fleet", "B": 3, "dtype": "float32",
              "max_rel_loss_err": loss_err, "max_grad_err_rel_to_largest": grad_err,
              "grad_err_rel_to_largest_by_param": by_param,
              "dense_grid_grad_err_in_bf16_ulps_at_most": dense_ulps,
              "params_off_by_more_than_1e-5": off, "params_total": total,
              "params_max_abs_diff": max(float(v.max()) for v in diff.values())}
    emit(report)
    if loss_err > 1e-5 or grad_err > 1e-5 or dense_ulps > 1.0 or off > 1e-3 * total:
        raise AssertionError(f"f32 card fleet disagrees with the CPU run: {report}")


def phase_project_masks(work):
    """A synthetic voxel instance grid and alpha grid projected into 8 views
    at 128^2 on the card and on the CPU: the id maps equal exactly."""
    import torch

    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.masks2d.project_masks import write_projections

    rng = np.random.default_rng(7)
    scene, boxes = make_synthetic_nerf_scene(rng, n_views=PROJECT_VIEWS, hw=PROJECT_HW,
                                             n_blobs=3, device="cuda")
    g = PROJECT_GRID
    inst = np.zeros((g, g, g), np.int32)
    for k, b in enumerate(boxes * g):
        lo, hi = np.floor(b[:3]).astype(int), np.ceil(b[3:]).astype(int)
        inst[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = k + 1
    alpha = np.where(inst > 0, rng.uniform(0.05, 0.9, inst.shape),
                     rng.uniform(0.0, 0.05, inst.shape)).astype(np.float32)
    times = {}
    for name, device in (("card", "cuda"), ("host", "cpu")):
        t0 = time.perf_counter()
        write_projections(f"{work}/proj_{name}", inst, alpha, scene.poses, scene.intrinsics,
                          scene.hw, device=device)
        times[name] = time.perf_counter() - t0
    files = sorted(os.listdir(f"{work}/proj_card"))
    if files != sorted(os.listdir(f"{work}/proj_host")):
        raise AssertionError("project_masks: the card and the CPU wrote other files")
    bad = [f for f in files if not np.array_equal(np.load(f"{work}/proj_card/{f}"),
                                                  np.load(f"{work}/proj_host/{f}"))]
    ids = [np.load(f"{work}/proj_card/{v:04d}.npy") for v in range(PROJECT_VIEWS)]
    report = {"phase": "project_masks", "grid": g, "views": PROJECT_VIEWS, "hw": PROJECT_HW,
              "files": len(files), "mismatched_files": bad,
              "pixels_with_instance": int(sum((m > 0).sum() for m in ids)),
              "instances_seen": sorted({int(i) for m in ids for i in np.unique(m)} - {0}),
              "card_s": times["card"], "cpu_s": times["host"]}
    emit(report)
    if bad or report["pixels_with_instance"] == 0:
        raise AssertionError(f"project_masks: card and CPU id maps differ: {report}")


# a constant lr at the recipes' peak (3e-4, RCNN 1e-3) makes the fresh RCNN
# heads diverge on one batch; every train loop starts at peak / 25
TRAIN_SCHEDULE_STEPS = 1000
# the training cells: the JAX trainers' defaults at full width, batch 4
TRAIN_CELLS = {
    "fcos_aabb": dict(kind="fcos", rotated=False, shape=(160, 160, 160)),
    "fcos_rotated": dict(kind="fcos", rotated=True, shape=(160, 160, 160)),
    "rpn_rotated": dict(kind="rpn", rotated=True, shape=(200, 200, 130)),
    "rcnn": dict(kind="rcnn", rotated=False, shape=(160, 160, 160)),
    # slice 5b: the Swin and ResNet backbones
    "fcos_aabb_swin_s": dict(kind="fcos", rotated=False, shape=(160, 160, 160),
                             backbone_type="swin_s"),
    "rpn_rotated_resnet": dict(kind="rpn", rotated=True, shape=(200, 200, 130),
                               backbone_type="resnet"),
}


def make_trainer(kind, rotated, device, mesh=None, **cfg):
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer

    if kind == "fcos":
        return FCOSTrainer(FCOSConfig(rotated_bbox=rotated, **cfg), device=device, mesh=mesh)
    if kind == "rpn":
        return RPNTrainer(RPNConfig(rotated_bbox=rotated, **cfg), device=device, mesh=mesh)
    return RCNNTrainer(RCNNConfig(**cfg), device=device, mesh=mesh)


def phase_slice_train(smi):
    """Detector training on the card (main path of slice 5a, and of 5b for
    the Swin and ResNet cells): for each cell, ``benchmark_train_step`` (3
    warm-up and 18 timed steps, CUDA events, on the trainer's synthetic
    batch of 4 scenes, seeded random weights, bf16 compute; the lr of the
    first steps of a 1000-step one-cycle schedule, whose warm-up a train
    loop starts with) and ``profile_train`` (spans forward, loss, backward,
    optimizer; the device's busy share). A cell that does not fit at batch 4
    runs at the largest batch that does (2, then 1), its out-of-memory
    error recorded. Every loss of every step must be finite and ``total``
    after 20 updates on the fixed batch lower than at step 0."""
    import torch

    failed = []
    out = {}
    for name, cell in TRAIN_CELLS.items():
        backbone = cell.get("backbone_type", "vgg_EF")
        oom = []
        for batch in (4, 2, 1):
            tr = make_trainer(cell["kind"], cell["rotated"], "cuda", backbone_type=backbone)
            tr.init_state(total_steps=TRAIN_SCHEDULE_STEPS)
            zero_launches()
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            try:
                bench = tr.benchmark_train_step(reps=18, warmup=3, shape=cell["shape"],
                                                batch=batch)
                prof = tr.profile_train(reps=3, warmup=1, shape=cell["shape"], batch=batch,
                                        top=8)
                break
            except torch.cuda.OutOfMemoryError as e:
                oom.append({"batch": batch,
                            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                            "error": str(e).splitlines()[0][:200]})
                del tr
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"{name}: no batch fits the card: {oom}")
        launches = read_launches()
        losses = bench.pop("losses")
        finite = all(np.isfinite(v) for m in losses for v in m.values())
        first, last = losses[0]["total"], losses[20]["total"]
        line = {"phase": "slice_train", "cell": name, "batch": batch,
                "shape": list(cell["shape"]), "backbone": backbone, "dtype": "bfloat16",
                "out_of_memory": oom, "step_ms_median": bench["median_ms"],
                "step_ms_mean": bench["mean_ms"], "step_ms_min": bench["min_ms"],
                "scenes_per_s": bench["scenes_per_s"], "peak_mem_bytes": bench["peak_mem_bytes"],
                "warmup_s": bench["warmup_s"], "spans_ms": prof["stages_ms_median"],
                "profile_wall_ms": prof["wall_ms_median"],
                "device_busy_share": prof["device_busy_share"],
                "launches_per_step": prof["kernel_launches_per_run"],
                "top_kernels": prof["top_kernels"], "losses_first": losses[0],
                "losses_step20": losses[20], "all_finite": finite,
                "kernel_launches": launches, "seconds": time.perf_counter() - t0,
                "device": bench["device"], "nvidia_smi": smi,
                # FCOS and RCNN: the JAX trainers' model keys (slice 7c)
                **{k: bench[k] for k in ("flops_per_step", "tflops_per_step",
                                         "achieved_tflops", "mfu", "peak_hbm_gib")
                   if k in bench}}
        emit(line)
        out[name] = line
        if not finite:
            failed.append(f"{name}: a loss is not finite")
        if not last < first:
            failed.append(f"{name}: total {last} after 20 steps, {first} at step 0")
        del tr
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _grad_errors(cuda_model, cpu_model):
    """Per parameter, the largest gradient difference over the CPU
    gradient's largest entry; the VGG trunk (backbone but its FPN) apart."""
    above, trunk = {}, {}
    cpu = dict(cpu_model.named_parameters())
    for name, p in cuda_model.named_parameters():
        q = cpu[name]
        if p.grad is None and q.grad is None:
            continue
        err = float((p.grad.cpu() - q.grad).abs().max()) / max(float(q.grad.abs().max()), 1e-30)
        in_trunk = name.startswith("backbone.") and not name.startswith("backbone.fpn.")
        (trunk if in_trunk else above)[name] = err
    return above, trunk


# small_reference_train's backbone: VGG-AF, the VGG-EF of the cells cut in
# depth (8 convs for 16) to keep its CPU side, an f64 step, short
REF_TRAIN_BACKBONE = "vgg_AF"


def phase_small_reference_train():
    """One train step of each trainer on the card against the port's CPU run
    from the same seeded weights, inputs and sampling draws (passed in), on
    a 40x32x24 grid, batch 2, VGG-AF (``REF_TRAIN_BACKBONE``), in f64: the
    losses must agree to 1e-4 relative and every gradient to 1e-4 of its
    tensor's largest entry. In
    f32 (TF32 off) a conv's sums round otherwise on the card, ReLU inputs
    within rounding of 0 fall on either side and the gradients under a
    ReLU chain (the VGG trunk, FCOS's GroupNorm towers, the RPN and mask
    heads) move by up to 1e-1 of their largest entry: one f32 FCOS step
    holds the losses to 1e-4 and reports its gradients' differences."""
    import torch

    from instance_nerf_tpu_torch.train.loop import synthetic_batch
    from instance_nerf_tpu_torch.train.rcnn_trainer import _random_rois

    shape = (40, 32, 24)
    report = {"phase": "small_reference_train", "grid": list(shape), "batch": 2,
              "backbone": REF_TRAIN_BACKBONE,
              "tolerance": {"losses_rel": 1e-4, "grads_of_max_f64": 1e-4}}
    failed = []
    rng = np.random.default_rng(11)
    for name, kind, rotated, dtype in (("fcos_aabb_f32", "fcos", False, "float32"),
                                       ("fcos_aabb", "fcos", False, "float64"),
                                       ("fcos_rotated", "fcos", True, "float64"),
                                       ("rpn_rotated", "rpn", True, "float64"),
                                       ("rpn_aabb", "rpn", False, "float64"),
                                       ("rcnn", "rcnn", False, "float64"),
                                       ("rcnn_frozen", "rcnn", False, "float64")):
        box_dim = 7 if rotated else 6
        if kind == "rcnn":
            grids = rng.uniform(0, 1, (2, *shape, 4)).astype(np.float32)
            gt = np.stack([_random_rois(rng, 24, 6) for _ in range(2)])
            rois = np.concatenate([gt, np.stack([_random_rois(rng, 24, 10) for _ in range(2)])],
                                  1) + rng.normal(0, 1, (2, 16, 6)).astype(np.float32)
            rois[..., 3:] = np.maximum(rois[..., 3:], rois[..., :3] + 1)
            vm = np.zeros((2, 6, *shape), np.uint8)
            for i in range(2):
                for j in range(6):
                    lo, hi = gt[i, j, :3].astype(int), np.ceil(gt[i, j, 3:]).astype(int)
                    vm[i, j, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
            args = [grids, np.tile(np.float32(shape), (2, 1)), rois.astype(np.float32),
                    np.ones((2, 16), bool), gt, rng.integers(1, 11, (2, 6)),
                    np.ones((2, 6), bool), vm]
            extra = {"uniforms": torch.rand((2, 2, 22), generator=torch.Generator().manual_seed(1),
                                            dtype=getattr(torch, dtype))}
            cfg = dict(dtype="float32", resolution=40, batch_size_per_image=64, max_gt=6,
                       max_rois=16, freeze_backbone=name == "rcnn_frozen", seed=5,
                       backbone_type=REF_TRAIN_BACKBONE)
        else:
            grids, sizes, boxes, mask = synthetic_batch(2, shape, 6, box_dim)
            args = [grids, sizes, boxes, mask]
            extra = {}
            cfg = dict(dtype="float32", max_gt=6, seed=5, resolution=40,
                       backbone_type=REF_TRAIN_BACKBONE)
            if kind == "rpn":
                cfg["batch_size_per_mesh"] = 64
        run = {}
        for device in ("cuda", "cpu"):
            tr = make_trainer(kind, rotated, device, **cfg)
            tr.init_state()
            tr.model.to(getattr(torch, dtype))
            t = [torch.as_tensor(a, device=device) for a in args]
            t = [x.to(getattr(torch, dtype)) if x.is_floating_point() else x for x in t]
            kw = {k: v.to(device) for k, v in extra.items()}
            if kind == "rpn":
                n_anchors = sum(a.shape[0] for a in tr.model.anchors(tr.model.features(t[0][:1])))
                kw["uniforms"] = torch.rand((2, 2, n_anchors), dtype=getattr(torch, dtype),
                                            generator=torch.Generator().manual_seed(2)).to(device)
            _, metrics = tr.train_step_fn()(tr.state, *t, **kw)
            run[device] = (tr, {k: float(v) for k, v in metrics.items()})
        (tc, mc), (tp, mp) = run["cuda"], run["cpu"]
        loss_err = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-6) for k in mp)
        above, trunk = _grad_errors(tc.model, tp.model)
        grad_err = max(above.values())
        trunk_err = max(trunk.values()) if trunk else 0.0
        report[name] = {"dtype": dtype, "losses": mp, "max_rel_err_losses": loss_err,
                        "max_grad_err_above_trunk": grad_err, "max_grad_err_trunk": trunk_err,
                        "worst_above_trunk": max(above, key=above.get)}
        if loss_err > 1e-4:
            failed.append(f"{name}: losses differ by {loss_err} relative")
        if dtype == "float64" and max(grad_err, trunk_err) > 1e-4:
            failed.append(f"{name}: gradients differ by {max(grad_err, trunk_err)} of their max")
        del run, tc, tp
        torch.cuda.empty_cache()
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))


def phase_train_loop():
    """``--mode train`` of the three CLIs on the card, chained as a user runs
    them, on a dataset of 4 scenes at 64x64x48 written by ``write_dataset``
    (boxes, and a rotated one): ``run_fcos`` (AABB, then rotated),
    ``run_rpn --rotated_bbox`` and ``run_rcnn`` grafting the AABB FCOS run's
    backbone, each 2 epochs with an eval every epoch (B1 in the AABB evals,
    B2 in the rotated ones: each must launch), then ``run_fcos --resume`` to
    a third epoch, which must start at the saved step. ``keep_checkpoints``
    1: one step directory and ``best/`` must be left. Then ``run_fcos`` and
    ``run_rcnn`` once more with ``--device_data --steps_per_call 4`` at
    batch 1: 4 steps in 2 dispatches, the same checkpoint rule, B1 in their
    evals."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from instance_nerf_tpu_torch.cli import run_fcos, run_rcnn, run_rpn
    from instance_nerf_tpu_torch.data.synthetic import write_dataset
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    report = {"phase": "train_loop", "scenes": 4, "grid": [64, 64, 48]}
    failed = []
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {}
        for kind, rotated in (("aabb", False), ("obb", True)):
            roots[kind] = os.path.join(tmp, kind)
            write_dataset(roots[kind], num_scenes=4, grid_size=(64, 64, 48), seed=0,
                          style="room" if rotated else "boxes", rotated=rotated)
        common = ["--mode", "train", "--num_epochs", "2", "--eval_interval", "1",
                  "--batch_size", "2", "--keep_checkpoints", "1", "--resolution", "64"]

        def proposal(kind):
            root = roots[kind]
            return ["--features_path", os.path.join(root, "features"),
                    "--boxes_path", os.path.join(root, "boxes_obb" if kind == "obb"
                                                 else "metadata"),
                    "--dataset_split", os.path.join(root, "dataset_split.json")]

        def train(name, main, argv, kernel):
            out = os.path.join(tmp, name)
            buf = io.StringIO()
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main(argv + ["--save_path", out])
            seconds = time.perf_counter() - t0
            counts = read_launches()
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            mgr = CheckpointManager(out)
            kept = sorted(os.listdir(out))
            report[name] = {"summary": summary, "seconds": seconds, "launches": counts,
                            "checkpoints": kept}
            launches[name] = counts[kernel]
            if counts[kernel] == 0:
                failed.append(f"{name}: {kernel} was not launched in the evals")
            if mgr.all_steps() != [summary["gstep"]] or "best" not in kept:
                failed.append(f"{name}: checkpoints {kept}, expected one step and best/")
            if not all(np.isfinite(v) for v in summary["last"].values()):
                failed.append(f"{name}: a loss is not finite")
            if name != "fcos_aabb":  # a checkpoint is about 0.9 GB: keep the grafted one
                shutil.rmtree(out)
            return out, summary

        fcos_dir, first = train("fcos_aabb", run_fcos.main, common + proposal("aabb"),
                                "nms_boxes")
        train("fcos_rotated", run_fcos.main, common + proposal("obb") + ["--rotated_bbox"],
              "nms_sweep")
        train("rpn_rotated", run_rpn.main, common + proposal("obb") + ["--rotated_bbox"],
              "nms_sweep")
        train("rcnn", run_rcnn.main, common + ["--dataset_root", roots["aabb"],
                                               "--rpn_ckpt", fcos_dir], "nms_boxes")
        # resume the AABB FCOS run to a third epoch
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_fcos.main(common[:3] + ["3"] + common[4:] + proposal("aabb")
                          + ["--resume", "--save_path", fcos_dir])
        resumed = json.loads(buf.getvalue().strip().splitlines()[-1])
        report["fcos_aabb_resume"] = resumed
        if resumed["start_epoch"] != 2 or resumed["gstep"] != first["gstep"] * 3 // 2:
            failed.append(f"resume started at epoch {resumed['start_epoch']}, "
                          f"step {resumed['gstep']}")
        # the device-resident store and 4 steps a dispatch (slice 5b): batch
        # 1, so each epoch's 2 steps go in one call
        one = common[:common.index("--batch_size") + 1] + ["1"] + common[
            common.index("--batch_size") + 2:]
        for name, main_fn, argv in (
                ("fcos_aabb_device_data", run_fcos.main,
                 one + proposal("aabb") + ["--rot_scale_prob", "0"]),
                ("rcnn_device_data", run_rcnn.main,
                 one + ["--dataset_root", roots["aabb"], "--rpn_ckpt", fcos_dir])):
            _, summary = train(name, main_fn, argv + ["--device_data", "--steps_per_call", "4"],
                               "nms_boxes")
            if (summary["steps"], summary["calls"], summary["gstep"]) != (4, 2, 4):
                failed.append(f"{name}: {summary['steps']} steps in {summary['calls']} "
                              f"calls, global step {summary['gstep']}; expected 4 in 2")
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# -- slice 7a: training over several cards ---------------------------------------

DIST_STEPS = 3  # FCOS steps before the launched params are held to one process's
DIST_FLEET_STEPS = {"train": 16, "bench": 32}
DIST_TIMEOUT_S = 300
# small_reference_dist: a 48x40x36 grid, batch 2, the reference backbone
DIST_REF_SHAPE = (48, 40, 36)
DIST_FIELD = dict(n_levels=4, table_size=2 ** 12, max_res=64, hidden=16, num_instances=5,
                  n_rays=256, n_samples=32, k_occupied=8, occ_res=16, pallas_grad=True)


def launch(nproc, child_args, env=None, timeout=DIST_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py --dist-child ...`` (its own process group, killed
    whole past ``timeout``); raises with the launcher's output if a rank
    fails."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--dist-child",
           *map(str, child_args)]
    with tempfile.TemporaryFile() as log:
        p = subprocess.Popen(cmd, env={**os.environ, **(env or {})}, stdout=log,
                             stderr=subprocess.STDOUT, start_new_session=True)
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        log.seek(0)
        text = log.read().decode(errors="replace")
    if p.returncode != 0:
        raise AssertionError(f"launch {child_args[0]} exited {p.returncode}: {text[-4000:]}")
    return text


class deterministic:
    """cuDNN's deterministic algorithms (and torch's, warning where one has
    none) inside the block: two runs of the same train steps on the card
    agree bit for bit only so (the default wgrad algorithms sum in another
    order from run to run)."""

    def __enter__(self):
        import torch

        self.was = (torch.backends.cudnn.deterministic,
                    torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self.was[0]
        torch.use_deterministic_algorithms(self.was[1])


def _fcos_params_after_steps():
    """The FCOS trainer at the JAX defaults (global batch 4, 160^3, bf16,
    VGG-EF), ``DIST_STEPS`` steps on its synthetic batch in deterministic
    mode (one rank of a launched mesh, or one process): the trainer and its
    params on the host."""
    import torch

    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

    tr = FCOSTrainer(FCOSConfig(), device="cuda")
    tr.init_state(total_steps=TRAIN_SCHEDULE_STEPS)
    run = tr._card_train_step(4, FCOS_GRID)
    with deterministic():
        for _ in range(DIST_STEPS):
            run()
        torch.cuda.synchronize()
    return tr, {k: v.cpu() for k, v in tr.model.state_dict().items()}


def _rank():
    return int(os.environ.get("RANK", 0))


def _write(out, name, obj):
    with open(os.path.join(out, f"{name}.{_rank()}.json"), "w") as f:
        json.dump(obj, f)


def _read(out, name, rank=0):
    with open(os.path.join(out, f"{name}.{rank}.json")) as f:
        return json.load(f)


def child_slice_dist(out, fleet_pattern):
    """One rank of ``slice_dist`` under the launcher: the FCOS step, the
    fleet, the detector CLIs."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from instance_nerf_tpu_torch.parallel.mesh import buckets
    from instance_nerf_tpu_torch.parallel.train_step import gradient_bytes

    # the FCOS step at the JAX trainer's defaults: 3 steps, then the timing
    tr, params = _fcos_params_after_steps()
    backend, world = dist.get_backend(), dist.get_world_size()
    if _rank() == 0:
        torch.save(params, os.path.join(out, "fcos_params.pt"))
    del params
    bench = tr.benchmark_train_step(reps=18, warmup=3)
    prof = tr.profile_train(reps=5, warmup=2)
    _write(out, "fcos_step", {
        "backend": backend, "world": world, "mesh": repr(tr.mesh), "device": str(tr.device),
        "step_ms": bench["median_ms"], "step_ms_mean": bench["mean_ms"],
        "scenes_per_s": bench["scenes_per_s"], "peak_mem_bytes": bench["peak_mem_bytes"],
        "losses_last": bench["losses"][-1], "allreduce_ms": prof["stages_ms_median"].get(
            "allreduce"), "stages_ms": prof["stages_ms_median"],
        "busy_share": prof["device_busy_share"], "gradient_bytes": gradient_bytes(tr.state),
        # NCCL calls a step: the gradients' buckets, the metrics after them
        "allreduce_calls": len(buckets([p.numel() for p in tr.state.tx.params]
                                       + [1] * len(bench["losses"][-1]))),
        "losses_finite": all(np.isfinite(v) for m in bench["losses"] for v in m.values())})
    del tr
    torch.cuda.empty_cache()

    # the fleet at run_fleet's defaults split over the ranks
    from instance_nerf_tpu_torch.cli import run_fleet

    args = run_fleet.build_parser().parse_args(
        ["--scenes", fleet_pattern, "--pallas_grad", "--log_every", "0"] + FLEET_FLAGS)
    _, scenes = run_fleet.load_scenes(args)
    fl = run_fleet.make_trainer(args, scenes)
    zero_launches()
    t0 = time.perf_counter()
    fl.train(DIST_FLEET_STEPS["train"], log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    fl.save(os.path.join(out, "fleet_ckpt"), step=DIST_FLEET_STEPS["train"])
    state, count = _fleet_state(fl)
    torch.save({"state": {k: v.cpu() for k, v in state.items()}, "count": count,
                "scenes": [fl._sl.start, fl._sl.stop]},
               os.path.join(out, f"fleet_block.{_rank()}.pt"))
    bench = fl.benchmark(steps=DIST_FLEET_STEPS["bench"])
    # the benchmark trained on: restored on the ranks, each block is the saved one
    fl.restore(os.path.join(out, "fleet_ckpt"))
    restored = _same_state(_fleet_state(fl), (state, count))
    _write(out, "fleet", {"launches": launches, "train_s": train_s, "mesh": repr(fl.mesh),
                          "scenes": [fl._sl.start, fl._sl.stop], "benchmark": bench,
                          "restored_on_ranks_bit_identical": restored})
    del fl, scenes, state
    torch.cuda.empty_cache()

    # the detector CLIs' train mode: FCOS AABB (B1 in rank 0's evals), its
    # resume, the rotated RPN (B2)
    from instance_nerf_tpu_torch.cli import run_fcos, run_rpn
    from instance_nerf_tpu_torch.data.synthetic import write_dataset

    roots = {}
    for kind, rotated in (("aabb", False), ("obb", True)):
        roots[kind] = os.path.join(out, f"data_{kind}")
        if _rank() == 0:
            write_dataset(roots[kind], num_scenes=4, grid_size=(64, 64, 48), seed=0,
                          style="room" if rotated else "boxes", rotated=rotated)
    dist.barrier()
    common = ["--mode", "train", "--eval_interval", "1", "--batch_size", "2",
              "--keep_checkpoints", "1", "--resolution", "64"]

    def proposal(kind):
        root = roots[kind]
        return ["--features_path", os.path.join(root, "features"),
                "--boxes_path", os.path.join(root, "boxes_obb" if kind == "obb" else "metadata"),
                "--dataset_split", os.path.join(root, "dataset_split.json")]

    clis = {}
    for name, main_fn, argv in (
            ("fcos_aabb", run_fcos.main, common + ["--num_epochs", "2"] + proposal("aabb")),
            ("fcos_aabb_resume", run_fcos.main,
             common + ["--num_epochs", "3", "--resume"] + proposal("aabb")),
            ("rpn_rotated", run_rpn.main,
             common + ["--num_epochs", "2", "--rotated_bbox"] + proposal("obb"))):
        save = os.path.join(out, "fcos_aabb" if name.startswith("fcos") else name)
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main_fn(argv + ["--save_path", save])
        # rank 0 prints the run's summary last; every rank logs to stdout
        clis[name] = {"launches": read_launches(), "seconds": time.perf_counter() - t0,
                      "summary": (json.loads(buf.getvalue().strip().splitlines()[-1])
                                  if _rank() == 0 else None),
                      "checkpoints": sorted(os.listdir(save))}
        dist.barrier()
    _write(out, "clis", clis)


def phase_slice_dist(work, smi):
    """Main path of slice 7a: training over every visible card
    (``torch.cuda.device_count()`` ranks of ``torch.distributed.run``, NCCL).
    FCOS AABB at the JAX trainer's defaults (global batch 4, 160^3, bf16,
    VGG-EF): after 3 steps in deterministic mode (``deterministic``) the
    launched params must equal this process's one-process trainer's bit for
    bit with one rank; 18 timed steps (ms,
    global scenes/s, peak bytes), the ``allreduce`` span and the gradient
    bytes it moves. The B = 32 fleet at run_fleet's defaults with
    ``--pallas_grad`` split over the ranks: B3 once per rank per step,
    aggregate rays/s, saved on the ranks and restored bit-identical here in
    one process and on the ranks (after the benchmark trained on). ``run_fcos --mode train`` (2 epochs, B1 in rank 0's evals,
    one checkpoint and ``best/``), ``--resume`` to a third epoch, and
    ``run_rpn --rotated_bbox --mode train`` (B2 in rank 0's evals)."""
    import torch

    from instance_nerf_tpu_torch.cli import run_fleet

    n = torch.cuda.device_count()
    out = os.path.join(work, "dist")
    os.makedirs(out)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch(n, ["slice_dist", out, f"{work}/fleet/scene_*"])
    report = {"phase": "slice_dist", "ranks": n, "launch_s": time.perf_counter() - t0,
              "nvidia_smi": smi}
    failed = []
    step = _read(out, "fcos_step")
    report["fcos_step"] = step
    if step["backend"] != "nccl" or step["world"] != n:
        failed.append(f"fcos: backend {step['backend']} over {step['world']} ranks")
    if not step["losses_finite"] or step["allreduce_ms"] is None:
        failed.append("fcos: a loss is not finite, or no allreduce span")
    # the one-process trainer, the same seeded weights, batch and settings
    tr, params = _fcos_params_after_steps()
    launched = torch.load(os.path.join(out, "fcos_params.pt"), weights_only=True)
    report["fcos_params_max_abs_diff"] = max(
        float((v.float() - launched[k].float()).abs().max()) for k, v in params.items())
    report["fcos_params_bitwise"] = all(torch.equal(v, launched[k]) for k, v in params.items())
    if n == 1 and not report["fcos_params_bitwise"]:
        failed.append(f"fcos: one rank's params differ from one process's by "
                      f"{report['fcos_params_max_abs_diff']}")
    del tr, params, launched
    torch.cuda.empty_cache()

    fleet = [_read(out, "fleet", r) for r in range(n)]
    report["fleet"] = fleet[0]
    report["fleet_aggregate_rays_per_s"] = fleet[0]["benchmark"]["aggregate_rays_per_s"]
    for r, f in enumerate(fleet):
        if not f["restored_on_ranks_bit_identical"]:
            failed.append(f"fleet rank {r}: its block restored on the ranks differs from "
                          f"the saved one")
        if f["launches"]["scatter_add"] != DIST_FLEET_STEPS["train"]:
            failed.append(f"fleet rank {r}: B3 launched {f['launches']['scatter_add']} times "
                          f"in {DIST_FLEET_STEPS['train']} steps")
    args = run_fleet.build_parser().parse_args(
        ["--scenes", f"{work}/fleet/scene_*", "--pallas_grad", "--log_every", "0"] + FLEET_FLAGS)
    _, scenes = run_fleet.load_scenes(args)
    one = run_fleet.make_trainer(args, scenes)
    meta = one.restore(os.path.join(out, "fleet_ckpt"))
    state, count = _fleet_state(one)
    same = count == DIST_FLEET_STEPS["train"] == meta["step"]
    for r in range(n):
        blk = torch.load(os.path.join(out, f"fleet_block.{r}.pt"), weights_only=True)
        s0, s1 = blk["scenes"]
        same &= blk["count"] == count and all(torch.equal(v[s0:s1].cpu(), blk["state"][k])
                                               for k, v in state.items())
    report["fleet_restored_bit_identical"] = bool(same)
    if not same:
        failed.append("fleet: the state restored in one process differs from the ranks'")
    del one, state, scenes
    torch.cuda.empty_cache()

    clis = _read(out, "clis")
    report["clis"] = clis
    launches = {"fcos_aabb": clis["fcos_aabb"]["launches"]["nms_boxes"],
                "fcos_aabb_resume": clis["fcos_aabb_resume"]["launches"]["nms_boxes"],
                "rpn_rotated": clis["rpn_rotated"]["launches"]["nms_sweep"]}
    for name, c in launches.items():
        if c == 0:
            failed.append(f"{name}: its kernel was not launched in rank 0's evals")
    first, resumed = clis["fcos_aabb"]["summary"], clis["fcos_aabb_resume"]["summary"]
    if resumed["start_epoch"] != 2 or resumed["gstep"] != first["gstep"] * 3 // 2:
        failed.append(f"resume started at epoch {resumed['start_epoch']}, step "
                      f"{resumed['gstep']}")
    for name in ("fcos_aabb", "rpn_rotated"):
        kept = clis[name]["checkpoints"]
        if len([k for k in kept if k.startswith("step_")]) != 1 or "best" not in kept:
            failed.append(f"{name}: checkpoints {kept}")
    report["launches_dist_train_loop"] = launches
    report["phase_s"] = time.perf_counter() - t0
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))
    return report


def _capture_grads(tx):
    """The gradients (by name) each optimizer step is given."""
    seen = []
    step = tx.step

    def wrapped(grads=None):
        g = grads if grads is not None else [
            p.grad if p.grad is not None else p.new_zeros(p.shape) for p in tx.params]
        seen.append({n: x.detach().cpu().clone() for n, x in zip(tx.names, g)})
        return step(grads)

    tx.step = wrapped
    return seen


def _ref_runs(mesh=None):
    """small_reference_dist's runs of one process (``mesh`` None) or of one
    rank: {name: (metrics, gradients)} of one step of FCOS AABB, the rotated
    RPN and the RCNN (f32 and f64) on a synthetic global batch of 2, the
    ray-sharded field step (f32), a B = 4 fleet step (f32); and the B3
    launches of the field step."""
    import torch

    from instance_nerf_tpu_torch.data.nerf_dataset import make_synthetic_nerf_scene
    from instance_nerf_tpu_torch.models.render import OccupancyGrid
    from instance_nerf_tpu_torch.parallel.mesh import local_rows
    from instance_nerf_tpu_torch.parallel.ngp_train_step import sharded_ngp_loss_and_grads
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig, build_model, \
        fast_ngp_config, init_ngp_params

    out = {}
    for name, kind, rotated in (("fcos_aabb", "fcos", False), ("rpn_rotated", "rpn", True),
                                ("rcnn", "rcnn", False)):
        for dtype in ("float32", "float64"):
            cfg = dict(dtype="float32", max_gt=6, seed=5, resolution=48,
                       backbone_type=REF_TRAIN_BACKBONE)
            if kind == "rpn":
                cfg["batch_size_per_mesh"] = 64
            if kind == "rcnn":
                cfg.update(batch_size_per_image=64, max_rois=16)
            tr = make_trainer(kind, rotated, "cuda", mesh=mesh, batch_size=2, **cfg)
            tr.init_state()
            tr.model.to(getattr(torch, dtype))
            if dtype == "float64":  # the synthetic batch's floats too
                loader = tr._card_train_batch
                tr._card_train_batch = lambda *a, f=loader: tuple(
                    x.double() if x.is_floating_point() else x for x in f(*a))
            seen = _capture_grads(tr.state.tx)
            metrics = tr._card_train_step(2, DIST_REF_SHAPE)()
            out[f"{name}/{dtype}"] = ({k: float(v) for k, v in metrics.items()}, seen[0])
            del tr
            torch.cuda.empty_cache()
    # the ray-sharded field step, unstratified
    cfg = NGPConfig(**DIST_FIELD)
    model = build_model(cfg)
    init_ngp_params(model, 3)
    model.to("cuda")
    rng = np.random.default_rng(4)
    r = cfg.n_rays
    o = np.concatenate([rng.uniform(0.1, 0.9, (r, 2)), np.full((r, 1), -0.3)], -1)
    d = np.concatenate([rng.normal(0, 0.2, (r, 2)), np.ones((r, 1))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [o.astype(np.float32), d.astype(np.float32),
            rng.uniform(0, 1, (r, 3)).astype(np.float32),
            rng.integers(-1, cfg.num_instances, r).astype(np.int32)]
    if mesh is not None:
        rays = local_rows(mesh, rays)
    occ = OccupancyGrid(torch.as_tensor(np.where(rng.uniform(size=(16,) * 3) < 0.4, 1e3, 0.0),
                                        dtype=torch.float32, device="cuda"), cfg.occ_threshold)
    zero_launches()
    m, g = sharded_ngp_loss_and_grads(model, cfg, "instance", occ,
                                      *(torch.as_tensor(a, device="cuda") for a in rays),
                                      group=None if mesh is None else mesh.data_group,
                                      stratified=False)
    torch.cuda.synchronize()
    field_launches = read_launches()["scatter_add"]
    out["field"] = ({k: float(v) for k, v in m.items()},
                    {k: v.cpu() for k, v in g.items() if v is not None})
    # a B = 4 fleet: one step's per-scene losses and this rank's gradients
    srng = np.random.default_rng(0)
    scenes = [make_synthetic_nerf_scene(srng, n_views=3, hw=(24, 24), n_blobs=2)[0]
              for _ in range(4)]
    fl = MultiSceneFieldTrainer(scenes, fast_ngp_config(**FLEET_REF), seed=1, device="cuda")
    fl.occ_grids = torch.as_tensor(
        np.where(np.random.default_rng(1).uniform(size=(4, 16, 16, 16)) < 0.2, 1e3,
                 0.0)[fl._sl], dtype=torch.float32, device="cuda")
    losses, grads = fl.loss_and_grads("rgb", *fl._batch())
    out["fleet"] = ({k: v.cpu() for k, v in losses.items()},
                    {k: v.cpu() for k, v in grads.items() if v is not None},
                    [fl._sl.start, fl._sl.stop])
    return out, field_launches


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)


def _compare_ref(one: dict, mine: dict) -> tuple:
    """small_reference_dist's comparisons of one rank's runs against the
    one-process runs (the detectors' and the field's where ``one`` holds
    them, the fleet's on this rank's scenes): (report, failures)."""
    report, failed = {}, []
    for name in [k for k in one if "/" in k]:
        (m1, g1), (m2, g2) = one[name], mine[name]
        loss_err = max(abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-6) for k in m1)
        errs = {k: _rel(g2[k], g1[k]) for k in g1}
        report[name] = {"max_rel_err_losses": loss_err, "max_grad_err": max(errs.values()),
                        "worst": max(errs, key=errs.get)}
        if loss_err > 1e-5 or (name.endswith("float64") and max(errs.values()) > 1e-5):
            failed.append(f"{name}: {report[name]}")
    if "field" in one:
        (m1, g1), (m2, g2) = one["field"], mine["field"]
        loss_err = max(abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-6) for k in m1)
        grad_err = max(_rel(g2[k], g1[k]) for k in g1)
        report["field"] = {"max_rel_err_losses": loss_err, "max_grad_err": grad_err}
        if loss_err > 1e-5 or grad_err > 1e-5:
            failed.append(f"field: {report['field']}")
    (l1, g1, _), (l2, g2, (s0, s1)) = one["fleet"], mine["fleet"]
    l_err = max(float(((l2[k] - l1[k][s0:s1]).abs() / l1[k][s0:s1].abs().clamp_min(1e-12)).max())
                for k in l1)
    f_err, dense_ulps = 0.0, 0.0
    for k in g1:
        if k == "dense_grid":  # rounded to bf16 once, after accumulation
            dense_ulps = float(((g2[k] - g1[k][s0:s1]).abs() / (
                2.0 ** -7 * g1[k][s0:s1].abs()).clamp_min(1e-30)).max())
        else:
            f_err = max(f_err, _rel(g2[k], g1[k][s0:s1]))
    report["fleet"] = {"scenes": [s0, s1], "max_rel_err_losses": l_err, "max_grad_err": f_err,
                       "dense_grid_err_in_bf16_ulps_at_most": dense_ulps}
    if l_err > 1e-5 or f_err > 1e-5 or dense_ulps > 1.0:
        failed.append(f"fleet: {report['fleet']}")
    return report, failed


def child_small_reference_dist(out):
    import torch

    from instance_nerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=2, backend="gloo", device="cuda")
    runs, launches = _ref_runs(mesh)
    one = torch.load(os.path.join(out, "one_field.pt"), weights_only=False)
    if _rank() == 0:  # the detectors' and the field's gradients are the same on every rank
        one.update(torch.load(os.path.join(out, "one_detectors.pt"), weights_only=False))
    else:
        one = {"fleet": one["fleet"]}
    report, failed = _compare_ref(one, runs)
    _write(out, "ref", {"report": report, "failed": failed, "field_b3_launches": launches,
                        "backend": torch.distributed.get_backend()})


def phase_small_reference_dist(work):
    """2 ranks on the one card over gloo (named here: NCCL takes one rank a
    card) against this process's one-process card run on the same global
    inputs: one step of FCOS AABB, the rotated RPN and the RCNN at
    48x40x36, batch 2 (one scene a rank), VGG-AF; the ray-sharded field step
    (instance stage, unstratified, ``pallas_grad``: B3 once a rank); a B = 4
    fleet step (two scenes a rank). Every gradient to 1e-5 of its largest
    entry: the detectors' in f64 (in f32 a rank's conv of one scene rounds
    otherwise than a conv of two, and ReLU inputs within rounding of 0 flip
    under the VGG trunk, as ``small_reference_train`` says; their f32
    losses are held to 1e-5 and their f32 gradients reported), the field's
    and the fleet's in f32 (the fleet's dense grid, rounded to bf16 by
    design, to one bf16 ulp). The one-process runs go first, to files the
    ranks compare against."""
    import torch

    out = os.path.join(work, "dist_ref")
    os.makedirs(out)
    t0 = time.perf_counter()
    one, _ = _ref_runs(None)
    torch.save({k: one[k] for k in ("field", "fleet")}, os.path.join(out, "one_field.pt"))
    torch.save({k: v for k, v in one.items() if "/" in k},
               os.path.join(out, "one_detectors.pt"))
    del one
    torch.cuda.empty_cache()
    launch(2, ["small_reference_dist", out])
    ranks = [_read(out, "ref", r) for r in (0, 1)]
    report = {"phase": "small_reference_dist", "ranks": 2, "backend": ranks[0]["backend"],
              "field_b3_launches_per_rank": [r["field_b3_launches"] for r in ranks],
              **ranks[0]["report"], "fleet_rank1": ranks[1]["report"]["fleet"],
              "phase_s": time.perf_counter() - t0}
    failed = ranks[0]["failed"] + ranks[1]["failed"]
    if report["field_b3_launches_per_rank"] != [1, 1]:
        failed.append(f"field: B3 launched {report['field_b3_launches_per_rank']} a rank")
    emit(report)
    if failed:
        raise AssertionError("; ".join(failed))
    return report


# slice 7c: the composed pipeline at the JAX example's defaults
PIPELINE_ARGV = []
# the legacy path: the rotated RPN's benchmark shape, the JAX default output
# and the largest of the legacy configs
LEGACY_OUTPUTS = ((1, 1, 1), (5, 5, 5))
LEGACY_REF = dict(levels=((40, 40, 30), (20, 20, 15)), channels=32, rois=24, max_grid=16)
UTILS_SHAPE = (160, 160, 160)


def release() -> None:
    """Free what earlier phases left for the cyclic collector, so that a
    phase's peak bytes count its own work (and what it keeps) alone."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_pipeline(work, smi):
    """The five-stage pipeline (main path of slice 7c) through its entry,
    ``pipeline.main``, at the JAX example's defaults: every stage lands its
    keys, finite; the files are in the example's layout; B1 launches in
    stage 3 and its detections equal a re-run of the post-processing with
    the plain sweep."""
    import torch

    from instance_nerf_tpu_torch import pipeline
    from instance_nerf_tpu_torch.kernels.nms_cuda import nms_boxes_plain

    release()
    wd = os.path.join(work, "pipeline")
    zero_launches()
    t0 = time.perf_counter()
    pipe = pipeline.main(["--workdir", wd, *PIPELINE_ARGV])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if launches["nms_boxes"] < 1:
        raise AssertionError(f"the pipeline's stage 3 did not launch B1: {launches}")
    s = pipe.summary
    keys = ("psnr", "rcnn_loss", "detections", "matched_views", "instance_ce", "pq", "miou",
            "holdout_render_psnr", *(f"stage{i}_wall_s" for i in range(1, 6)),
            *(f"stage{i}_peak_bytes" for i in range(1, 6)))
    bad = [k for k in keys if not np.isfinite(s[k])]
    if bad:
        raise AssertionError(f"pipeline summary keys not finite: {bad}")
    if json.load(open(os.path.join(wd, "summary.json"))) != json.loads(json.dumps(s)):
        raise AssertionError("summary.json differs from the run's summary")
    a = pipe.args
    n_train = a.views - a.holdout
    views = [f"r_{v:03d}" for v in range(n_train)]
    layout = {
        "top": sorted(os.listdir(wd)),
        "scene": sorted(os.listdir(os.path.join(wd, "scene"))),
        "images": sorted(os.listdir(os.path.join(wd, "scene", "images"))),
        "masks_matched": sorted(os.listdir(os.path.join(wd, "masks_matched")))}
    want = {"top": ["masks.npz", "masks_matched", "projections", "rgbsigma.npy", "scene",
                    "summary.json"],
            "scene": ["boxes.npy", "images", "masks", "transforms.json"],
            "images": [v + ".png" for v in views],
            "masks_matched": [v + ".npy" for v in views]}
    if layout != want:
        raise AssertionError(f"pipeline files {layout}, expected {want}")
    with np.load(os.path.join(wd, "masks.npz")) as z:
        if sorted(z.files) != ["boxes", "labels", "masks", "scores"]:
            raise AssertionError(f"masks.npz holds {z.files}")
        if z["masks"].shape != (s["detections"], a.grid, a.grid, a.grid):
            raise AssertionError(f"masks {z['masks'].shape}")
    if np.load(os.path.join(wd, "rgbsigma.npy")).shape != (a.grid,) * 3 + (4,):
        raise AssertionError("rgbsigma.npy shape")

    # stage 3 re-run with the plain sweep: the same detections
    captured = []

    def plain_sweep(sboxes, svalid, thr):
        captured.append(int(sboxes.shape[0]))
        return nms_boxes_plain(sboxes, svalid, thr)

    det_p = pipe.postprocess(nms_sweep=plain_sweep)
    for f in det_p._fields:
        if not torch.equal(getattr(det_p, f), getattr(pipe.det, f)):
            raise AssertionError(f"pipeline stage 3: kernel vs plain NMS differ in {f}")
    line = {"phase": "pipeline", "argv": PIPELINE_ARGV, "config": s["config"],
            "seconds": seconds, "launches": launches, "nms_k": captured[0],
            "plain_nms_identical": True,
            "walls_s": {f"stage{i}": s[f"stage{i}_wall_s"] for i in range(1, 6)},
            "peak_bytes": {f"stage{i}": s[f"stage{i}_peak_bytes"] for i in range(1, 6)},
            "metrics": {k: s[k] for k in ("psnr", "rcnn_loss", "detections", "matched_views",
                                          "instance_ce", "pq", "miou",
                                          "holdout_render_psnr")},
            "device": s["device"], "nvidia_smi": smi}
    emit(line)
    del pipe
    torch.cuda.empty_cache()
    return line


def phase_slice_legacy(smi):
    """The legacy two-stage classification path at full width: the rotated
    RPN's ``predict_scene`` at its benchmark shape (B2, K = 4000) gives the
    FPN levels (256 channels, bf16) and up to 1000 proposals; FPN eq. (1) on
    their enclosing AABBs (``ops/poolers.py:map_levels``) picks each one's
    level; ``LegacyProposalScorer`` (the legacy pool, rotated, pooling,
    enlarge 0.2, ``max_grid`` 32, then the classifier 256, 256, 512, 2
    classes in bf16) at output 1^3 and 5^3: ms (median of 10 warmed runs),
    peak bytes, the chunk size; at 1^3 also with every roi's grid clamped
    to ``max_grid`` (the lattice the chunks bound). Then a small f32 case,
    card against the CPU: pooled features 1e-5 of their max, scores 1e-5."""
    import torch

    from instance_nerf_tpu_torch.models.legacy_classifier import LegacyProposalScorer
    from instance_nerf_tpu_torch.ops.boxes import obb2hbb_3d
    from instance_nerf_tpu_torch.ops.legacy_roi_pool import roi_chunk
    from instance_nerf_tpu_torch.ops.poolers import map_levels
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig, RPNTrainer
    from instance_nerf_tpu_torch.train.timing import benchmark_ms
    from instance_nerf_tpu_torch.utils.hbm import memory_stats

    release()
    cfg = RPNConfig(rotated_bbox=True, dtype="bfloat16", resolution=160, seed=0)
    rpn = RPNTrainer(cfg, device="cuda")
    rpn.init_state()
    shape = (200, 200, 130)
    grid = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (*shape, 4)).astype(np.float32)).to("cuda")
    zero_launches()
    boxes, _, _, feats, obj = rpn.predict_scene(grid)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["nms_sweep"] != 1:
        raise AssertionError(f"the RPN's NMS launched B2 {launches['nms_sweep']} times")
    del obj, rpn, grid
    boxes = boxes.float()
    strides = tuple(cfg.fpn_strides)
    k_min, k_max = int(np.log2(strides[0])), int(np.log2(strides[-1]))
    level_ids = map_levels(obb2hbb_3d(boxes), k_min, k_max)
    chunk = roi_chunk(32, feats[0].shape[-1])
    runs = {}
    for out_size in LEGACY_OUTPUTS:
        scorer = LegacyProposalScorer(in_channels=256, num_classes=2, output_size=out_size,
                                      dtype=torch.bfloat16, device="cuda")
        run = lambda: scorer(feats, boxes, level_ids, strides)  # noqa: E731
        scores, pooled = run()
        if tuple(scores.shape) != (boxes.shape[0], 2) or tuple(pooled.shape) != (
                boxes.shape[0], *out_size, 256):
            raise AssertionError(f"legacy outputs {tuple(scores.shape)} {tuple(pooled.shape)}")
        if not (torch.isfinite(scores.float()).all() and torch.isfinite(pooled).all()):
            raise AssertionError("non-finite legacy outputs")
        mem = memory_stats(run)
        bench = benchmark_ms(run, "cuda", reps=10, warmup=2)
        runs["x".join(map(str, out_size))] = {
            "ms_median": bench["median_ms"], "ms_min": bench["min_ms"],
            "peak_mem_bytes": bench["peak_mem_bytes"], "memory_stats": mem,
            "pooled_abs_max": float(pooled.abs().max()),
            "fg_share": float((scores.argmax(-1) == 1).float().mean())}
        del scorer, scores, pooled
        torch.cuda.empty_cache()
    # the worst case the chunks bound: every roi's grid clamped to max_grid
    # (the same centers and angles, extents of 32 strides of their level)
    big = boxes.clone()
    big[:, 3:6] = 32.0 * torch.tensor(strides, device="cuda")[level_ids.long()][:, None]
    scorer = LegacyProposalScorer(in_channels=256, num_classes=2, dtype=torch.bfloat16,
                                  device="cuda")
    run = lambda: scorer(feats, big, level_ids, strides)  # noqa: E731
    mem = memory_stats(run)
    bench = benchmark_ms(run, "cuda", reps=3, warmup=1)
    runs["1x1x1_max_grid"] = {"ms_median": bench["median_ms"], "ms_min": bench["min_ms"],
                              "peak_mem_bytes": bench["peak_mem_bytes"], "memory_stats": mem}
    del scorer, big
    torch.cuda.empty_cache()

    # the small f32 case: card against CPU, the same seeded weights and inputs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    c = LEGACY_REF["channels"]
    levels = [rng.normal(size=(*s, c)).astype(np.float32) for s in LEGACY_REF["levels"]]
    n = LEGACY_REF["rois"]
    rois = np.concatenate([rng.uniform(4, 36, (n, 2)), rng.uniform(4, 26, (n, 1)),
                           rng.uniform(3, 24, (n, 3)), rng.uniform(-3, 3, (n, 1))],
                          1).astype(np.float32)
    ids = rng.integers(0, 2, n).astype(np.int32)
    ref = {}
    for out_size in LEGACY_OUTPUTS:
        res = {}
        for dev in ("cuda", "cpu"):
            scorer = LegacyProposalScorer(in_channels=c, output_size=out_size,
                                          max_grid=LEGACY_REF["max_grid"], device=dev)
            res[dev] = [t.cpu() for t in scorer([torch.from_numpy(f).to(dev) for f in levels],
                                                torch.from_numpy(rois).to(dev),
                                                torch.from_numpy(ids).to(dev), (2, 4))]
        (sc_g, po_g), (sc_c, po_c) = res["cuda"], res["cpu"]
        err_pool = float((po_g - po_c).abs().max() / po_c.abs().max().clamp_min(1e-30))
        err_score = float((sc_g - sc_c).abs().max())
        ref["x".join(map(str, out_size))] = {"pooled_err_rel_max": err_pool,
                                             "scores_abs_err": err_score}
        if not (err_pool <= 1e-5 and err_score <= 1e-5):
            raise AssertionError(f"legacy path card vs CPU at {out_size}: pooled "
                                 f"{err_pool}, scores {err_score}")
    line = {"phase": "slice_legacy", "grid": list(shape), "rpn_launches": launches,
            "proposals": int(boxes.shape[0]),
            "levels": torch.bincount(level_ids.long(), minlength=4).tolist(),
            "feature_shapes": [list(f.shape) for f in feats], "max_grid": 32,
            "chunk": chunk, "runs": runs, "small_reference": ref, "nvidia_smi": smi}
    emit(line)
    del feats, boxes
    torch.cuda.empty_cache()
    return line


def phase_utils(work, smi):
    """The FLOP / memory / profiling utilities on the card: ``count_flops``
    and ``step_stats`` of the FCOS AABB train step at batch 4 and 160^3
    (bf16) through ``benchmark_train_step`` (FLOPs a step, achieved TFLOP/s,
    MFU against the H100's bf16 peak); ``memory_stats`` of one step within
    5% of the benchmark's peak; ``chained_latency_ms`` of the RCNN's
    ``predict_scene`` at its bench shape beside ``benchmark``'s median; a
    ``trace`` written and non-empty."""
    import torch

    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig, RCNNTrainer
    from instance_nerf_tpu_torch.utils.hbm import H100_SXM_PEAK_BF16_FLOPS, memory_stats
    from instance_nerf_tpu_torch.utils.profiling import (
        TRACE_FILE,
        chained_latency_ms,
        dispatch_overhead_ms,
        trace,
    )

    release()
    tr = make_trainer("fcos", False, "cuda")
    tr.init_state(total_steps=TRAIN_SCHEDULE_STEPS)
    bench = tr.benchmark_train_step(reps=10, warmup=3, shape=UTILS_SHAPE, batch=4)
    step = tr._card_train_step(4, UTILS_SHAPE)
    mem = memory_stats(step)
    rel = abs(mem["peak_hbm"] - bench["peak_mem_bytes"]) / bench["peak_mem_bytes"]
    if rel > 0.05:
        raise AssertionError(f"memory_stats peak {mem['peak_hbm']} vs the benchmark's "
                             f"{bench['peak_mem_bytes']}")
    if not (bench["flops_per_step"] > 0 and 0 < bench["mfu"] < 1):
        raise AssertionError(f"FCOS step FLOPs {bench['flops_per_step']}, mfu {bench['mfu']}")
    del tr, step
    torch.cuda.empty_cache()

    rcnn = RCNNTrainer(RCNNConfig(resolution=200, num_classes=11, dtype="bfloat16",
                                  eval_rois=20, box_nms_thresh=0.15, detections_per_img=25,
                                  seed=0), device="cuda")
    rcnn.init_state()
    shape = (200, 200, 132)
    rbench = rcnn.benchmark(reps=10, shape=shape)
    grid, rois = rcnn._card_inputs(shape)

    def chained(c, grid, rois):
        det, masks = rcnn.predict_scene(grid + c * 0, rois)
        return c + (det.scores.float().sum() + masks[:1, :1, :1, :1].sum()) * 0 + 1

    chain_ms = chained_latency_ms(chained, (grid, rois), reps=10, device="cuda")
    overhead = dispatch_overhead_ms(device="cuda")
    tdir = os.path.join(work, "trace")
    with trace(tdir):
        rcnn.predict_scene(grid, rois)
        torch.cuda.synchronize()
    tfile = os.path.join(tdir, TRACE_FILE)
    with open(tfile) as f:
        events = json.load(f)["traceEvents"]
    n_cuda = sum(1 for e in events if e.get("cat") == "kernel")
    if not events or not n_cuda:
        raise AssertionError(f"trace {tfile}: {len(events)} events, {n_cuda} kernels")
    line = {"phase": "utils", "fcos_shape": list(UTILS_SHAPE), "batch": 4, "dtype": "bfloat16",
            "step_ms_median": bench["median_ms"], "flops_per_step": bench["flops_per_step"],
            "tflops_per_step": bench["tflops_per_step"],
            "achieved_tflops": bench["achieved_tflops"], "mfu": bench["mfu"],
            "peak_flops": H100_SXM_PEAK_BF16_FLOPS, "peak_hbm_gib": bench["peak_hbm_gib"],
            "benchmark_peak_bytes": bench["peak_mem_bytes"], "memory_stats": mem,
            "memory_rel_diff": rel, "rcnn_predict_ms_median": rbench["median_ms"],
            "rcnn_chained_ms": chain_ms, "dispatch_overhead_ms": overhead,
            "trace_events": len(events), "trace_kernels": n_cuda,
            "trace_bytes": os.path.getsize(tfile), "nvidia_smi": smi}
    emit(line)
    del rcnn, grid
    torch.cuda.empty_cache()
    return line


def dist_child(argv):
    """A rank of a launched phase: ``--dist-child NAME OUT [ARGS]``."""
    name, *rest = argv
    {"slice_dist": child_slice_dist, "small_reference_dist": child_small_reference_dist}[name](
        *rest)


def fcos_entry(nms) -> dict:
    """The FCOS path's figures of one NMS kernel for its ``kernels`` entry:
    launches per ``predict_scene``, K into the NMS, the valid boxes, the
    rows swept (B2 sweeps the valid ones), the kept ones, the kernel's times
    on the scene's own input, its plain version's and its bound."""
    return {"launches_fcos": nms["launches"], "k_fcos": nms["k"], "valid_fcos": nms["valid"],
            "swept_fcos": nms["swept"], "kept_fcos": nms["kept"], "fcos_ms": nms["kernel_ms"],
            "fcos_device_ms": nms["device_ms"], "fcos_mask_device_ms": nms["mask_device_ms"],
            "fcos_scan_device_ms": nms["scan_device_ms"],
            "fcos_call_device_ms": nms["call_device_ms"], "fcos_plain_ms": nms["plain_ms"],
            "fcos_bound_ms": nms["bound_ms"], "fcos_bound_by": nms["bound_by"]}


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
    k_t = nms_times({}, lambda: nms_boxes(sboxes, svalid, 0.15), reps=200, dev_reps=50)
    bound_ms, bound_by = nms_bound_ms(keep_k, svalid)
    p_ms = cuda_ms(lambda: nms_boxes_plain(sboxes, svalid, 0.15), reps=5, warmup=1)
    phase_small_reference()

    launches_rpn, (iou, ivalid) = phase_slice_rpn()
    keep_k = nms_sweep(iou, ivalid, 0.7)
    keep_p = nms_sweep_plain(iou, ivalid, 0.7)
    err_iou = float((keep_k.int() - keep_p.int()).abs().max())
    if err_iou:
        raise AssertionError("nms_sweep kernel disagrees on the scene's own NMS input")
    ki_t = nms_times({}, lambda: nms_sweep(iou, ivalid, 0.7), reps=20, dev_reps=20)
    bound_iou_ms, bound_iou_by = sweep_bound_ms(keep_k, ivalid)
    pi_ms = cuda_ms(lambda: nms_sweep_plain(iou, ivalid, 0.7), reps=3, warmup=1)
    kept = int(keep_k.sum())
    phase_small_reference_rpn()

    fcos = phase_slice_fcos()
    phase_small_reference_fcos()
    backbones = phase_slice_backbones(smi)
    launches_obb_rcnn = phase_small_reference_backbones()
    phase_eval()
    phase_slice_train(smi)
    phase_small_reference_train()
    launches_train = phase_train_loop()

    launches_field, main_step = phase_slice_field()
    launches_fast, fast_step, b5_inputs = phase_slice_field_fast()
    scat = phase_kernel_scatter(main_step, fast_step)
    del main_step, fast_step
    occ_t = phase_kernel_coarse_occ(b5_inputs)
    del b5_inputs
    phase_small_reference_field()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        field_cli = phase_field_cli(work)
        fleet, fleet_case = phase_slice_fleet(work, smi)
        phase_small_reference_fleet()
        phase_project_masks(work)
        dist = phase_slice_dist(work, smi)
        dist_ref = phase_small_reference_dist(work)
        pipe = phase_pipeline(work, smi)
        legacy = phase_slice_legacy(smi)
        phase_utils(work, smi)

    main_scat = scat["main_all_levels"]
    emit({"kernels": [{
        "name": "nms_boxes", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "instance_nerf_tpu/kernels/nms_pallas.py:113",
        "launches": launches_rcnn["nms_boxes"], "max_abs_err": err,
        "ms": k_t["kernel_ms"], "device_ms": k_t["device_ms"],
        "mask_device_ms": k_t["mask_device_ms"], "scan_device_ms": k_t["scan_device_ms"],
        "call_device_ms": k_t["call_device_ms"], "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "k": int(sboxes.shape[0]),
        "k10400": timing["k10400"],
        "launches_train_loop": {k: launches_train[k] for k in (
            "fcos_aabb", "rcnn", "fcos_aabb_device_data", "rcnn_device_data")},
        "launches_backbones": {k: backbones[k]["nms_boxes"] for k in (
            "fcos_aabb_swin_s", "rcnn_resnet")},
        "launches_dist_train_loop": {k: dist["launches_dist_train_loop"][k] for k in (
            "fcos_aabb", "fcos_aabb_resume")},
        "launches_pipeline": pipe["launches"]["nms_boxes"], "k_pipeline": pipe["nms_k"],
        **fcos_entry(fcos["aabb"]["nms"]),
    }, {
        "name": "nms_sweep", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/nms_sweep_iou.cu",
        "replaces": "instance_nerf_tpu/kernels/nms_pallas.py:157",
        "launches": launches_rpn["nms_sweep"], "max_abs_err": err_iou,
        "ms": ki_t["kernel_ms"], "device_ms": ki_t["device_ms"],
        "mask_device_ms": ki_t["mask_device_ms"], "scan_device_ms": ki_t["scan_device_ms"],
        "call_device_ms": ki_t["call_device_ms"], "plain_ms": pi_ms, "bound_ms": bound_iou_ms,
        "bound_by": bound_iou_by, "library_ms": None,
        "k": int(iou.shape[0]), "kept": kept,
        "launches_train_loop": {k: launches_train[k] for k in ("fcos_rotated", "rpn_rotated")},
        "launches_backbones": {k: backbones[k]["nms_sweep"] for k in (
            "fcos_rotated_swin_s", "rpn_rotated_resnet")},
        "launches_obb_rcnn_reference": launches_obb_rcnn["nms_sweep"],
        "launches_dist_train_loop": {
            "rpn_rotated": dist["launches_dist_train_loop"]["rpn_rotated"]},
        "launches_legacy": legacy["rpn_launches"]["nms_sweep"],
        "random_k4000": timing_iou["k4000"],
        **fcos_entry(fcos["obb"]["nms"]),
    }, {
        "name": "scatter_add", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "instance_nerf_tpu/kernels/scatter_pallas.py:96",
        "also_replaces": ["instance_nerf_tpu/kernels/scatter_pallas.py:158",
                          "examples/probe9_scatter_variants.py:41"],
        "launches": launches_field["scatter_add"],
        "launches_fast": launches_fast["scatter_add"],
        "launches_field_cli": field_cli["launches_rgb"]["scatter_add"],
        "launches_field_cli_fast": field_cli["launches_fast"]["scatter_add"],
        "launches_fleet": fleet["launches_rgb"]["scatter_add"],
        "launches_fleet_dist": {"ranks": dist["ranks"], "steps": DIST_FLEET_STEPS["train"],
                                "rank0": dist["fleet"]["launches"]["scatter_add"]},
        "launches_field_sharded": dist_ref["field_b3_launches_per_rank"],
        **{case: {k: timed[k] for k in (
            "n", "w", "rows", "levels", "plan", "ms", "device_ms", "call_device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms",
            "max_abs_err", "max_err_per_abs_sum")}
           for case, timed in (("fleet", fleet_case),
                               ("field_cli_fast", field_cli["b3_fast_step"]))},
        "max_abs_err": main_scat["max_abs_err"],
        "ms": main_scat["ms"], "device_ms": main_scat["device_ms"],
        "call_device_ms": main_scat["call_device_ms"], "plain_ms": main_scat["plain_ms"],
        "bound_ms": main_scat["bound_ms"], "bound_by": main_scat["bound_by"],
        "library_ms": main_scat["library_ms"],
        "library_device_ms": main_scat["library_device_ms"],
        "n": main_scat["n"], "w": main_scat["w"],
        "rows": main_scat["rows"], "cases": scat,
    }, {
        "name": "coarse_occ_lookup", "route": "cuda",
        "source": "instance_nerf_tpu_torch/csrc/coarse_occ.cu",
        "replaces": "instance_nerf_tpu/kernels/coarse_occ_pallas.py:53",
        "launches": launches_fast["coarse_occ_lookup"], "on_main_path": False,
        "max_abs_err": 0.0, "ms": occ_t["ms"], "device_ms": occ_t["device_ms"],
        "call_device_ms": occ_t["call_device_ms"], "plain_ms": occ_t["plain_ms"],
        "bound_ms": occ_t["bound_ms"], "bound_by": occ_t["bound_by"],
        "library_ms": occ_t["library_ms"], "library_device_ms": occ_t["library_device_ms"],
        "renderer_ms": occ_t["renderer_ms"],
        "n": occ_t["n"], "coarse_res": occ_t["coarse_res"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        dist_child(sys.argv[2:])
    else:
        main()
