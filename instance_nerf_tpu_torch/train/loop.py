"""The detector trainers' shared training loop and batches.

``train_epochs`` is the JAX trainers' epoch loop: a permutation of the
train split per epoch from ``default_rng(seed)``, the last partial batch
padded from the epoch's first scenes, and at the end of an epoch the eval
and checkpoint rules of the FCOS trainer (the superset of the three): eval
and save with the metrics every ``eval_interval`` epochs when there is a
val split, else save then; save every ``save_interval`` epochs; save at
the end. A dispatch runs ``steps_per_call`` steps (fewer at an epoch's
end): it loads their batches, then runs them one after another (the JAX
package scans them in one dispatch), then reads ``total`` once, and logs
when the global step passed a multiple of ``log_interval`` in it. The
device-resident loops of the JAX trainers draw their batches otherwise
(``device_indices``).

Over a process group (``parallel/mesh.py``) every rank draws the same
permutations and global batch indices and loads its own rows of each
batch (the trainers' ``load``; on a spatial axis also its block of each
grid's W); logging, evals and checkpoints run on rank 0 while the other
ranks wait at a barrier.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from instance_nerf_tpu_torch.parallel.mesh import barrier, is_main


def padded_indices(rng, n_scenes: int, bs: int, steps: int) -> list:
    """The host loaders' batches of an epoch, ``steps`` rows of scene
    indices: a permutation, the last partial batch padded from its first
    scenes."""
    order = rng.permutation(n_scenes)
    rows = []
    for s in range(steps):
        idx = order[s * bs:(s + 1) * bs]
        if len(idx) < bs:  # pad the last partial batch
            idx = np.concatenate([idx, order[:bs - len(idx)]])
        rows.append(idx)
    return rows


def device_indices(repeat: str):
    """The JAX trainers' device-resident batches of an epoch: a permutation
    cut to ``steps * bs`` (the tail dropped). A split smaller than a batch is
    tiled (``repeat="tile"``, FCOS) or drawn with repeats
    (``repeat="draw"``, RCNN: ``rng.integers`` after the permutation)."""

    def indices(rng, n_scenes: int, bs: int, steps: int) -> np.ndarray:
        order = rng.permutation(n_scenes)
        n_used = steps * bs
        if repeat == "draw" and n_scenes < bs:
            order = rng.integers(0, n_scenes, bs)
        elif repeat == "tile" and n_used > len(order):
            order = np.tile(order, -(-n_used // len(order)))
        return order[:n_used].reshape(steps, bs)

    return indices


def train_epochs(cfg, n_scenes: int, start_epoch: int, load, step, evaluate=None,
                 save=None, log: logging.Logger | None = None, rng=None,
                 epoch_indices=padded_indices) -> dict:
    """Train from ``start_epoch`` to ``cfg.num_epochs`` (or
    ``stop_after_epochs`` epochs, where the config has it).

    ``load(indices)`` builds a batch (this rank's rows of the global batch
    ``indices``), ``step(batch)`` runs one update and
    returns its metrics (device tensors), ``evaluate()`` the val metrics or
    None without a val split, ``save(gstep, metrics)`` writes a checkpoint.
    ``rng`` (default ``default_rng(cfg.seed)``) and ``epoch_indices(rng,
    n_scenes, bs, steps)`` draw each epoch's batches. Returns a summary:
    epochs, steps and dispatches run, seconds spent loading batches and
    stepping, the last step's metrics and the last eval's."""
    log = log or logging.getLogger("train")
    main = is_main()
    bs = cfg.batch_size
    spc = max(1, getattr(cfg, "steps_per_call", 1))
    steps_per_epoch = max(1, n_scenes // bs)
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    gstep = start_epoch * steps_per_epoch
    end_epoch = cfg.num_epochs
    stop_after = getattr(cfg, "stop_after_epochs", 0)
    if stop_after:
        end_epoch = min(end_epoch, start_epoch + max(0, stop_after))
    save_interval = getattr(cfg, "save_interval", 0)
    out = {"start_epoch": start_epoch, "epochs": 0, "steps": 0, "calls": 0, "data_s": 0.0,
           "step_s": 0.0, "last": None, "eval": None}
    for epoch in range(start_epoch, end_epoch):
        idxs = epoch_indices(rng, n_scenes, bs, steps_per_epoch)
        t0 = time.perf_counter()
        s = 0
        while s < steps_per_epoch:
            chunk = min(spc, steps_per_epoch - s)
            t1 = time.perf_counter()
            batches = [load(idxs[s + j]) for j in range(chunk)]
            t2 = time.perf_counter()
            for batch in batches:
                metrics = step(batch)
            # one read a dispatch: its updates are done before the next is queued
            total = float(metrics["total"])
            t3 = time.perf_counter()
            out["data_s"] += t2 - t1
            out["step_s"] += t3 - t2
            gstep += chunk
            s += chunk
            out["steps"] += chunk
            out["calls"] += 1
            if gstep % cfg.log_interval < chunk and main:
                log.info("epoch %d step %d: total=%.4f %s (%.2fs/it)", epoch, gstep, total,
                         " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()
                                  if k != "total"), (time.perf_counter() - t0) / s)
        out["epochs"] += 1
        out["last"] = {k: float(v) for k, v in metrics.items()}
        at_eval = (epoch + 1) % cfg.eval_interval == 0
        val = evaluate() if at_eval and evaluate is not None and main else None
        if val is not None:
            log.info("epoch %d eval: %s", epoch, val)
            out["eval"] = val
        if save is not None and (at_eval or (save_interval and (epoch + 1) % save_interval == 0)):
            if main:
                save(gstep, val)
        if at_eval or save is not None:
            barrier()
    if save is not None:
        if main:
            save(gstep, None)
        barrier()
    out["gstep"] = gstep
    return out


def device_batch(batch, device, fields=("grids", "grid_sizes", "gt_boxes", "gt_mask")):
    """A host batch's arrays ``fields`` as tensors on ``device``."""
    return tuple(torch.as_tensor(getattr(batch, f), device=device) for f in fields)


def synthetic_batch(batch: int, shape, max_gt: int, box_dim: int, input_dim: int = 4):
    """The JAX FCOS trainer's benchmark batch (``benchmark_train_step``):
    uniform grids and ``max_gt`` boxes a scene from ``default_rng(0)``, the
    boxes' low corners in [0, 0.6 m) and extents in [0.1 m, 0.35 m) for m
    the grid's smallest side, clipped to m, with a uniform angle appended
    for ``box_dim = 7``. Returns (grids, grid sizes, boxes, mask) as numpy."""
    rng = np.random.default_rng(0)
    grids = rng.uniform(0, 1, (batch, *shape, input_dim)).astype(np.float32)
    sizes = np.tile(np.asarray([[float(s) for s in shape]], np.float32), (batch, 1))
    m = min(shape)
    lo = rng.uniform(0, m * 0.6, (batch, max_gt, 3))
    ext = rng.uniform(m * 0.1, m * 0.35, (batch, max_gt, 3))
    boxes = np.concatenate([lo, np.minimum(lo + ext, m)], -1)
    if box_dim == 7:
        boxes = np.concatenate([boxes, rng.uniform(-np.pi / 2, np.pi / 2, (batch, max_gt, 1))],
                               -1)
    return grids, sizes, boxes.astype(np.float32), np.ones((batch, max_gt), bool)
