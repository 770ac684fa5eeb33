"""Training steps (PyTorch counterpart of
``instance_nerf_tpu.parallel.train_step``; the ``lax.scan`` dispatch of
several steps is the train loops' ``steps_per_call``, ``train/loop.py``).

``make_optimizer`` is the JAX package's recipe, written out in optax's op
order: clip by global norm (``(g / norm) * max_norm`` where the norm
reaches ``max_norm``), then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay over every trained parameter) with optax's
``cosine_onecycle_schedule`` over ``total_steps`` (a constant lr below 4
steps, where optax's schedule divides by zero). Its moments are
``torch._foreach`` lists, allocated at the first step.

``make_fcos_train_step`` / ``make_rpn_train_step`` return
``step(state, ...) -> (state, metrics)``: forward, loss, backward, optimizer,
each a span of ``stage`` (see ``train/timing.py``). Metrics stay on the
device; a step reads back from the device only the counts that its gathers
of positive rows (the RPN and OBB losses) and its checks for a scene without
gt need.

A step given a ``shard`` (``parallel/mesh.py:Shard``) is one rank's part of
a data-parallel step over a process group, the JAX step under a mesh: its
losses divide this rank's numerators by the global batch's counts, summed
over the ranks in the forward, and ``apply_step`` SUMs the gradients and
the metrics over the ranks in flat buckets (the span ``allreduce``) before
the clip, so every rank clips the global batch's gradient by its global
norm and takes the same update.

An FCOS or anchor-RPN step given the grid's W ``layout``
(``parallel/spatial.py``) is one ``sp`` rank's part of a step over the
mesh's spatial axis too: its grids are its rows of each scene's W, the
forward exchanges halos with the other ``sp`` ranks and its loss covers its
own locations or anchors (the RPN's targets taken over the whole scene,
``models/rpn.py``), so the same world SUM of the gradients gives the global
batch's. With ``remat`` the backward's
recompute replays the exchanges; it recomputes the whole forward (no early
stop), so every rank replays all of them in the same order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from instance_nerf_tpu_torch.models.fcos import fcos_loss, padding_mask
from instance_nerf_tpu_torch.models.rpn import anchor_padding_mask, rpn_loss
from instance_nerf_tpu_torch.parallel.mesh import all_reduce_sum, distributed
from instance_nerf_tpu_torch.train.timing import NO_STAGES


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax's one-cycle schedule: from ``peak / div_factor`` up to ``peak``
    over the first ``int(pct_start * steps)`` counts, then down to
    ``peak / (div_factor * final_div_factor)`` at ``steps``, each leg a
    cosine, constant after. Returns ``lr(count)``."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)]).tolist()

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return 0.0  # count < 0

    return schedule


class Optimizer:
    """Clip by global norm, then AdamW, over the named parameters given
    (a frozen parameter is simply not given; see ``train/train_utils.py``).
    A parameter without a gradient steps as optax steps a zero gradient."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, named_params, lr, weight_decay: float, clip_grad_norm: float):
        named_params = list(named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm
        self.count = 0
        self.mu = self.nu = None

    @torch.no_grad()
    def clip(self, grads):
        """optax ``clip_by_global_norm``: the grads unchanged below the limit,
        else ``(g / norm) * max_norm``."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scaled = torch._foreach_mul(torch._foreach_div(grads, norm), self.clip_grad_norm)
        keep = norm < self.clip_grad_norm
        return [torch.where(keep, g, s) for g, s in zip(grads, scaled)], norm

    @torch.no_grad()
    def step(self, grads=None):
        """One update from ``grads`` (default: each parameter's ``.grad``).
        Returns the global norm before the clip."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        grads, norm = self.clip(grads)
        b1, b2 = self.B1, self.B2
        lr = self.lr(self.count)
        self.count += 1
        # optax's bias corrections 1 - b^count, in f32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "names": list(self.names), "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state of other parameters")
        self.count = int(state["count"])
        if state["mu"] is None:
            self.mu = self.nu = None
            return
        self.mu = [m.to(p.device) for m, p in zip(state["mu"], self.params)]
        self.nu = [v.to(p.device) for v, p in zip(state["nu"], self.params)]


def make_optimizer(named_params, lr: float = 3e-4, weight_decay: float = 1e-3,
                   clip_grad_norm: float = 0.1, total_steps: int | None = None,
                   pct_start: float = 0.3) -> Optimizer:
    """AdamW + grad clip, one-cycle when ``total_steps`` >= 4 (the JAX
    package's recipe)."""
    sched = lr
    if total_steps and total_steps >= 4:
        sched = cosine_onecycle_schedule(total_steps, lr, pct_start=pct_start)
    return Optimizer(named_params, sched, weight_decay, clip_grad_norm)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments) and the step."""

    model: nn.Module
    tx: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.tx.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.tx.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def apply_step(state: TrainState, total: torch.Tensor, losses: dict, stage=NO_STAGES,
               shard=None):
    """Backward ``total`` and update: (state, metrics on the device). Under a
    process group with a ``shard``, the gradients and metrics are first
    summed over the ranks (an idle rank's weighted by 0)."""
    w = 1.0 if shard is None else shard.weight
    with stage("backward"):
        (total if w == 1.0 else total * w).backward()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total"] = total.detach()
    grads = None
    if shard is not None and distributed():
        with stage("allreduce"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in state.tx.params]
            keys = list(metrics)
            summed = all_reduce_sum(grads + [metrics[k].to(torch.float32) * w for k in keys])
            grads = summed[:len(grads)]
            metrics = dict(zip(keys, summed[len(grads):]))
    with stage("optimizer"):
        state.tx.step(grads)
    state.step += 1
    return state, metrics


def gradient_bytes(state: TrainState) -> int:
    """Bytes a step's gradient all-reduce moves in its f32 buckets (the
    trained parameters; the metrics add a few more)."""
    return 4 * sum(p.numel() for p in state.tx.params)


def fcos_losses(model, grids, grid_sizes, gt_boxes, gt_mask, reg_loss_weight: float = 1.0,
                center_sampling_radius: float = 1.5, iou_loss_type: str = "iou",
                use_obb: bool = False, use_additional_l1_loss: bool = False,
                proj2d_loss_weight: float = 0.0, remat: bool = False, stage=NO_STAGES,
                shard=None, layout=None):
    """One FCOS forward and loss: (total, losses). ``remat`` recomputes the
    forward in the backward (``torch.utils.checkpoint``); ``shard``: these
    are a data-parallel step's rows; ``layout``: the grids' W layout on the
    mesh's spatial axis."""
    with stage("forward"):
        if remat:
            with set_checkpoint_early_stop(layout is None):
                info, logits, reg, ctr, _ = checkpoint(
                    lambda g: model(g, train=True, layout=layout), grids,
                    use_reentrant=False)
        else:
            info, logits, reg, ctr, _ = model(grids, train=True, layout=layout)
    with stage("loss"):
        losses = fcos_loss(
            info, logits, reg, ctr, gt_boxes, gt_mask, pad_mask=padding_mask(info, grid_sizes),
            center_sampling_radius=center_sampling_radius, iou_loss_type=iou_loss_type,
            use_obb=use_obb, use_additional_l1_loss=use_additional_l1_loss,
            proj2d_loss_weight=proj2d_loss_weight,
            dist_sum=None if shard is None else shard.sum)
        total = (losses["loss_cls"] + reg_loss_weight * losses["loss_reg"]
                 + losses["loss_centerness"])
    return total, losses


def make_fcos_train_step(model, reg_loss_weight: float = 1.0,
                         center_sampling_radius: float = 1.5, iou_loss_type: str = "iou",
                         use_obb: bool = False, use_additional_l1_loss: bool = False,
                         proj2d_loss_weight: float = 0.0, remat: bool = False,
                         stage=NO_STAGES):
    """``step(state, grids, grid_sizes, gt_boxes, gt_mask, shard=None,
    layout=None) -> (state, metrics)``: the losses, ``total`` and
    ``num_pos``."""
    kw = dict(reg_loss_weight=reg_loss_weight, center_sampling_radius=center_sampling_radius,
              iou_loss_type=iou_loss_type, use_obb=use_obb,
              use_additional_l1_loss=use_additional_l1_loss,
              proj2d_loss_weight=proj2d_loss_weight, remat=remat, stage=stage)

    def step(state: TrainState, grids, grid_sizes, gt_boxes, gt_mask, shard=None,
             layout=None):
        model.zero_grad(set_to_none=True)
        total, losses = fcos_losses(model, grids, grid_sizes, gt_boxes, gt_mask, shard=shard,
                                    layout=layout, **kw)
        return apply_step(state, total, losses, stage, shard)

    return step


def rpn_losses(model, cfg, grids, grid_sizes, gt_boxes, gt_mask, uniforms=None,
               generator=None, stage=NO_STAGES, shard=None, layout=None):
    """One anchor-RPN forward and loss: (total, losses with ``total``).
    ``cfg`` is an ``RPNConfig``; only its loss and matching fields are read.
    ``layout``: the grids' W layout on the mesh's spatial axis (with
    ``shard``); ``uniforms`` are then over the scene's anchors."""
    with stage("forward"):
        obj, reg, anchors_l, _ = model(grids, layout=layout)
    with stage("loss"):
        losses = rpn_loss(
            obj, reg, torch.cat(anchors_l), gt_boxes, gt_mask,
            batch_size_per_mesh=cfg.batch_size_per_mesh,
            positive_fraction=cfg.positive_fraction, fg_iou_thresh=cfg.fg_iou_thresh,
            bg_iou_thresh=cfg.bg_iou_thresh,
            pad_mask=anchor_padding_mask(anchors_l, grid_sizes, tuple(cfg.fpn_strides)),
            rotated=cfg.rotated_bbox, reg_loss_type=cfg.reg_loss_type,
            max_mesh_dim=cfg.resolution, proj2d=cfg.proj2d_loss_weight > 0,
            uniforms=uniforms, generator=generator, shard=shard, layout=layout,
            level_counts=[a.shape[0] for a in anchors_l])
        total = losses["loss_objectness"] + losses["loss_rpn_box_reg"]
        if cfg.proj2d_loss_weight > 0:
            total = total + cfg.proj2d_loss_weight * losses["loss_rpn_box_reg_2d"]
        losses["total"] = total
    return total, losses


def make_rpn_train_step(model, cfg, stage=NO_STAGES):
    """``step(state, grids, grid_sizes, gt_boxes, gt_mask, uniforms=None,
    generator=None, shard=None, layout=None) -> (state, losses)``; the
    sampler's draws are ``uniforms`` (N, 2, R, R over the whole scene's
    anchors) or come from ``generator``."""

    def step(state: TrainState, grids, grid_sizes, gt_boxes, gt_mask, uniforms=None,
             generator=None, shard=None, layout=None):
        model.zero_grad(set_to_none=True)
        total, losses = rpn_losses(model, cfg, grids, grid_sizes, gt_boxes, gt_mask,
                                   uniforms, generator, stage, shard, layout)
        return apply_step(state, total, losses, stage, shard)

    return step
