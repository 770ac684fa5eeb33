"""The multi-scene (fleet) instance-field loss and gradients on one card
(PyTorch counterpart of ``instance_nerf_tpu.parallel.ngp_train_step``'s
``make_multiscene_ngp_step``; the step itself is
``train/multiscene.py:MultiSceneFieldTrainer.train_step``, this function
then ``ngp_trainer.adam_update``, and ``init_multiscene_params`` is
``ngp_trainer.init_ngp_params`` of the batched field).

A fleet is one batched field (``build_model(cfg, n_scenes=B)``): every
parameter stacked on a leading scene axis, the B scenes' brick or hash
tables one ``(B * L * T, W)`` table whose flat indices lay out ``(N, B,
L)``, so that with ``pallas_grad`` the whole fleet's table gradient is ONE
launch of kernel B3 over B * L levels; the MLPs run as batched matmuls over
``(B, in, out)`` weights. The loss is the SUM over scenes of each scene's
total, so each scene's gradient is its own, and Adam updates the stacked
parameters elementwise with one shared count (the single-scene trainer's
``adam_update``). In the instance stage the gradients and updates outside
``inst_*`` are masked.

The JAX package's single-scene ``make_sharded_ngp_step`` and its mesh
(``parallel/mesh.py``), which shard rays over several chips, come with the
multi-card slice.
"""
from __future__ import annotations

import torch

from instance_nerf_tpu_torch.models.render import OccupancyGrid, render_rays
from instance_nerf_tpu_torch.ops.nms import no_stage
from instance_nerf_tpu_torch.train.ngp_trainer import (
    NGPConfig,
    field_losses,
)


def multiscene_loss_and_grads(model, cfg: NGPConfig, stage: str, occ_grids, o, d,
                              target_rgb, target_inst, generator=None, jitter=None,
                              stages=no_stage):
    """Per-scene losses ``{name: (B,)}`` and ``{param name: grad or None}`` of
    one fleet batch (rays ``(B, R, 3)``, grids ``(B, G, G, G)``): the
    gradient of the sum over scenes of each scene's total. ``jitter``
    ``(B, R, S)`` (or ``(B, R, 1)`` with ``ray_jitter``) replaces the draws
    from ``generator``."""
    occ = OccupancyGrid(occ_grids, cfg.occ_threshold)
    with_instance = stage != "rgb"
    out = render_rays(lambda x, v: model(x, v, with_instance, stages), o, d,
                      n_samples=cfg.n_samples, occ=occ, with_instance=with_instance,
                      k_occupied=cfg.k_occupied, occ_coarse_res=cfg.occ_coarse_res,
                      k_buckets=cfg.k_buckets, fuse_buckets=cfg.fuse_buckets,
                      ray_jitter=cfg.ray_jitter, generator=generator, jitter=jitter,
                      stage=stages)
    with stages("composite_loss"):
        losses = field_losses(out, target_rgb, target_inst, stage, cfg)
        losses.pop("psnr")
    with stages("backward"):
        names, params = zip(*model.named_parameters())
        # sum over scenes: d(sum) / d(params of scene b) is scene b's own gradient
        grads = torch.autograd.grad(losses["total"].sum(), params, allow_unused=True)
    return {k: v.detach() for k, v in losses.items()}, dict(zip(names, grads))
