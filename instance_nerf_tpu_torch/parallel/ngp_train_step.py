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

``sharded_ngp_loss_and_grads`` is the JAX package's single-scene
``make_sharded_ngp_step`` over a process group (``parallel/mesh.py``):
each rank renders its own block of the rays, the losses' partial sums
(``ngp_trainer.partial_sums``, the JAX step's ``_losses``) are summed over
the ranks in the forward and each rank's loss is its numerators over the
global normalisers (``ngp_trainer.sums_to_losses``, which also makes the
one-process ``field_losses``), and the gradients are SUMmed over the
ranks; the caller then runs ``adam_update`` on every rank. A fleet whose
scenes' rays are split over ranks takes its per-scene losses the same
way (``train/multiscene.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from instance_nerf_tpu_torch.models.render import OccupancyGrid, bucket_sizes, render_rays
from instance_nerf_tpu_torch.parallel.mesh import all_reduce_sum, distributed, forward_sum
from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig, partial_sums, sums_to_losses
from instance_nerf_tpu_torch.train.timing import NO_STAGES

def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The ray-sharded step's generator of rank ``rank``: seeded from
    ``(seed, rank)``, as the JAX step folds the shard's axis indices into
    its key (the streams differ from JAX's)."""
    s = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def sharded_ngp_loss_and_grads(model, cfg: NGPConfig, stage: str, occ: OccupancyGrid, o, d,
                               target_rgb, target_inst, group=None, stratified: bool = True,
                               generator=None, jitter=None, stages=NO_STAGES):
    """The single-scene field's losses and gradients over rays split across
    the ranks of ``group`` (this rank's ``(R_local, 3)`` block): the JAX
    ``make_sharded_ngp_step``'s loss. ``k_buckets`` routes this rank's own
    rays, as the JAX ``shard_map`` path does (zero collectives); the draws
    are ``jitter`` or come from ``generator`` (``rank_generator``). Returns
    (the global batch's metrics, ``{param name: the SUM over ranks of the
    gradient, or None}``); ``adam_update`` follows on every rank. With
    ``pallas_grad`` the table gradient is one launch of kernel B3 a rank."""
    with_instance = stage != "rgb"
    out = render_rays(lambda x, v: model(x, v, with_instance, stages), o, d,
                      n_samples=cfg.n_samples, occ=occ, stratified=stratified,
                      with_instance=with_instance, k_occupied=cfg.k_occupied,
                      occ_coarse_res=cfg.occ_coarse_res, k_buckets=cfg.k_buckets,
                      fuse_buckets=cfg.fuse_buckets, ray_jitter=cfg.ray_jitter,
                      generator=generator, jitter=jitter, stage=stages)
    with stages("composite_loss"):
        local = partial_sums(out, target_rgb, target_inst, stage, cfg)
        total = forward_sum(local, group=group)
        loss, metrics = sums_to_losses(local, total, stage, cfg)
    with stages("backward"):
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    if distributed():
        with stages("allreduce"):
            grads = _sum_grads(grads, group)
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def _sum_grads(grads, group) -> list:
    """Each gradient summed over the ranks of ``group`` (None stays None:
    no rank's loss reached that parameter)."""
    grads = list(grads)
    have = [i for i, g in enumerate(grads) if g is not None]
    for i, g in zip(have, all_reduce_sum([grads[i] for i in have], group=group)):
        grads[i] = g
    return grads


def group_route(k_buckets, group, n_ranks: int, index: int):
    """The routing of ``k_buckets`` over ONE scene's rays split in equal
    contiguous blocks over the ``n_ranks`` ranks of ``group`` (this rank's
    block ``index``): the hit counts are gathered, the scene's rays sorted
    and cut into buckets as on one card (the JAX step's global sort under
    GSPMD), and this rank routes its own rays with the K they got: its rays
    in the global order, and each bucket's count of them."""

    def route(hits):  # (1, R_local)
        parts = [torch.empty_like(hits) for _ in range(n_ranks)]
        torch.distributed.all_gather(parts, hits.contiguous(), group=group)
        every = torch.cat(parts, dim=-1)  # (1, R)
        r, r_local = every.shape[-1], hits.shape[-1]
        order = torch.argsort(every, dim=-1, stable=True)
        sizes = bucket_sizes(r, k_buckets)
        position = torch.empty_like(order)
        position.scatter_(-1, order, torch.arange(r, device=hits.device).expand_as(order))
        mine = position[..., index * r_local:(index + 1) * r_local]
        ends = torch.as_tensor(np.cumsum([n for n, _ in sizes]), device=hits.device)
        counts = torch.bincount(torch.bucketize(mine.reshape(-1), ends, right=True),
                                minlength=len(sizes)).tolist()
        return (torch.argsort(mine, dim=-1, stable=True),
                [(c, k) for c, (_, k) in zip(counts, sizes)])

    return route


def multiscene_loss_and_grads(model, cfg: NGPConfig, stage: str, occ_grids, o, d,
                              target_rgb, target_inst, generator=None, jitter=None,
                              stages=NO_STAGES, group=None, route=None):
    """Per-scene losses ``{name: (B,)}`` and ``{param name: grad or None}`` of
    one fleet batch (rays ``(B, R, 3)``, grids ``(B, G, G, G)``): the
    gradient of the sum over scenes of each scene's total. ``jitter``
    ``(B, R, S)`` (or ``(B, R, 1)`` with ``ray_jitter``) replaces the draws
    from ``generator``.

    ``group``: these scenes' rays are split over its ranks (``o`` this
    rank's block). The per-scene partial sums are then summed over the
    group, each rank's loss is its numerators over the global normalisers,
    and the gradients are SUMmed over the group; ``route`` (``group_route``)
    routes ``k_buckets`` over each scene's whole ray batch."""
    occ = OccupancyGrid(occ_grids, cfg.occ_threshold)
    with_instance = stage != "rgb"
    out = render_rays(lambda x, v: model(x, v, with_instance, stages), o, d,
                      n_samples=cfg.n_samples, occ=occ, with_instance=with_instance,
                      k_occupied=cfg.k_occupied, occ_coarse_res=cfg.occ_coarse_res,
                      k_buckets=cfg.k_buckets, fuse_buckets=cfg.fuse_buckets,
                      ray_jitter=cfg.ray_jitter, generator=generator, jitter=jitter,
                      stage=stages, route=route)
    with stages("composite_loss"):
        local = partial_sums(out, target_rgb, target_inst, stage, cfg)
        total = local.detach() if group is None else forward_sum(local, group=group)
        loss, losses = sums_to_losses(local, total, stage, cfg)
        loss = loss.sum()
    with stages("backward"):
        names, params = zip(*model.named_parameters())
        # sum over scenes: d(sum) / d(params of scene b) is scene b's own gradient
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    if group is not None:
        with stages("allreduce"):
            grads = _sum_grads(grads, group)
    return {k: v.detach() for k, v in losses.items()}, dict(zip(names, grads))
