"""What the instance field's training step does over ranks (PyTorch
counterpart of the rank-facing parts of
``instance_nerf_tpu.parallel.ngp_train_step``): the step itself is
``train/ngp_trainer.py:field_loss_and_grads``, for one scene, a fleet, and
either with its rays split over a process group (``parallel/mesh.py``).

The JAX package's ``make_sharded_ngp_step`` splits one scene's rays over
the ranks, and ``make_multiscene_ngp_step`` a fleet's scenes and, with
fewer scenes than ranks, each scene's rays. Each rank renders its own
block; the losses' partial sums are summed over the ranks in the forward,
each rank's loss is its numerators over the global normalisers, and the
gradients are SUMmed over the ranks (``sum_grads``). Here: each rank's
stratified draws (``rank_generator``), the routing of ``k_buckets`` over a
scene's whole ray batch (``group_route``), and the gradient sum.
"""
from __future__ import annotations

import numpy as np
import torch

from instance_nerf_tpu_torch.models.render import bucket_sizes
from instance_nerf_tpu_torch.parallel.mesh import all_reduce_sum


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The ray-sharded step's generator of rank ``rank``: seeded from
    ``(seed, rank)``, as the JAX step folds the shard's axis indices into
    its key (the streams differ from JAX's)."""
    s = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def sum_grads(grads, group) -> list:
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
