"""Instance-field (hash-grid NGP) trainer: staged rgb -> instance training
(PyTorch counterpart of ``instance_nerf_tpu.train.ngp_trainer``).

``InstanceFieldTrainer`` runs on ``device="cuda"`` unless the caller asks
for the CPU; with no CUDA device it raises. One training step renders a
batch of rays through the field (fixed-K occupancy compaction), takes the
rgb and/or instance loss, differentiates it (with ``pallas_grad`` the table
gradient is the hand-written scatter-add, kernel B3) and applies Adam.

Adam is written out to match ``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-15)``
under the JAX trainer's rules: every parameter takes part in every step, a
parameter that received no gradient sees zeros (its moments decay, and
stale momentum still moves it), and in the instance stage the gradients and
the updates outside ``inst_*`` are masked (frozen NeRF) while the moments
still decay and the step count advances. ``torch.optim.Adam`` skips
parameters without a gradient, which is another optimizer. On the card one
launch of kernel B7 (``kernels/adam_cuda.py``) updates every leaf, equal bit
for bit to its plain version, which runs on the CPU.

The JAX package scans ``steps_per_call`` steps per dispatch; here a chunk
draws its ray batches first, as the scan does, then runs its steps eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.convert import ngp_params_from_jax, unflatten_npz
from instance_nerf_tpu_torch.data.nerf_dataset import NeRFScene
from instance_nerf_tpu_torch.kernels import adam_cuda, build, scatter_cuda
from instance_nerf_tpu_torch.models.fast_encode import InstanceNGPFast, is_instance_param
from instance_nerf_tpu_torch.models.hashgrid import InstanceNGP, density_activation
from instance_nerf_tpu_torch.models.render import (
    OccupancyGrid,
    camera_rays,
    candidates,
    init_occupancy,
    render_rays,
    update_occupancy,
)
from instance_nerf_tpu_torch.parallel.mesh import forward_sum
from instance_nerf_tpu_torch.parallel.ngp_train_step import sum_grads
from instance_nerf_tpu_torch.train.timing import NO_STAGES, Stages, benchmark_ms, profile_ms


# the hand-written kernels of a field's training step (B8, B3, B7, B9), built
# together when a trainer is made on the card: one nvcc each, in parallel
FIELD_KERNELS = ("hash_encode", "scatter_add", "adam", "composite")


@dataclass
class NGPConfig:
    """The JAX package's ``NGPConfig``: the same fields and defaults."""

    # "hash" = exact shared-corner NGP encoding; "fast" = brick encoding
    encoding: str = "hash"
    n_levels: int = 16
    table_size: int = 2 ** 19
    n_features: int = 2
    base_res: int = 16
    max_res: int = 1024
    dense_res: int = 16  # fast encoding: base grid
    dense_features: int = 8
    hidden: int = 64
    num_instances: int = 33
    n_rays: int = 4096
    n_samples: int = 128
    lr: float = 1e-2
    occ_res: int = 128
    occ_update_every: int = 16
    occ_threshold: float = 0.01
    # fleets: share of the G^3 cells re-sampled a refresh (1.0 = dense)
    occ_subsample: float = 1.0
    dtype: str = "float32"  # MLP compute dtype ("bfloat16")
    instance_fg_weight: float = 5.0
    # rgb-stage background-transparency pressure (mean acc^2 over label-0 rays)
    bg_acc_weight: float = 0.0
    # fixed-K occupancy compaction (None = query all candidates)
    k_occupied: int | None = None
    # two-stage occupancy: coarse selection + fine mask on the K samples
    occ_coarse_res: int | None = None
    # adaptive-K routing: ((fraction, K), ...), rays sorted by occupancy hits,
    # the emptiest fraction compacted with the smallest K; overrides k_occupied
    k_buckets: tuple | None = None
    # ONE field query over all buckets' points
    fuse_buckets: bool = True
    # "bfloat16": the brick table read in bf16 (the f32 master and Adam stay)
    table_dtype: str | None = None
    # table gradient through the hand-written scatter-add kernel (B3)
    pallas_grad: bool = False
    # disjoint accumulator copies in that kernel
    pallas_replicas: int = 1
    # ONE stratified jitter per ray instead of per sample
    ray_jitter: bool = False


def fast_ngp_config(**overrides) -> NGPConfig:
    """NGPConfig preset for the fast encoding: 6 brick levels (32..1024),
    2^17-row tables, dense base grid, bf16 MLPs."""
    base = dict(encoding="fast", n_levels=6, table_size=2 ** 17, n_features=2,
                base_res=32, max_res=1024, dense_res=16, dense_features=8,
                dtype="bfloat16")
    base.update(overrides)
    return NGPConfig(**base)


def rays_multi(poses: torch.Tensor, views, pix, scene: NeRFScene, stage=NO_STAGES):
    """Rays for a mixed-view batch: ``poses (V, 4, 4)`` on the device, view
    and flat pixel ids per ray -> (origins (R, 3), unit dirs (R, 3)).
    ``stage`` (``train/timing.py:Stages``) uploads host ids."""
    views = stage.upload(views, poses.device)
    pix = stage.upload(pix, poses.device)
    c2w = poses[views]  # (R, 4, 4)
    fx, fy, cx, cy = (float(v) for v in scene.intrinsics)
    h, w = scene.hw
    py = (pix // w).to(torch.float32) + 0.5
    px = (pix % w).to(torch.float32) + 0.5
    dirs = torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], dim=-1)
    d = torch.einsum("rij,rj->ri", c2w[:, :3, :3], dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:, :3, 3], d


def build_model(cfg: NGPConfig, n_scenes: int | None = None):
    """The field of ``cfg``; with ``n_scenes``, a fleet of that many fields
    (parameters stacked on a leading scene axis)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
    common = dict(n_levels=cfg.n_levels, table_size=cfg.table_size,
                  n_features=cfg.n_features, base_res=cfg.base_res, max_res=cfg.max_res,
                  hidden=cfg.hidden, num_instances=cfg.num_instances, dtype=dtype,
                  pallas_grad=cfg.pallas_grad, n_scenes=n_scenes)
    if cfg.encoding == "fast":
        return InstanceNGPFast(dense_res=cfg.dense_res, dense_features=cfg.dense_features,
                               pallas_replicas=cfg.pallas_replicas,
                               table_dtype=cfg.table_dtype, **common)
    return InstanceNGP(**common)


@torch.no_grad()
def init_ngp_params(model: torch.nn.Module, seed: int) -> None:
    """Seeded random init with flax's initializers, drawn on the CPU (so a
    card run and a CPU run start from the same weights): tables
    uniform(-1e-4, 1e-4), ``Dense`` kernels lecun-normal (truncated at two
    standard deviations), zero biases. The numbers differ from JAX's. A
    fleet's scenes take consecutive draws of the one generator."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            val = torch.zeros(p.shape)
        elif name.endswith("weight"):
            # flax lecun_normal: variance 1 / fan_in, truncated normal
            std = math.sqrt(1.0 / p.shape[-1]) / 0.87962566103423978
            val = torch.nn.init.trunc_normal_(torch.empty(p.shape), std=std, a=-2 * std,
                                              b=2 * std, generator=gen)
        else:  # the tables
            val = torch.rand(p.shape, generator=gen) * 2e-4 - 1e-4
        p.copy_(val)


def partial_sums(out, target_rgb, target_inst, stage: str, cfg: NGPConfig) -> torch.Tensor:
    """The JAX step's ``_losses`` of these rays, stacked on the last axis
    (``(..., 6)``, one row per scene with a leading scene axis): the squared
    error and its element count, the weighted instance CE (log-softmax,
    targets clipped at 0, foreground weight, ``target >= 0`` valid) and its
    weight, the background ``acc^2`` and its ray count."""
    se = ((out.rgb - target_rgb) ** 2).sum(dim=(-2, -1))
    zero = torch.zeros_like(se)
    cnt = torch.full_like(se, float(target_rgb.shape[-2] * target_rgb.shape[-1]))
    ce_w = w_sum = bg_sum = bg_cnt = zero
    if stage != "rgb":
        valid = target_inst >= 0
        logp = torch.log_softmax(out.instance_logits, dim=-1)
        ce = -torch.gather(logp, -1, torch.clamp(target_inst, min=0)[..., None].long())[..., 0]
        w = torch.where(target_inst > 0, cfg.instance_fg_weight, 1.0)
        w = torch.where(valid, w, 0.0)
        ce_w, w_sum = (ce * w).sum(dim=-1), w.sum(dim=-1)
    if stage != "instance" and cfg.bg_acc_weight > 0:
        is_bg = target_inst == 0
        bg_sum = torch.where(is_bg, out.acc ** 2, 0.0).sum(dim=-1)
        bg_cnt = is_bg.sum(dim=-1).to(se.dtype)
    return torch.stack([se, cnt, ce_w, w_sum, bg_sum, bg_cnt], dim=-1)


def sums_to_losses(local: torch.Tensor, total: torch.Tensor, stage: str, cfg: NGPConfig):
    """(loss, metrics) from ``partial_sums``: the loss is the partial sums
    ``local`` over the normalisers of ``total`` (in one process ``local``
    itself; over ranks their sums, without gradient, so that the ranks'
    gradients sum to the global loss's); the metrics ``rgb`` (MSE, trained
    unless the stage is "instance"), ``instance`` (trained unless the stage
    is "rgb"), ``bg_acc`` (optional) and their ``total`` are those of
    ``total``."""
    lo, tot = local.unbind(-1), total.unbind(-1)
    se, cnt, ce_w, w_sum, bg_sum, bg_cnt = tot
    zero = torch.zeros_like(se)
    rgb = se / cnt
    loss = lo[0] / cnt if stage != "instance" else zero
    metrics = {"rgb": rgb}
    mtotal = rgb if stage != "instance" else zero
    if stage != "rgb":
        w = torch.clamp(w_sum, min=1)
        metrics["instance"] = ce_w / w
        loss = loss + lo[2] / w
        mtotal = mtotal + ce_w / w
    if stage != "instance" and cfg.bg_acc_weight > 0:
        c = torch.clamp(bg_cnt, min=1)
        metrics["bg_acc"] = bg_sum / c
        loss = loss + cfg.bg_acc_weight * lo[4] / c
        mtotal = mtotal + cfg.bg_acc_weight * bg_sum / c
    metrics["total"] = mtotal
    return loss, metrics


SAMPLING_FIELDS = {"k_buckets", "k_occupied", "n_samples", "ray_jitter", "occ_coarse_res",
                   "fuse_buckets"}


def sampling(cfg: NGPConfig) -> dict:
    """``render_rays``' sampling keywords: the ``SAMPLING_FIELDS`` of ``cfg``."""
    return {f: getattr(cfg, f) for f in SAMPLING_FIELDS}


def field_loss_and_grads(model, cfg: NGPConfig, stage: str, occ: OccupancyGrid, o, d,
                         target_rgb, target_inst, *, generator=None, jitter=None,
                         stratified: bool = True, stages=NO_STAGES, group=None, route=None):
    """The JAX step's losses and gradients of one ray batch through the field
    ``model`` with the sampling of ``cfg``: one scene's rays ``(R, 3)``, or a
    fleet's ``(B, R, 3)`` and grids ``(B, G, G, G)``, whose loss is the SUM
    over scenes (each scene's gradient its own). Returns (the detached
    metrics of ``sums_to_losses``, ``(B,)`` for a fleet; ``{param name: grad
    or None}``). The stratified draws come from ``generator`` or are
    ``jitter``; ``stages`` opens the step's spans.

    ``group``: the rays are split over its ranks (``o`` this rank's block):
    the partial sums are summed over the group in the forward, each rank's
    loss is its numerators over the global normalisers, and the gradients
    are SUMmed over the group. ``route`` (``ngp_train_step.group_route``)
    routes ``k_buckets`` over each scene's whole ray batch."""
    with_instance = stage != "rgb"
    out = render_rays(lambda x, v: model(x, v, with_instance, stages), o, d, occ=occ,
                      stratified=stratified, with_instance=with_instance, generator=generator,
                      jitter=jitter, stage=stages, route=route, **sampling(cfg))
    with stages("composite_loss"):
        local = partial_sums(out, target_rgb, target_inst, stage, cfg)
        total = local.detach() if group is None else forward_sum(local, group=group)
        loss, metrics = sums_to_losses(local, total, stage, cfg)
        loss = loss.sum()
    with stages("backward"):
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    if group is not None:
        with stages("allreduce"):
            grads = sum_grads(grads, group)
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def adam_init(model: torch.nn.Module) -> dict:
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return {"count": 0, "mu": zeros, "nu": {n: torch.zeros_like(p) for n, p in zeros.items()}}


@torch.no_grad()
def adam_update(model: torch.nn.Module, grads: dict, st: dict, stage: str, lr: float) -> None:
    """One optax-style Adam step over every parameter of ``model`` in place
    (see the module docstring for the masking rules); a fleet's stacked
    parameters update elementwise with the one shared count. CUDA
    parameters go through kernel B7 (``adam_cuda.adam_step``, one launch for
    every leaf), CPU parameters through ``adam_cuda.adam_update_plain``."""
    names, params = zip(*model.named_parameters())
    st["count"] += 1
    frozen = [stage == "instance" and not is_instance_param(n) for n in names]
    step = adam_cuda.adam_update_plain if params[0].device.type == "cpu" else adam_cuda.adam_step
    step(params, [None if f else grads.get(n) for n, f in zip(names, frozen)],
         [st["mu"][n] for n in names], [st["nu"][n] for n in names], frozen, st["count"], lr)


def replace_sampling(cfg: NGPConfig, overrides: dict) -> NGPConfig:
    """``cfg`` with sampler fields swapped; any other field raises."""
    bad = set(overrides) - SAMPLING_FIELDS
    if bad:
        raise ValueError(f"set_sampling: not sampler fields: {bad}")
    return dataclasses.replace(cfg, **overrides)


def chunk_sizes(steps: int, stage: str, cfg: NGPConfig, steps_per_call: int | None):
    """The steps of each call of a training loop: ``steps_per_call``
    (default ``occ_update_every``), outside the instance stage at most
    ``occ_update_every``, so that an occupancy refresh can land after every
    ``occ_update_every`` steps; the last call takes the rest."""
    spc = steps_per_call or cfg.occ_update_every
    if stage != "instance":
        spc = min(spc, cfg.occ_update_every)
    done = 0
    while done < steps:
        k = min(spc, steps - done)
        done += k
        yield k, done, spc


class InstanceFieldTrainer:
    def __init__(self, cfg: NGPConfig | None = None, seed: int = 0, device="cuda"):
        self.cfg = cfg = cfg or NGPConfig()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            build.build_all(FIELD_KERNELS)
            if cfg.dtype != "bfloat16":
                # f32 means f32: no TF32 in the MLP matmuls
                torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg)
        init_ngp_params(self.model, seed)
        self.model.to(self.device)
        self.np_rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.opt_state = adam_init(self.model)
        self.occ = init_occupancy(cfg.occ_res, cfg.occ_threshold, self.device)
        # the step's stages: profiler ranges ``field.<name>``
        self._stage = Stages("field")

    # -- state ----------------------------------------------------------------

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def load_jax_params(self, npz_or_tree, occ_grid=None):
        """Load a flax ``InstanceNGP`` / ``InstanceNGPFast`` params tree (nested
        dict of arrays, or an ``.npz`` keyed by the tree paths joined by
        ``/``) and optionally an occupancy grid (numpy ``(G, G, G)``). The
        Adam state is left as it is."""
        tree = npz_or_tree
        if isinstance(tree, (str, os.PathLike)):
            with np.load(tree) as z:
                tree = unflatten_npz({k: z[k] for k in z.files})
        self.model.load_state_dict(ngp_params_from_jax(tree), strict=True)
        if occ_grid is not None:
            self.occ = OccupancyGrid(
                torch.as_tensor(np.asarray(occ_grid), dtype=torch.float32,
                                device=self.device), self.cfg.occ_threshold)

    # -- one step -------------------------------------------------------------

    def render(self, o, d, with_instance: bool, stratified: bool = True, jitter=None):
        """``render_rays`` with the config's sampling, the trainer's field,
        occupancy and generator (or the given ``jitter`` draws)."""
        stage = self._stage
        return render_rays(lambda xyz, vd: self.model(xyz, vd, with_instance, stage), o, d,
                           occ=self.occ, stratified=stratified, with_instance=with_instance,
                           generator=self.gen, jitter=jitter, stage=stage,
                           **sampling(self.cfg))

    def loss_and_grads(self, stage: str, o, d, target_rgb, target_inst, jitter=None):
        """Losses (``field_loss_and_grads``' and ``psnr``) and ``{name: grad
        or None}`` of one batch. ``jitter`` replaces the stratified draws."""
        target_rgb = self._stage.upload(target_rgb, self.device, torch.float32)
        target_inst = self._stage.upload(target_inst, self.device)
        losses, grads = field_loss_and_grads(self.model, self.cfg, stage, self.occ, o, d,
                                             target_rgb, target_inst, generator=self.gen,
                                             jitter=jitter, stages=self._stage)
        losses["psnr"] = -10.0 * torch.log10(torch.clamp(losses["rgb"], min=1e-8))
        return losses, grads

    def apply_grads(self, stage: str, grads: dict) -> None:
        """One optax-style Adam step over every parameter (see the module
        docstring for the masking rules)."""
        with self._stage("adam"):
            adam_update(self.model, grads, self.opt_state, stage, self.cfg.lr)

    def train_step(self, stage: str, o, d, target_rgb, target_inst, jitter=None) -> dict:
        """One training step; returns the losses (tensors, no host sync)."""
        losses, grads = self.loss_and_grads(stage, o, d, target_rgb, target_inst, jitter)
        self.apply_grads(stage, grads)
        return losses

    @torch.no_grad()
    def sigma(self, xyz):
        sigma_raw, _ = self.model.query(xyz, self._stage)
        return density_activation(sigma_raw)

    @torch.no_grad()
    def update_occupancy(self, jitter=None) -> None:
        with self._stage("occ_update"):
            self.occ = update_occupancy(self.occ, self.sigma, generator=self.gen,
                                        jitter=jitter)

    def _batch(self, scene: NeRFScene, poses: torch.Tensor, drawn=None):
        """The next ray batch of ``scene`` from the trainer's numpy stream
        (or the ``drawn`` one) on the device."""
        if drawn is None:
            with self._stage("draw"):
                drawn = scene.ray_batch(self.np_rng, self.cfg.n_rays)
        v, pix, rgb, inst = drawn
        if inst is None:
            inst = np.zeros((self.cfg.n_rays,), np.int32)
        with self._stage("rays"):
            o, d = rays_multi(poses, v, pix, scene, self._stage)
            rgb_t = self._stage.upload(rgb, self.device)
            inst_t = self._stage.upload(inst, self.device)
        return o, d, rgb_t, inst_t

    # -- training -------------------------------------------------------------

    def set_sampling(self, **overrides) -> None:
        """Swap sampler fields (``k_buckets``, ``k_occupied``, ``n_samples``,
        ``ray_jitter``, ``occ_coarse_res``, ``fuse_buckets``) mid-run, keeping
        params, Adam state and occupancy; any other field raises."""
        self.cfg = replace_sampling(self.cfg, overrides)

    @torch.no_grad()
    def measure_hits(self, scene: NeRFScene, n_rays: int | None = None, seed: int = 0,
                     generator=None, jitter=None) -> np.ndarray:
        """Per-ray occupancy hit counts of the candidate samples on a ray
        batch of ``scene`` (drawn with ``default_rng(seed)``) under the
        current grid, 0 for rays that miss the cube: the input of
        ``choose_k_buckets``. The stratified draws come from ``generator``
        (default: one seeded with ``seed``) or are ``jitter``."""
        cfg = self.cfg
        n = n_rays or cfg.n_rays
        v, pix, _, _ = scene.ray_batch(np.random.default_rng(seed), n)
        poses = torch.as_tensor(scene.poses, dtype=torch.float32, device=self.device)
        o, d = rays_multi(poses, v, pix, scene)
        if jitter is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        c = candidates(o, d, cfg.n_samples, self.occ, True, cfg.occ_coarse_res,
                       cfg.ray_jitter, generator, jitter)
        return torch.where(c.valid, c.occupied.sum(-1), 0.0).cpu().numpy()

    def train(self, scene: NeRFScene, steps: int, stage: str = "rgb",
              log_every: int = 100, log=print, steps_per_call: int | None = None) -> dict:
        """Staged training loop in calls of ``steps_per_call`` steps (see
        ``chunk_sizes``): each call draws its ray batches from the numpy
        stream first, in the order single steps draw them, then steps.
        Outside the instance stage the occupancy grid is refreshed after a
        call that ends on a multiple of ``occ_update_every``, as the JAX
        trainer does. The host ray draws of a call open the ``draw`` span,
        and reading the metrics back a ``wait`` span."""
        cfg = self.cfg
        poses = self._stage.upload(scene.poses, self.device, torch.float32)
        t0 = time.time()
        last = {}
        for k, done, spc in chunk_sizes(steps, stage, cfg, steps_per_call):
            with self._stage("draw"):
                drawn = [scene.ray_batch(self.np_rng, cfg.n_rays) for _ in range(k)]
            for batch in drawn:
                last = self.train_step(stage, *self._batch(scene, poses, batch))
            if stage != "instance" and done % cfg.occ_update_every == 0:
                self.update_occupancy()
            if log_every and (done % log_every < spc or done >= steps):
                rate = cfg.n_rays * done / (time.time() - t0)
                log(f"[{stage}] step {done}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in self._read_back(last).items())
                    + f" ({rate:.0f} rays/s)")
        return self._read_back(last)

    def _read_back(self, losses: dict) -> dict:
        return self._stage.read_back({k: v for k, v in losses.items() if k != "total"})

    @contextlib.contextmanager
    def _restored(self):
        """Run a timing loop, then put params, Adam state, occupancy and the
        random streams back as they were."""
        params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        opt = {"count": self.opt_state["count"],
               "mu": {k: v.clone() for k, v in self.opt_state["mu"].items()},
               "nu": {k: v.clone() for k, v in self.opt_state["nu"].items()}}
        occ, gen_state = self.occ, self.gen.get_state()
        np_state = self.np_rng.bit_generator.state
        try:
            yield
        finally:
            self.model.load_state_dict(params)
            self.opt_state, self.occ = opt, occ
            self.gen.set_state(gen_state)
            self.np_rng.bit_generator.state = np_state

    def _synthetic_rays(self, seed: int):
        """The JAX benchmark's rays: origins on a sphere of radius 1.5 around
        the cube's center, aimed at it with noise; random targets."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        o = rng.normal(size=(cfg.n_rays, 3))
        o = 0.5 + 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = np.asarray([0.5, 0.5, 0.5]) - o + 0.1 * rng.normal(size=o.shape)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        rgb = rng.uniform(size=(cfg.n_rays, 3))
        inst = rng.integers(0, cfg.num_instances, cfg.n_rays)
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=self.device)
        return t(o), t(d), t(rgb), t(inst, torch.int64), rng

    def benchmark_train(self, reps: int = 30, stage: str = "instance",
                        occupancy: float = 1.0, seed: int = 0, warmup: int = 3) -> dict:
        """Train-step throughput on the JAX benchmark's synthetic rays, timed
        with CUDA events (each step consumes the previous step's params):
        median ms over ``reps`` warmed steps, rays/s, peak device memory and
        scatter-add launches per step. ``occupancy`` < 1 replaces the grid
        by a random one with that occupied share. The trainer's state is
        restored afterwards."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        cfg = self.cfg
        o, d, rgb, inst, rng = self._synthetic_rays(seed)
        with self._restored():
            if occupancy < 1.0:
                g = cfg.occ_res
                occ = torch.as_tensor(rng.uniform(size=(g, g, g)) < occupancy,
                                      device=self.device)
                self.occ = OccupancyGrid(torch.where(occ, 1e3, 0.0), cfg.occ_threshold)
            step = lambda: self.train_step(stage, o, d, rgb, inst)
            before = scatter_cuda.scatter_add.launches
            out = benchmark_ms(step, self.device, reps=reps, warmup=warmup)
            launched = scatter_cuda.scatter_add.launches - before
        out.update(step_ms=out["median_ms"], rays_per_s=cfg.n_rays / out["median_ms"] * 1e3,
                   stage=stage, scatter_add_launches_per_step=launched / (reps + warmup))
        return out

    def profile(self, scene: NeRFScene, stage: str = "rgb", reps: int = 5,
                warmup: int = 2, top: int = 12) -> dict:
        """Where a training step's time goes (``train/timing.py:profile_ms``),
        by stage: rays, occupancy, compact, encode, mlp, composite_loss,
        backward, adam; plus one occupancy refresh (``occ_update``), which the
        rgb stage runs every ``occ_update_every`` steps. The trainer's state
        is restored afterwards."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        poses = torch.as_tensor(scene.poses, dtype=torch.float32, device=self.device)
        with self._restored():
            prof = profile_ms(lambda: self.train_step(stage, *self._batch(scene, poses)),
                              self.device, self._stage, reps=reps, warmup=warmup, top=top,
                              watch=("scatter_add",))
            occ = benchmark_ms(self.update_occupancy, self.device, reps=2, warmup=1)
        prof["occ_update_ms"] = occ["median_ms"]
        prof["occ_update_ms_per_step"] = occ["median_ms"] / self.cfg.occ_update_every
        prof["stage"] = stage
        return prof

    # -- inference ------------------------------------------------------------

    @torch.no_grad()
    def render_image(self, pose, intrinsics, hw, chunk: int = 8192,
                     with_instance: bool = True) -> dict:
        """Full-image render with the same fixed-K compacted integration the
        field was trained through, no jitter -> dict(rgb (H, W, 3), depth,
        acc, instance (H, W)) as numpy."""
        h, w = hw
        o, d = camera_rays(torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                                           device=self.device), intrinsics, hw)
        outs = {"rgb": [], "depth": [], "acc": [], "instance": []}
        for s in range(0, h * w, chunk):
            out = self.render(o[s:s + chunk], d[s:s + chunk], with_instance,
                              stratified=False)
            outs["rgb"].append(out.rgb.float())
            outs["depth"].append(out.depth)
            outs["acc"].append(out.acc)
            if with_instance:
                outs["instance"].append(torch.argmax(out.instance_logits, dim=-1))
        shapes = {"rgb": (h, w, 3), "depth": (h, w), "acc": (h, w), "instance": (h, w)}
        return {k: torch.cat(v).reshape(shapes[k]).cpu().numpy()
                for k, v in outs.items() if v}

    @torch.no_grad()
    def extract_rgbsigma(self, resolution, chunk: int = 2 ** 16) -> np.ndarray:
        """Sample the field on a regular grid -> (W, L, H, 4) raw RGBσ, the
        detector's input features (view direction (0, 0, -1))."""
        if isinstance(resolution, int):
            resolution = (resolution,) * 3
        axes = [(torch.arange(n, dtype=torch.float32, device=self.device) + 0.5) / n
                for n in resolution]
        gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
        xyz = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=-1)
        vd = torch.tensor([0.0, 0.0, -1.0], device=self.device)
        out = torch.empty((xyz.shape[0], 4), dtype=torch.float32, device=self.device)
        for s in range(0, xyz.shape[0], chunk):
            pts = xyz[s:s + chunk]
            sigma_raw, geo = self.model.query(pts)
            out[s:s + chunk, :3] = self.model.color(geo, vd.expand(pts.shape)).float()
            out[s:s + chunk, 3] = sigma_raw.float()
        return out.reshape(*resolution, 4).cpu().numpy()
