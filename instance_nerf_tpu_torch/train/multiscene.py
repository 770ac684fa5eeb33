"""Multi-scene (fleet) instance-field training on one card (PyTorch
counterpart of ``instance_nerf_tpu.train.multiscene``; BASELINE config #5).

B scenes' fields advance in lock-step through one batched field
(``build_model(cfg, n_scenes=B)``): per-scene parameters and occupancy
grids stacked on a leading scene axis, the tables one ``(B * L * T, W)``
table (with ``pallas_grad`` one launch of kernel B3 a step for the whole
fleet), ``cfg.n_rays`` rays per scene a step. The step is the single
scene's (``ngp_trainer.field_loss_and_grads``, then ``adam_update`` with
one shared count). The ray batches are drawn as the JAX trainer draws
them: on the host from one numpy stream (``_batch``, and ``_scan_batch``
for a call of several steps), or, with ``device_data``, from the images
and masks kept on the card (uint8 / int8) with a ``torch.Generator``.

``save(background=True)`` snapshots the state on the card at call time
(the optimizer updates the live tensors in place) and writes it from a
thread while training goes on.

Over a process group (``torchrun``, or a given ``mesh``) the fleet is the
JAX trainer's over its mesh, ``make_mesh(n_data=min(B, n), n_spatial=n //
min(B, n))``: the scenes split in contiguous blocks over the data ranks,
each rank's batched field holding its B / n_data scenes (one launch of B3
over them a step, no gradient collective). With fewer scenes than ranks
each scene's rays split over its ``sp`` group, which sums the scene's
losses and gradients and routes ``k_buckets`` over the scene's whole ray
batch (``parallel/ngp_train_step.py:group_route``). Every draw (rays,
jitter, occupancy refresh) is the whole fleet's, each rank taking its
block, so a split fleet trains as the one-card fleet; occupancy refreshes
stay per rank. ``save`` gathers the fleet to rank 0, which writes the
one-card layout; ``restore`` gives each rank its block.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.data.nerf_dataset import NeRFScene
from instance_nerf_tpu_torch.kernels import build, scatter_cuda
from instance_nerf_tpu_torch.models.hashgrid import density_activation
from instance_nerf_tpu_torch.models.render import OccupancyGrid, occupancy_cells
from instance_nerf_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    barrier,
    distributed,
    is_main,
    launched_world,
    make_mesh,
    under_launcher,
)
from instance_nerf_tpu_torch.parallel.ngp_train_step import group_route
from instance_nerf_tpu_torch.train.ngp_trainer import (
    FIELD_KERNELS,
    NGPConfig,
    adam_init,
    adam_update,
    build_model,
    chunk_sizes,
    fast_ngp_config,
    field_loss_and_grads,
    init_ngp_params,
)
from instance_nerf_tpu_torch.train.timing import Stages, profile_ms

# points a fleet's occupancy refresh queries at once (all scenes together)
OCC_QUERY_POINTS = 2 ** 21


class MultiSceneFieldTrainer:
    """Train B scenes' instance fields as one batched field on
    ``device`` ("cuda" unless the caller asks for the CPU). ``cfg.n_rays``
    is the PER-SCENE ray batch; the scenes share one image size."""

    def __init__(self, scenes: Sequence[NeRFScene], cfg: NGPConfig | None = None,
                 seed: int = 0, device_data: bool = False, device="cuda", mesh=None):
        self.all_scenes = list(scenes)
        b = self.n_global = len(self.all_scenes)
        self.cfg = cfg = cfg or fast_ngp_config(n_rays=1024)
        self.device = resolve_device(device)
        if mesh is None and under_launcher():
            n = launched_world()
            mesh = make_mesh(n_data=min(b, n), n_spatial=max(1, n // min(b, n)),
                             device=self.device)
        self.mesh = mesh
        self._split = mesh is not None and distributed()
        self._sl, self._rl = slice(0, b), slice(0, cfg.n_rays)
        if self._split:
            if mesh.used < mesh.world:  # on every rank, so that none waits for the others
                raise ValueError(f"a fleet of {b} scenes on {mesh.world} ranks leaves "
                                 f"{mesh.world - mesh.used} idle: launch a multiple of "
                                 "min(B, ranks)")
            if b % mesh.data_size:
                raise ValueError(f"a fleet of {b} scenes does not split over "
                                 f"{mesh.data_size} data ranks")
            if cfg.n_rays % mesh.n_spatial:
                raise ValueError(f"n_rays {cfg.n_rays} does not split over {mesh.n_spatial} "
                                 "ranks a scene")
            per, r = b // mesh.data_size, cfg.n_rays // mesh.n_spatial
            self._sl = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            self._rl = slice(mesh.sp_index * r, (mesh.sp_index + 1) * r)
            self.device = mesh.device
        self.scenes = self.all_scenes[self._sl]
        b = len(self.scenes)
        if self.device.type == "cuda":
            build.build_all(FIELD_KERNELS)
            if cfg.dtype != "bfloat16":
                torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        self.model = build_model(cfg, n_scenes=b)
        if self._split:  # the whole fleet's init, this rank's block of it
            full = build_model(cfg, n_scenes=self.n_global)
            init_ngp_params(full, seed)
            self.model.load_state_dict({k: v[self._sl] for k, v in full.state_dict().items()})
            del full
        else:
            init_ngp_params(self.model, seed)  # each scene drawn in turn from one generator
        self.model.to(self.device)
        self.opt_state = adam_init(self.model)
        g = cfg.occ_res
        self.occ_grids = torch.full((b, g, g, g), 1e3, device=self.device)
        self.np_rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._stage = Stages("fleet")
        self._save_thread = None
        self._save_error = None
        self._build_ray_index()
        self.device_data = device_data
        if device_data:
            self._stage_device_data()

    # -- data ------------------------------------------------------------------

    def _build_ray_index(self):
        """The scenes' poses, pixels and targets concatenated, for a
        vectorized (B, R) batch; scenes may differ in view count, not in
        image size."""
        hw0 = self.scenes[0].hw
        if not all(tuple(s.hw) == tuple(hw0) for s in self.all_scenes):
            raise ValueError("a multi-scene fleet needs one common image resolution")
        self._hw = hw0
        hwprod = hw0[0] * hw0[1]
        self._nview_all = np.asarray([s.num_views for s in self.all_scenes])
        self._nview = self._nview_all[self._sl]
        self._pose_off = np.concatenate([[0], np.cumsum(self._nview)[:-1]]).astype(np.int64)
        self._pix_off = self._pose_off * hwprod
        self._rgb_all = np.concatenate([np.asarray(s.images, np.float32).reshape(-1, 3)
                                        for s in self.scenes])
        if all(s.masks is not None for s in self.scenes):
            self._inst_all = np.concatenate([np.asarray(s.masks).reshape(-1)
                                             for s in self.scenes]).astype(np.int32)
        else:
            self._inst_all = None
        vmax = int(self._nview.max())
        poses = np.zeros((len(self.scenes), vmax, 4, 4), np.float32)
        for i, s in enumerate(self.scenes):
            poses[i, : self._nview[i]] = np.asarray(s.poses, np.float32)
        self._poses_dev = torch.as_tensor(poses, device=self.device)  # (B, Vmax, 4, 4)
        self._intr_dev = torch.as_tensor(
            np.stack([np.asarray(s.intrinsics, np.float32) for s in self.scenes]),
            device=self.device)

    @staticmethod
    def fleet_data_bytes(n_scenes: int, n_views: int, hw, with_masks=True) -> int:
        """Device bytes of the ``device_data`` store (uint8 images + int8
        masks)."""
        return n_scenes * n_views * hw[0] * hw[1] * (3 + (1 if with_masks else 0))

    def _stage_device_data(self):
        """The fleet's images (uint8) and masks (int8, -1 past a scene's
        views) on the card, view-padded to the largest view count."""
        b = len(self.scenes)
        h, w = self._hw
        vmax = int(self._nview.max())
        imgs = np.zeros((b, vmax, h * w, 3), np.uint8)
        for i, s in enumerate(self.scenes):
            im = np.asarray(s.images, np.float32).reshape(-1, h * w, 3)
            imgs[i, : self._nview[i]] = np.round(np.clip(im, 0.0, 1.0) * 255.0).astype(np.uint8)
        self._imgs_dev = torch.as_tensor(imgs, device=self.device)
        if self._inst_all is not None:
            if self.cfg.num_instances > 127:
                raise ValueError("the int8 mask store holds at most 127 instances")
            masks = np.full((b, vmax, h * w), -1, np.int8)
            for i, s in enumerate(self.scenes):
                masks[i, : self._nview[i]] = np.asarray(s.masks, np.int64).reshape(
                    -1, h * w).astype(np.int8)
            self._masks_dev = torch.as_tensor(masks, device=self.device)
        else:
            self._masks_dev = None
        self._nview_dev = torch.as_tensor(self._nview, device=self.device)

    def _rays(self, v, pix):
        """Rays ``(B, R, 3)`` of view ids and flat pixel ids ``(B, R)`` on the
        device: the JAX trainer's pose gather and direction math, in f32."""
        h, w = self._hw
        bidx = torch.arange(len(self.scenes), device=self.device)[:, None]
        c2w = self._poses_dev[bidx, v]  # (B, R, 4, 4)
        intr = self._intr_dev
        fx, fy, cx, cy = (intr[:, i, None] for i in range(4))
        py = (pix // w).to(torch.float32) + 0.5
        px = (pix % w).to(torch.float32) + 0.5
        dirs = torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], dim=-1)
        d = torch.einsum("brij,brj->bri", c2w[..., :3, :3], dirs)
        # numpy's norm (an f32 sum, then a correctly rounded sqrt, which
        # torch's f32 sqrt on the CPU is not): ``_batch`` equals JAX's bit for bit
        norm = (d * d).sum(dim=-1, keepdim=True).double().sqrt().float()
        return c2w[..., :3, 3], d / norm

    def _batch(self):
        """The next ``(B, R, ...)`` host batch (o, d, rgb, inst): views,
        pixels and targets drawn in numpy exactly as the JAX trainer's
        ``_batch``, the rays computed from them by ``_rays`` on the device."""
        b, r = self.n_global, self.cfg.n_rays
        h, w = self._hw
        with self._stage("draw"):
            v = (self.np_rng.random((b, r)) * self._nview_all[:, None]).astype(np.int64)
            pix = self.np_rng.integers(0, h * w, (b, r))
            v, pix = v[self._sl, self._rl], pix[self._sl, self._rl]
            b, r = v.shape
            lin = self._pix_off[:, None] + v * (h * w) + pix
            rgb = self._rgb_all[lin].astype(np.float32)
            inst = (self._inst_all[lin] if self._inst_all is not None
                    else np.zeros((b, r), np.int32))
        up = self._stage.upload
        with self._stage("rays"):
            o, d = self._rays(up(v, self.device), up(pix, self.device))
            return [o, d, up(rgb, self.device), up(inst, self.device)]

    def _scan_batch(self, k: int):
        """A call's ``(K, B, R)`` view and pixel draws and targets, in the
        JAX trainer's ``_scan_batch`` order (all views, then all pixels)."""
        b, r = self.n_global, self.cfg.n_rays
        h, w = self._hw
        with self._stage("draw"):
            v = (self.np_rng.random((k, b, r)) * self._nview_all[None, :, None]).astype(np.int32)
            pix = self.np_rng.integers(0, h * w, (k, b, r)).astype(np.int32)
            v, pix = v[:, self._sl, self._rl], pix[:, self._sl, self._rl]
            b, r = v.shape[1:]
            lin = self._pix_off[None, :, None] + v.astype(np.int64) * (h * w) + pix
            rgb = self._rgb_all[lin].astype(np.float32)
            inst = (self._inst_all[lin].astype(np.int32) if self._inst_all is not None
                    else np.zeros((k, b, r), np.int32))
        with self._stage("rays"):
            return [self._stage.upload(x, self.device) for x in (v, pix, rgb, inst)]

    def _device_batch(self):
        """One batch drawn on the card from the ``device_data`` store."""
        b, r = self.n_global, self.cfg.n_rays
        h, w = self._hw
        with self._stage("rays"):
            u = torch.rand((b, r), generator=self.gen, device=self.device)[self._sl, self._rl]
            v = torch.minimum((u * self._nview_dev[:, None]).long(), self._nview_dev[:, None] - 1)
            pix = torch.randint(0, h * w, (b, r), generator=self.gen,
                                device=self.device)[self._sl, self._rl]
            b = v.shape[0]
            bidx = torch.arange(b, device=self.device)[:, None]
            rgb = self._imgs_dev[bidx, v, pix].to(torch.float32) / 255.0
            inst = (self._masks_dev[bidx, v, pix].to(torch.int32) if self._masks_dev is not None
                    else torch.zeros((b, r), dtype=torch.int32, device=self.device))
            o, d = self._rays(v, pix)
        return o, d, rgb, inst

    # -- steps -----------------------------------------------------------------

    def loss_and_grads(self, stage: str, o, d, target_rgb, target_inst, jitter=None):
        """This rank's scenes' losses ``{name: (B,)}`` and gradients
        (``field_loss_and_grads``); a split fleet's stratified draws are its
        block of the whole fleet's."""
        cfg, mesh = self.cfg, self.mesh
        group = route = None
        if self._split:
            if jitter is None:
                shape = (self.n_global, cfg.n_rays, 1 if cfg.ray_jitter else cfg.n_samples)
                jitter = torch.rand(shape, generator=self.gen,
                                    device=self.device)[self._sl, self._rl]
            if mesh.n_spatial > 1:
                group = mesh.sp_group
                if cfg.k_buckets:
                    route = group_route(cfg.k_buckets, group, mesh.n_spatial, mesh.sp_index)
        return field_loss_and_grads(self.model, cfg, stage,
                                    OccupancyGrid(self.occ_grids, cfg.occ_threshold), o, d,
                                    target_rgb, target_inst, generator=self.gen, jitter=jitter,
                                    stages=self._stage, group=group, route=route)

    def train_step(self, stage: str, o, d, target_rgb, target_inst, jitter=None) -> dict:
        """One fleet step, updating the parameters and Adam state in place;
        the metrics are the means over the fleet's scenes (tensors, no host
        sync)."""
        losses, grads = self.loss_and_grads(stage, o, d, target_rgb, target_inst, jitter)
        with self._stage("adam"):
            adam_update(self.model, grads, self.opt_state, stage, self.cfg.lr)
        if not self._split:
            return {k: v.mean() for k, v in losses.items()}
        keys = list(losses)
        sums = all_reduce_sum([torch.stack([losses[k].sum() for k in keys])],
                              group=self.mesh.data_group)[0]
        return dict(zip(keys, sums / self.n_global))

    def train(self, steps: int, stage: str = "rgb", log_every: int = 100, log=print,
              steps_per_call: int | None = None) -> dict:
        """Fleet training loop in calls of ``steps_per_call`` steps (see
        ``ngp_trainer.chunk_sizes``). A full call of more than one step
        draws on the card with ``device_data``, else its batches at once
        (``_scan_batch``); other steps draw one host batch each
        (``_batch``), as the JAX trainer's scan and remainder paths do.
        Outside the instance stage the occupancy refresh follows every call
        that ends on a multiple of ``occ_update_every``. Host draws open the
        ``draw`` span, and reading the metrics back a ``wait`` span."""
        cfg = self.cfg
        t0 = time.time()
        last = {}
        for k, done, spc in chunk_sizes(steps, stage, cfg, steps_per_call):
            if spc > 1 and k == spc:
                if self.device_data:
                    batches = (self._device_batch() for _ in range(k))
                else:
                    v, pix, rgb, inst = self._scan_batch(k)
                    batches = ((*self._rays(v[j], pix[j]), rgb[j], inst[j]) for j in range(k))
            else:
                batches = (self._batch() for _ in range(k))
            for batch in batches:
                last = self.train_step(stage, *batch)
            if done % cfg.occ_update_every == 0 and stage != "instance":
                self.update_occupancy()
            if log_every and (done % log_every < spc or done >= steps) and is_main():
                rate = self.n_global * cfg.n_rays * done / (time.time() - t0)
                log(f"[ms-{stage}] step {done}: " + " ".join(
                    f"{k2}={v:.4f}" for k2, v in self._stage.read_back(last).items())
                    + f" ({rate:.0f} rays/s aggregate)")
        return self._stage.read_back(last)

    @torch.no_grad()
    def sigma(self, xyz: torch.Tensor) -> torch.Tensor:
        """Density ``(B, M)`` of each scene's field at ``xyz (B, M, 3)``, in
        chunks of ``OCC_QUERY_POINTS`` points over the fleet."""
        b, m = xyz.shape[:2]
        step = max(1, OCC_QUERY_POINTS // b)
        return torch.cat([density_activation(self.model.query(xyz[:, i:i + step],
                                                              self._stage)[0]).float()
                          for i in range(0, m, step)], dim=1)

    @torch.no_grad()
    def update_occupancy(self, cells=None, jitter=None) -> None:
        """The fleet's occupancy refresh. Dense (``occ_subsample >= 1``):
        every cell re-sampled at a jittered point, ``max(0.95 grid, sigma)``.
        Subsampled: ``M = int(G^3 occ_subsample)`` random cells a scene
        (``cells (B, M)``, repeats allowed), their densities scatter-maxed
        into the 0.95-decayed grid. ``cells`` and ``jitter`` (``(B, M, 3)``
        uniforms) replace the draws from the trainer's generator."""
        cfg = self.cfg
        g, b = cfg.occ_res, len(self.scenes)
        dev = self.device
        with self._stage("occ_update"):
            if cfg.occ_subsample >= 1.0:
                coords = occupancy_cells(g, dev)[None].expand(b, -1, -1)
            else:
                m = max(1, int(g ** 3 * cfg.occ_subsample))
                if cells is None:
                    cells = torch.randint(0, g ** 3, (self.n_global, m), generator=self.gen,
                                          device=dev)[self._sl]
                cells = self._stage.upload(cells, dev).long()
                coords = torch.stack([cells // (g * g), (cells // g) % g, cells % g], dim=-1)
            if jitter is None:
                jitter = torch.rand((self.n_global, *coords.shape[1:]), generator=self.gen,
                                    device=dev)[self._sl]
            xyz = (coords.to(torch.float32) + self._stage.upload(jitter, dev)) / g
            sig = self.sigma(xyz)  # (B, M)
            flat = self.occ_grids.reshape(b, g ** 3) * 0.95
            if cfg.occ_subsample >= 1.0:
                flat = torch.maximum(flat, sig)
            else:  # repeated cells are fine under max
                flat.scatter_reduce_(1, cells, sig, "amax")
            self.occ_grids = flat.reshape(b, g, g, g)

    def scene_params(self, i: int) -> dict:
        """Scene ``i``'s parameters, named as the single-scene field's (for
        ``InstanceFieldTrainer.model.load_state_dict``)."""
        return {k: v[i].detach().clone() for k, v in self.model.state_dict().items()}

    # -- checkpoints -----------------------------------------------------------

    def _state(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.opt_state,
                "occ_grids": self.occ_grids}

    def save(self, path: str, step: int = 0, metrics=None, background: bool = False) -> None:
        """Checkpoint the whole fleet (stacked params, Adam moments and count,
        occupancy grids) through ``train/checkpoints.py``; a restore is
        bit-exact. ``background``: the state is copied on the card now and
        written from a thread while training goes on; a later save, restore
        or ``wait_for_save`` joins it first (and raises what it raised).
        A split fleet is gathered to rank 0 at call time (every rank calls
        ``save``), and rank 0 writes the one-card layout."""
        from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

        self.wait_for_save()
        opt = self.opt_state
        snap = {"params": {k: self._gather(v) for k, v in self.model.state_dict().items()},
                "opt_state": {"count": opt["count"],
                              "mu": {k: self._gather(v) for k, v in opt["mu"].items()},
                              "nu": {k: self._gather(v) for k, v in opt["nu"].items()}},
                "occ_grids": self._gather(self.occ_grids)}
        config = {"n_scenes": self.n_global}

        def write():
            host = _to_cpu(snap)
            CheckpointManager(path, keep=2).save(step, host, config=config,
                                                 metrics=metrics or {})

        if not is_main():
            return
        if not background:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:  # raised again by wait_for_save
                self._save_error = e

        self._save_thread = threading.Thread(target=run, name="fleet-ckpt-save", daemon=True)
        self._save_thread.start()

    def wait_for_save(self) -> None:
        """Join an in-flight background save (a no-op if none), raising its
        error if it failed."""
        t, self._save_thread = self._save_thread, None
        if t is not None:
            t.join()
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("the background checkpoint save failed") from err

    @torch.no_grad()
    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of the whole fleet's ``t`` from the ranks' blocks (this
        rank's alone on one card)."""
        t = t.detach()
        if not self._split:
            return t.clone()
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.mesh.data_size)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.data_group)
        return torch.cat(parts)

    @torch.no_grad()
    def restore(self, path: str) -> dict:
        """Load the latest checkpoint under ``path`` into this fleet (the
        same scenes' shapes; a split fleet's rank takes its block of the
        whole fleet's); returns its meta."""
        from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

        self.wait_for_save()
        barrier()  # rank 0's save is on disk
        template = self._state()
        if self._split:
            template = {"params": {k: v.new_empty((self.n_global, *v.shape[1:]))
                                   for k, v in template["params"].items()},
                        "opt_state": None, "occ_grids": None}
        state, meta = CheckpointManager(path).restore(template, map_location="cpu")
        own = lambda t: t[self._sl] if self._split else t  # noqa: E731
        for k, p in self.model.state_dict().items():
            p.copy_(own(state["params"][k]))
        self.opt_state["count"] = int(state["opt_state"]["count"])
        for moment in ("mu", "nu"):
            for k, v in self.opt_state[moment].items():
                v.copy_(own(state["opt_state"][moment][k]))
        self.occ_grids = own(state["occ_grids"]).to(self.device)
        return meta

    # -- measurement on the card -----------------------------------------------

    def benchmark(self, steps: int = 64, steps_per_call: int | None = None,
                  stage: str = "rgb") -> dict:
        """Aggregate rays/s and ms a step of ``train`` (occupancy refreshes
        included) over ``steps`` steps after one warm-up call, on the host
        clock around a synchronized run, with the peak device memory. The
        fleet trains on."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        spc = steps_per_call or self.cfg.occ_update_every
        self.train(spc, stage=stage, log_every=0, steps_per_call=spc)
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        before = scatter_cuda.scatter_add.launches
        t0 = time.perf_counter()
        self.train(steps, stage=stage, log_every=0, steps_per_call=spc)
        torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        b = self.n_global
        return {"B": b, "ranks": self.mesh.world if self._split else 1,
                "n_rays": self.cfg.n_rays, "steps": steps,
                "aggregate_rays_per_s": b * self.cfg.n_rays * steps / dt,
                "step_ms": dt / steps * 1e3,
                "peak_mem_bytes": int(torch.cuda.max_memory_allocated(self.device)),
                "scatter_add_launches_per_step": (scatter_cuda.scatter_add.launches - before)
                / steps,
                "device": torch.cuda.get_device_name(self.device)}

    def profile(self, stage: str = "rgb", reps: int = 5, warmup: int = 2, top: int = 12) -> dict:
        """Where a fleet step's time goes (``train/timing.py:profile_ms``) by
        span: rays, occupancy, compact, encode, mlp, composite_loss,
        backward, adam; the busy share and top kernels. The fleet trains
        on."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        draw = self._device_batch if self.device_data else self._batch
        out = profile_ms(lambda: self.train_step(stage, *draw()), self.device, self._stage,
                         reps=reps, warmup=warmup, top=top, watch=("scatter_add",))
        out["stage"] = stage
        return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if torch.is_tensor(tree) else tree
