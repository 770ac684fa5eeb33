"""FCOS NeRF-RPN training, proposal inference and eval (PyTorch
counterpart of ``instance_nerf_tpu.train.fcos_trainer``).

``FCOSTrainer`` runs on ``device="cuda"`` unless the caller asks for the
CPU; with no CUDA device it raises. ``train_loop`` trains on the augmented
train split, evaluating and checkpointing as the JAX trainer does:
``steps_per_call`` steps a dispatch, and with ``device_data`` from the
train split held on the card (grids in bf16), batches gathered there by
scene index and augmented there (``device_augment``). ``predict_scene``
pads a scene's grid to multiples of 32, runs the backbone and the FCOS head
and post-processes the locations of the un-padded region: in AABB mode the NMS is kernel B1,
in OBB mode the rotated IoU of the valid candidates swept by kernel B2.

Under ``torchrun`` (or given a ``mesh``) the trainer is one rank of a
data-parallel step (``parallel/mesh.py``): each rank, bound to its own
card, loads its rows of every global batch, the losses and gradients are
summed over the ranks, and evals and checkpoints run on rank 0.
"""
from __future__ import annotations

import logging
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.convert import fcos_params_from_jax, unflatten_npz
from instance_nerf_tpu_torch.data.datasets import RPNDataset
from instance_nerf_tpu_torch.models.backbones import build_backbone
from instance_nerf_tpu_torch.models.fcos import (
    FCOSOverNeRF,
    fcos_postprocess,
    init_fcos_head,
    padding_mask,
    sigmoid,
)
from instance_nerf_tpu_torch.parallel.mesh import batch_shard, launched_mesh
from instance_nerf_tpu_torch.parallel.train_step import (
    TrainState,
    make_fcos_train_step,
    make_optimizer,
)
from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager, load_params_into
from instance_nerf_tpu_torch.train.loop import (
    device_batch,
    device_indices,
    synthetic_batch,
    train_epochs,
)
from instance_nerf_tpu_torch.train.rcnn_trainer import init_rcnn_params, to_numpy
from instance_nerf_tpu_torch.train.rpn_trainer import (
    eval_proposals,
    padded_grid,
    rpn_dataset,
)
from instance_nerf_tpu_torch.train.timing import (
    Stages,
    benchmark_ms,
    benchmark_train_steps,
    profile_ms,
)

log = logging.getLogger("fcos_trainer")


@dataclass
class FCOSConfig:
    """The JAX package's ``FCOSConfig``. ``n_spatial > 1`` (a mesh's spatial
    axis, the voxel W axis split over cards) raises: it comes with slice 7b."""

    # data
    features_path: str = ""
    boxes_path: str = ""
    dataset_split: str = ""
    save_path: str = ""
    # a checkpoint directory of the port, or a flax params tree as .npz
    # ("/"-joined keys)
    checkpoint: str = ""
    resolution: int = 160
    normalize_density: bool = True
    # model; compute dtype (params stay f32), bf16 on the card by default
    backbone_type: str = "vgg_EF"
    input_dim: int = 4
    dtype: str = "bfloat16"
    rotated_bbox: bool = False
    num_convs: int = 4
    norm_reg_targets: bool = True
    centerness_on_reg: bool = True
    conv_at_start: bool = False
    # train
    batch_size: int = 4
    num_epochs: int = 160
    lr: float = 3e-4
    reg_loss_weight: float = 1.0
    weight_decay: float = 1e-3
    clip_grad_norm: float = 0.1
    log_interval: int = 20
    eval_interval: int = 4
    keep_checkpoints: int = 2
    center_sampling_radius: float = 1.5
    iou_loss_type: str = "iou"
    use_additional_l1_loss: bool = False
    proj2d_loss_weight: float = 0.0
    # augmentation (train split only)
    flip_prob: float = 0.5
    rotate_prob: float = 0.5
    rot_scale_prob: float = 0.0
    # inference
    pre_nms_top_n: int = 2500
    fpn_post_nms_top_n: int = 2500
    nms_thresh: float = 0.3
    pre_nms_thresh: float = 0.0
    min_size: float = 0.0
    ap_top_n: int | None = None
    # train loop, parallel, device store
    resume: bool = False
    n_spatial: int = 1
    max_gt: int = 64
    remat: bool = False
    steps_per_call: int = 1
    save_interval: int = 0
    stop_after_epochs: int = 0
    fpn_strides: tuple = (4, 8, 16, 32)
    seed: int = 0
    preload: bool = False
    device_data: bool = False


def device_augment(g, size, boxes, flip_p: float, rot_p: float, obb: bool, draws):
    """The JAX trainer's on-device mirror of ``augment_rpn_inputs`` (rot90,
    then flip W, then flip L) for one padded scene: each acts on the padded
    cube, then the content (extent ``size``, zero padding) is rolled back to
    the origin. ``draws`` (3,) are the uniforms of the rot90 and the two
    flips (the JAX key's ``kr, kw, kl``). g (W, L, H, C) with W == L;
    size (3,) f32; boxes (K, 6|7)."""
    def roll(x, extent, axis):
        return torch.roll(x, int(extent) - x.shape[axis], dims=axis)

    s1 = int(size[1])
    if bool(draws[0] < rot_p):  # rot90 about z: swap W / L, flip the new W
        g = roll(torch.flip(g.transpose(0, 1), dims=(0,)), s1, 0)
        b = torch.cat([boxes[:, [1, 0, 2, 4, 3, 5]], boxes[:, 6:]], dim=-1)
        if obb:
            b[:, 0] = size[1] - b[:, 0]
        else:
            b[:, 0], b[:, 3] = size[1] - b[:, 3], size[1] - b[:, 0]
        boxes, size = b, size[[1, 0, 2]]
    for axis, draw in ((0, draws[1]), (1, draws[2])):
        if bool(draw < flip_p):
            ext = size[axis].to(torch.int32).to(boxes.dtype)  # the extent, truncated
            g = roll(torch.flip(g, dims=(axis,)), int(ext), axis)
            b = boxes.clone()
            if obb:
                b[:, axis] = ext - boxes[:, axis]
                b[:, 6] = -b[:, 6]
            else:
                b[:, axis], b[:, axis + 3] = ext - boxes[:, axis + 3], ext - boxes[:, axis]
            boxes = b
    return g, size, boxes


def init_fcos_params(model: FCOSOverNeRF, seed: int) -> None:
    """Seeded random init with flax's initializers (``init_rcnn_params`` for
    the backbone, ``init_fcos_head`` for the head). The numbers differ from
    JAX's (another generator)."""
    init_rcnn_params(model.backbone, seed)
    init_fcos_head(model.head, torch.Generator().manual_seed(seed + 1))


class FCOSTrainer:
    def __init__(self, cfg: FCOSConfig | None = None, device="cuda", mesh=None):
        self.cfg = cfg = cfg or FCOSConfig()
        if cfg.n_spatial > 1:
            raise NotImplementedError("n_spatial > 1 (the voxel W axis split over cards, with "
                                      "a halo exchange in every conv) comes with slice 7b "
                                      "(ROADMAP queue A)")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else launched_mesh(cfg.batch_size, self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        if self.dtype is None and self.device.type == "cuda":
            # f32 means f32: cuDNN convs and matmuls default to TF32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # the stride-4 stem always, as the JAX trainer builds it
        backbone = build_backbone(cfg.backbone_type, input_size=max(cfg.resolution, 160),
                                  in_channels=cfg.input_dim,
                                  conv_at_start=cfg.conv_at_start, dtype=self.dtype)
        self.model = FCOSOverNeRF(backbone, out_channels=backbone.out_channels,
                                  fpn_strides=cfg.fpn_strides,
                                  num_convs=cfg.num_convs,
                                  norm_reg_targets=cfg.norm_reg_targets,
                                  centerness_on_reg=cfg.centerness_on_reg,
                                  use_obb=cfg.rotated_bbox, dtype=self.dtype)
        self.model.eval()
        self.params_loaded = False
        self.state: TrainState | None = None
        self.ckpt = (CheckpointManager(cfg.save_path, keep=cfg.keep_checkpoints,
                                       best_metric="recall_50") if cfg.save_path else None)
        # ``predict_scene``'s stages: profiler ranges ``fcos.<name>``; a train
        # step's: ``fcos_train.<name>``
        self._stage = Stages("fcos")
        self._train_stage = Stages("fcos_train")

    # -- data ----------------------------------------------------------------

    def make_dataset(self, mode: str) -> RPNDataset:
        return rpn_dataset(self.cfg, mode, preload=self.cfg.preload)

    # -- state ---------------------------------------------------------------

    def init_state(self, total_steps: int | None = None):
        """Seeded random init, or ``cfg.checkpoint`` (its params), and the
        optimizer (one-cycle over ``total_steps``, else a constant lr)."""
        cfg = self.cfg
        if cfg.checkpoint:
            load_params_into(self.model, cfg.checkpoint, fcos_params_from_jax)
        else:
            init_fcos_params(self.model, cfg.seed)
        self.model.to(self.device)
        self.params_loaded = True
        tx = make_optimizer(self.model.named_parameters(), lr=cfg.lr,
                            weight_decay=cfg.weight_decay,
                            clip_grad_norm=cfg.clip_grad_norm, total_steps=total_steps)
        self.state = TrainState(self.model, tx)

    def load_jax_params(self, npz_or_tree):
        """Load a flax ``FCOSOverNeRF`` params tree (nested dict of arrays,
        or an ``.npz`` whose keys are the tree paths joined by ``/``)."""
        tree = npz_or_tree
        if isinstance(tree, (str, os.PathLike)):
            with np.load(tree) as z:
                tree = unflatten_npz({k: z[k] for k in z.files})
        self.model.load_state_dict(fcos_params_from_jax(tree), strict=True)
        self.model.to(self.device)
        self.params_loaded = True

    # -- train ---------------------------------------------------------------

    def train_step_fn(self, stage=None):
        cfg = self.cfg
        return make_fcos_train_step(
            self.model, reg_loss_weight=cfg.reg_loss_weight,
            center_sampling_radius=cfg.center_sampling_radius,
            iou_loss_type=cfg.iou_loss_type, use_obb=cfg.rotated_bbox,
            use_additional_l1_loss=cfg.use_additional_l1_loss,
            proj2d_loss_weight=cfg.proj2d_loss_weight, remat=cfg.remat,
            stage=stage or self._train_stage)

    def device_store(self, ds: RPNDataset) -> dict:
        """The split on the card, uploaded once a scene at a time: each scene
        padded to the resolution without augmentation, grids in bf16."""
        cfg, dev = self.cfg, self.device
        pad = (cfg.resolution,) * 3
        n = len(ds)
        grids = torch.empty((n, *pad, 4), dtype=torch.bfloat16, device=dev)
        fields = {"grid_sizes": [], "gt_boxes": [], "gt_mask": []}
        for i in range(n):
            b = ds.batch([i], pad, max_gt=cfg.max_gt, box_dim=7 if cfg.rotated_bbox else 6)
            grids[i] = torch.as_tensor(b.grids[0], device=dev)
            for f, v in fields.items():
                v.append(getattr(b, f)[0])
        store = {f: torch.as_tensor(np.stack(v), device=dev) for f, v in fields.items()}
        store["grids"] = grids
        return store

    def store_batch(self, store: dict, idx, draws: torch.Tensor):
        """Scenes ``idx`` gathered from ``store`` and augmented on the card by
        ``device_augment`` (``draws`` (B, 3): each scene's rot90 and two flip
        uniforms), as the JAX trainer's index step does: (grids f32 (the bf16
        values), grid sizes, gt boxes, gt mask)."""
        cfg = self.cfg
        it = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)
        g, s, bx = (store[f][it] for f in ("grids", "grid_sizes", "gt_boxes"))
        out = [device_augment(g[i], s[i], bx[i], cfg.flip_prob, cfg.rotate_prob,
                              cfg.rotated_bbox, draws[i]) for i in range(it.shape[0])]
        g, s, bx = (torch.stack(f) for f in zip(*out))
        return g.float(), s, bx, store["gt_mask"][it]

    def train_loop(self) -> dict:
        """Train on the augmented train split (resuming from ``save_path``'s
        latest checkpoint with ``resume``); returns the loop's summary
        (``train/loop.py:train_epochs``). With ``device_data`` the split is
        held on the card and each batch's augmentation uniforms come from a
        generator on the card seeded ``seed + 17 + start_epoch`` (the JAX
        loop's key), the epochs' permutations from ``default_rng(seed +
        start_epoch)``."""
        cfg = self.cfg
        if cfg.device_data and cfg.rot_scale_prob > 0:
            raise ValueError("device_data cannot replicate the host-side rotate+scale "
                             "resample; set rot_scale_prob=0 or device_data=False")
        train_ds = self.make_dataset("train")
        val_ds = self.make_dataset("val") if cfg.dataset_split else None
        steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
        self.init_state(total_steps=steps_per_epoch * cfg.num_epochs)
        start_epoch = 0
        if cfg.resume and self.ckpt and self.ckpt.latest_step() is not None:
            state, meta = self.ckpt.restore(self.state.state_dict(), map_location=self.device)
            self.state.load_state_dict(state)
            start_epoch = min(meta["step"] // steps_per_epoch, cfg.num_epochs)
            log.info("resumed at step %s (epoch %d)", meta["step"], start_epoch)
        step_fn = self.train_step_fn()
        pad_shape = (cfg.resolution,) * 3
        box_dim = 7 if cfg.rotated_bbox else 6
        shard = batch_shard(self.mesh, cfg.batch_size)
        loop_kw = {}
        if cfg.device_data:
            store = self.device_store(train_ds)
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 17 + start_epoch)
            loop_kw = dict(rng=np.random.default_rng(cfg.seed + start_epoch),
                           epoch_indices=device_indices("tile"))

            def load(idx):
                draws = torch.rand((len(idx), 3), generator=gen, device=self.device)
                if shard is not None:
                    idx, draws = shard.take(idx), shard.take(draws)
                return self.store_batch(store, idx, draws)
        else:
            def load(idx):
                rows = None if shard is None else (shard.lo, shard.hi)
                return device_batch(train_ds.batch(idx, pad_shape, max_gt=cfg.max_gt,
                                                   box_dim=box_dim, augment=True, rows=rows),
                                    self.device)

        def step(batch):
            self.state, metrics = step_fn(self.state, *batch, shard=shard)
            return metrics

        def save(gstep, metrics):
            self.ckpt.save(gstep, self.state.state_dict(), config=asdict(cfg), metrics=metrics)

        return train_epochs(cfg, len(train_ds), start_epoch, load, step,
                            evaluate=(lambda: self.eval(val_ds)) if val_ds else None,
                            save=save if self.ckpt else None, log=log, **loop_kw)

    def _card_train_batch(self, batch, shape):
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        cfg = self.cfg
        arrays = synthetic_batch(batch, shape, cfg.max_gt, 7 if cfg.rotated_bbox else 6,
                                 cfg.input_dim)
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _card_train_step(self, batch, shape):
        """One train step on the card's synthetic batch, as a closure that
        returns the step's metrics."""
        if self.state is None:
            self.init_state()
        args = self._card_train_batch(batch, shape)
        shard = batch_shard(self.mesh, batch)
        if shard is not None:
            args = tuple(shard.take(a) for a in args)
        step_fn = self.train_step_fn()

        def run():
            self.state, metrics = step_fn(self.state, *args, shard=shard)
            return metrics

        return run

    def benchmark_train_step(self, reps=18, shape=(160, 160, 160), batch=4, warmup=3):
        """Train steps on the JAX trainer's synthetic batch
        (``train/loop.py:synthetic_batch``) timed with CUDA events
        (``train/timing.py:benchmark_train_steps``): median and mean ms over ``reps``
        warmed steps, scenes/s, peak device memory, every step's losses, and
        the JAX trainer's ``peak_hbm_gib``, ``tflops_per_step``,
        ``achieved_tflops`` and ``mfu``. Under
        a mesh ``batch`` is the global batch: each rank times its step with its
        all-reduce, and scenes/s is the global batch's."""
        return benchmark_train_steps(self._card_train_step(batch, shape), self.device, batch,
                                     reps=reps, warmup=warmup)

    def profile_train(self, reps=5, shape=(160, 160, 160), batch=4, warmup=2, top=12):
        """Where a train step's time goes (``train/timing.py:profile_ms``), by
        span: forward, loss (targets included), backward, allreduce (under a
        mesh), optimizer."""
        return profile_ms(self._card_train_step(batch, shape), self.device, self._train_stage,
                          reps=reps, warmup=warmup, top=top, watch=())

    # -- inference -----------------------------------------------------------

    @torch.inference_mode()
    def head_outputs(self, grid):
        """Backbone + FCOS head for one scene ``(W, L, H, C)``: (level info,
        logits (1, R), regression (1, R, D) in voxels, centerness (1, R),
        features, grid sizes (1, 3), padding mask (1, R))."""
        if not self.params_loaded:
            self.init_state()
        padded, sizes = padded_grid(grid, self.device)
        with self._stage("backbone"):
            feats = self.model.features(padded)
        with self._stage("head"):
            logits, reg, ctr = self.model.head_outputs(feats)
            info = self.model.level_info(feats)
            pm = padding_mask(info, sizes)
        return info, logits, reg, ctr, feats, sizes, pm

    @torch.inference_mode()
    def postprocess(self, info, logits, reg, ctr, sizes, pm, nms_sweep=None):
        """``fcos_postprocess`` with the config's settings; ``nms_sweep``
        replaces the NMS sweep (see ``ops.nms.nms_mask``)."""
        cfg = self.cfg
        return fcos_postprocess(
            info, logits, reg, ctr, sizes, num_levels=len(cfg.fpn_strides),
            pre_nms_thresh=cfg.pre_nms_thresh, pre_nms_top_n=cfg.pre_nms_top_n,
            nms_thresh=cfg.nms_thresh, fpn_post_nms_top_n=cfg.fpn_post_nms_top_n,
            min_size=cfg.min_size, pad_mask=pm, use_obb=cfg.rotated_bbox,
            nms_sweep=nms_sweep, stage=self._stage)

    @torch.inference_mode()
    def predict_scene(self, grid):
        """One scene ``(W, L, H, C)`` -> (boxes (P, 6|7), scores (P,), level
        ids (P,)), the valid proposals, best first."""
        info, logits, reg, ctr, _, sizes, pm = self.head_outputs(grid)
        props = self.postprocess(info, logits, reg, ctr, sizes, pm)
        v = props.valid[0]
        return props.boxes[0][v], props.scores[0][v], props.level_ids[0][v]

    @torch.inference_mode()
    def dump_voxel_scores(self, grid, out_path: str):
        """Per-voxel ``sqrt(clip(cls * ctr, 0, 1))`` per level (in the head's
        dtype), cropped to the grid, into a compressed ``.npz`` of f32 arrays
        ``{"0": (w0, l0, h0), ...}``."""
        cfg = self.cfg
        if not self.params_loaded:
            self.init_state()
        padded, _ = padded_grid(grid, self.device)
        _, logits, _, ctr, feats = self.model(padded)
        score = torch.sqrt(torch.clamp(sigmoid(logits) * sigmoid(ctr), 0, 1))[0]
        out, offset = {}, 0
        for lvl, (f, stride) in enumerate(zip(feats, cfg.fpn_strides)):
            wl, ll, hl = f.shape[1:4]
            n = wl * ll * hl
            s = score[offset:offset + n].reshape(wl, ll, hl)
            lim = [int(np.ceil(d / stride)) for d in np.shape(grid)[:3]]
            out[str(lvl)] = to_numpy(s[:lim[0], :lim[1], :lim[2]])
            offset += n
        np.savez_compressed(out_path, **out)

    def eval(self, dataset: RPNDataset, save_results_path: str | None = None,
             output_voxel_scores: bool = False, filter_mode: str = "none",
             filter_threshold: float = 0.7) -> dict:
        """Recall (IoU 0.25 / 0.5 at the top 300, 1000 and all), AR and AP of
        the proposals over ``dataset``; with ``save_results_path`` writes
        ``proposals/<scene>.npz`` (TP/FP-filtered with ``filter_mode``) and,
        with ``output_voxel_scores``, ``voxel_scores/<scene>.npz``."""

        def predict(grid):
            return tuple(to_numpy(x) for x in self.predict_scene(grid)), None

        def export(scene, grid, props, _):
            b, s, lvl = props
            if output_voxel_scores:
                vs_dir = os.path.join(save_results_path, "voxel_scores")
                os.makedirs(vs_dir, exist_ok=True)
                self.dump_voxel_scores(grid, os.path.join(vs_dir, scene + ".npz"))
            os.makedirs(os.path.join(save_results_path, "proposals"), exist_ok=True)
            np.savez(os.path.join(save_results_path, "proposals", scene + ".npz"),
                     proposals=b, scores=s, level_indices=lvl)

        return eval_proposals(dataset, predict, export if save_results_path else None,
                              filter_mode, filter_threshold, ap_top_n=self.cfg.ap_top_n)

    # -- misc ----------------------------------------------------------------

    def check_arch(self, grid_size=64):
        """Smoke forward on a random grid."""
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (grid_size,) * 3 + (self.cfg.input_dim,)).astype(np.float32)
        boxes, scores, lvls = self.predict_scene(grid)
        return {"device": str(self.device), "proposals": int(boxes.shape[0]),
                "box_dim": int(boxes.shape[-1]),
                "levels": torch.bincount(lvls.long(), minlength=4).tolist()}

    def benchmark(self, reps=10, shape=(160, 160, 160), warmup=2):
        """``predict_scene`` at ``shape`` timed with CUDA events: median and
        mean ms over ``reps`` warmed runs, and peak device memory."""
        grid_t = self._card_grid(shape)
        out = benchmark_ms(lambda: self.predict_scene(grid_t), self.device,
                           reps=reps, warmup=warmup)
        out["proposals"] = int(self.predict_scene(grid_t)[0].shape[0])
        return out

    def profile(self, reps=5, shape=(160, 160, 160), warmup=2, top=12):
        """Where ``predict_scene``'s time goes (``train/timing.py:profile_ms``),
        by stage: backbone, head, decode_filter, obb_iou, nms_sweep, topk."""
        grid_t = self._card_grid(shape)
        return profile_ms(lambda: self.predict_scene(grid_t), self.device,
                          self._stage, reps=reps, warmup=warmup, top=top)

    def _card_grid(self, shape):
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (*shape, self.cfg.input_dim)).astype(np.float32)
        return torch.as_tensor(grid, device=self.device)
