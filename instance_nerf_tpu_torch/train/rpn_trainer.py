"""Anchor NeRF-RPN training, proposal inference and eval (PyTorch
counterpart of ``instance_nerf_tpu.train.rpn_trainer``).

``RPNTrainer`` runs on ``device="cuda"`` unless the caller asks for the
CPU; with no CUDA device it raises instead of carrying on on the CPU.
``train_loop`` trains on the augmented train split (``train/loop.py``),
evaluating and checkpointing as the JAX trainer does; the sampler's draws
come from a ``torch.Generator`` on the device seeded with ``cfg.seed``.
``predict_scene`` pads a scene's grid to multiples of 32, runs the
backbone and the RPN head, masks the anchors of the padding and filters
the proposals: with ``rotated_bbox`` the per-level NMS computes the dense
rotated IoU and sweeps it with kernel B2, else it runs kernel B1. ``eval``
scores the proposals of a dataset and exports them with the FPN level
features: the files the RCNN's ``SegmentationDataset`` reads as ``rois/``.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.convert import rpn_params_from_jax, unflatten_npz
from instance_nerf_tpu_torch.data.datasets import RPNDataset, read_split
from instance_nerf_tpu_torch.eval.metrics import (
    box_iou_3d_np,
    evaluate_box_proposals_ap,
    evaluate_box_proposals_recall,
)
from instance_nerf_tpu_torch.models.backbones import build_backbone
from instance_nerf_tpu_torch.models.rpn import (
    NeRFRegionProposalNetwork,
    anchor_padding_mask,
    filter_proposals,
)
from instance_nerf_tpu_torch.parallel.train_step import (
    TrainState,
    make_optimizer,
    make_rpn_train_step,
)
from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager, load_params_into
from instance_nerf_tpu_torch.parallel.mesh import batch_shard, launched_mesh
from instance_nerf_tpu_torch.parallel.spatial import grid_layout
from instance_nerf_tpu_torch.train.loop import device_batch, synthetic_batch, train_epochs
from instance_nerf_tpu_torch.train.rcnn_trainer import init_rcnn_params, to_numpy
from instance_nerf_tpu_torch.train.timing import Stages, benchmark_ms, benchmark_steps, profile_ms

log = logging.getLogger("rpn_trainer")


@dataclass
class RPNConfig:
    """The JAX package's ``RPNConfig``."""

    features_path: str = ""
    boxes_path: str = ""
    dataset_split: str = ""
    save_path: str = ""
    # a checkpoint directory of the port, or a flax params tree as .npz
    # ("/"-joined keys)
    checkpoint: str = ""
    backbone_type: str = "vgg_EF"
    resolution: int = 160
    normalize_density: bool = True
    rotated_bbox: bool = False
    batch_size: int = 4
    num_epochs: int = 160
    lr: float = 3e-4
    weight_decay: float = 1e-3
    clip_grad_norm: float = 0.1
    log_interval: int = 30
    eval_interval: int = 4
    keep_checkpoints: int = 2
    # compute dtype (params stay f32); bf16 on the card by default
    dtype: str = "bfloat16"
    # the rpn's own (nerf_rpn.py:70-86 defaults)
    conv_depth: int = 4
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_mesh: int = 256
    positive_fraction: float = 0.5
    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 1000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    reg_loss_type: str = "smooth_l1"
    proj2d_loss_weight: float = 1.0
    # augmentation (train split only)
    flip_prob: float = 0.5
    rotate_prob: float = 0.5
    rot_scale_prob: float = 0.0
    max_gt: int = 64
    fpn_strides: tuple = (4, 8, 16, 32)
    resume: bool = False
    seed: int = 0


def init_rpn_params(model: NeRFRegionProposalNetwork, seed: int) -> None:
    """Seeded random init with flax's initializers: the backbone as
    ``init_rcnn_params`` does it, ``normal(0.01)`` for the head's kernels,
    zero biases. The numbers differ from JAX's (another generator)."""
    init_rcnn_params(model.backbone, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.rpn_head.children():
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * 0.01)
            mod.bias.zero_()


def pad_to_32(v: int) -> int:
    return max(32, int(math.ceil(v / 32)) * 32)


def padded_grid(grid, device):
    """One scene ``(W, L, H, C)`` zero-padded to multiples of 32 as
    ``(1, W', L', H', C)`` f32 on ``device``, and its sizes ``(1, 3)``."""
    grid = torch.as_tensor(grid, dtype=torch.float32, device=device)
    w, l, h, c = grid.shape
    padded = torch.zeros((1, pad_to_32(w), pad_to_32(l), pad_to_32(h), c),
                         dtype=torch.float32, device=device)
    padded[0, :w, :l, :h] = grid
    return padded, torch.tensor([[float(w), float(l), float(h)]], device=device)


def rpn_dataset(cfg, mode: str, preload: bool = False) -> RPNDataset:
    """The split ``mode`` of ``cfg``'s dataset (all scenes without a split
    file), as the JAX trainers build it: the train split augmented with the
    config's flip, rot90 and rotate-and-scale probabilities, drawn from the
    dataset's ``default_rng(seed)``."""
    scene_list = read_split(cfg.dataset_split, mode) if cfg.dataset_split else None
    aug = mode == "train"
    return RPNDataset(
        features_path=cfg.features_path, boxes_path=cfg.boxes_path or None,
        scene_list=scene_list, normalize_density=cfg.normalize_density,
        flip_prob=cfg.flip_prob if aug else 0.0,
        rotate_prob=cfg.rotate_prob if aug else 0.0,
        rot_scale_prob=cfg.rot_scale_prob if aug else 0.0,
        preload=preload, seed=cfg.seed)



def proposal_metrics(proposals, scores, gts, ap_top_n=None) -> dict:
    """The JAX trainers' proposal eval: recall at IoU 0.25 / 0.5 of the top
    300, 1000 and all proposals, AR over IoU 0.5:0.95, AP at 0.25 / 0.5."""
    out = {}
    for limit in (300, 1000, None):
        tag = limit if limit else "all"
        for thr in (0.25, 0.5):
            r = evaluate_box_proposals_recall(proposals, scores, gts, thresholds=[thr],
                                              limit=limit)
            out[f"recall_{int(thr * 100)}_top{tag}"] = float(r["recalls"][0])
    out["recall_25"] = out["recall_25_topall"]
    out["recall_50"] = out["recall_50_topall"]
    out["ar"] = float(evaluate_box_proposals_recall(proposals, scores, gts)["ar"])
    for thr in (0.25, 0.5):
        out[f"ap_{int(thr * 100)}"] = float(evaluate_box_proposals_ap(
            proposals, scores, gts, iou_thresh=thr, top_k=ap_top_n)["ap"])
    return out


def eval_proposals(dataset: RPNDataset, predict, export=None, filter_mode="none",
                   filter_threshold=0.7, ap_top_n=None) -> dict:
    """The JAX trainers' proposal eval loop over ``dataset``.

    ``predict(grid)`` gives a scene's ((boxes, scores, level ids) as numpy,
    extra); ``export(scene, grid, (boxes, scores, level ids), extra)``
    writes the scene's files, its proposals TP/FP-filtered against the
    ground truth with ``filter_mode`` ("tp": best IoU >= ``filter_threshold``,
    "fp": below it, "none"). Returns ``proposal_metrics`` of the unfiltered
    proposals."""
    proposals, scores, gts = [], [], []
    for i in range(len(dataset)):
        scene, grid, boxes = dataset.get(i)
        (b, s, lvl), extra = predict(grid)
        gt = boxes if boxes is not None else np.zeros((0, 6))
        proposals.append(b)
        scores.append(s)
        gts.append(gt)
        if export is None:
            continue
        if filter_mode != "none" and gt.shape[0]:
            iou = box_iou_3d_np(b[:, :6], gt).max(axis=1) if b.size else np.zeros(0)
            keep = iou >= filter_threshold if filter_mode == "tp" else iou < filter_threshold
            b, s, lvl = b[keep], s[keep], lvl[keep]
        export(scene, grid, (b, s, lvl), extra)
    return proposal_metrics(proposals, scores, gts, ap_top_n=ap_top_n)


class RPNTrainer:
    def __init__(self, cfg: RPNConfig | None = None, device="cuda", mesh=None):
        """``mesh`` (or ``torchrun``'s, built as the FCOS trainer's): one rank
        of a data-parallel step, each rank its rows of every global batch,
        the sampler's draws its rows of the global batch's. A given mesh
        with a spatial axis (``sp > 1``; ``torchrun``'s has none, as the
        JAX trainer's) splits each train grid's W over its ``sp`` ranks."""
        self.cfg = cfg = cfg or RPNConfig()
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else launched_mesh(cfg.batch_size, self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        if self.dtype is None and self.device.type == "cuda":
            # f32 means f32: cuDNN convs and matmuls default to TF32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        backbone = build_backbone(cfg.backbone_type,
                                  input_size=max(cfg.resolution, 160),
                                  dtype=self.dtype)
        self.model = NeRFRegionProposalNetwork(
            backbone, conv_depth=cfg.conv_depth, rotated=cfg.rotated_bbox,
            fpn_strides=cfg.fpn_strides, out_channels=backbone.out_channels,
            dtype=self.dtype)
        self.model.eval()
        self.params_loaded = False
        self.state: TrainState | None = None
        self.ckpt = (CheckpointManager(cfg.save_path, keep=cfg.keep_checkpoints,
                                       best_metric="recall_50") if cfg.save_path else None)
        # the sampler's draws
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # ``predict_scene``'s stages: profiler ranges ``rpn.<name>``; a train
        # step's: ``rpn_train.<name>``
        self._stage = Stages("rpn")
        self._train_stage = Stages("rpn_train")

    def make_dataset(self, mode: str) -> RPNDataset:
        return rpn_dataset(self.cfg, mode)

    # -- state ----------------------------------------------------------------

    def init_state(self, total_steps: int | None = None):
        """Seeded random init, or ``cfg.checkpoint`` (its params), and the
        optimizer (one-cycle over ``total_steps``, else a constant lr)."""
        cfg = self.cfg
        if cfg.checkpoint:
            load_params_into(self.model, cfg.checkpoint, rpn_params_from_jax)
        else:
            init_rpn_params(self.model, cfg.seed)
        self.model.to(self.device)
        self.params_loaded = True
        tx = make_optimizer(self.model.named_parameters(), lr=cfg.lr,
                            weight_decay=cfg.weight_decay,
                            clip_grad_norm=cfg.clip_grad_norm, total_steps=total_steps)
        self.state = TrainState(self.model, tx)

    def load_jax_params(self, npz_or_tree):
        """Load a flax ``NeRFRegionProposalNetwork`` params tree (nested dict
        of arrays, or an ``.npz`` whose keys are the tree paths joined by
        ``/``)."""
        tree = npz_or_tree
        if isinstance(tree, (str, os.PathLike)):
            with np.load(tree) as z:
                tree = unflatten_npz({k: z[k] for k in z.files})
        self.model.load_state_dict(rpn_params_from_jax(tree), strict=True)
        self.model.to(self.device)
        self.params_loaded = True

    # -- train ----------------------------------------------------------------

    def train_step_fn(self, stage=None):
        return make_rpn_train_step(self.model, self.cfg,
                                   stage=stage or self._train_stage)

    def grid_layout(self, size: int):
        """The W layout of a train grid of W ``size`` on the mesh's spatial
        axis (None without one); raises where ``sp`` does not divide it."""
        return grid_layout(self.mesh, size, stage=self._train_stage)

    def train_loop(self) -> dict:
        """Train ``num_epochs`` epochs on the augmented train split (resuming
        from ``save_path``'s latest checkpoint with ``resume``); returns the
        loop's summary (``train/loop.py:train_epochs``)."""
        cfg = self.cfg
        ds = self.make_dataset("train")
        val = self.make_dataset("val") if cfg.dataset_split else None
        steps_per_epoch = max(1, len(ds) // cfg.batch_size)
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
        rows = None if shard is None else (shard.lo, shard.hi)
        layout = self.grid_layout(cfg.resolution)

        def load(idx):
            b = ds.batch(idx, pad_shape, max_gt=cfg.max_gt, box_dim=box_dim, augment=True,
                         rows=rows)
            if layout is not None:
                b.grids = np.ascontiguousarray(b.grids[:, layout.lo:layout.hi])
            return b

        def step(batch):
            self.state, losses = step_fn(self.state, *device_batch(batch, self.device),
                                         generator=self.gen, shard=shard, layout=layout)
            return losses

        def save(gstep, metrics):
            self.ckpt.save(gstep, self.state.state_dict(), config=asdict(cfg), metrics=metrics)

        return train_epochs(cfg, len(ds), start_epoch, load, step,
                            evaluate=(lambda: self.eval(val)) if val else None,
                            save=save if self.ckpt else None, log=log)

    def _card_train_batch(self, batch, shape):
        """The synthetic train batch (``train/loop.py:synthetic_batch``) of
        ``batch`` scenes at ``shape``, zero-padded to multiples of 32, on the
        card."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        cfg = self.cfg
        grids, sizes, boxes, mask = synthetic_batch(batch, shape, cfg.max_gt,
                                                    7 if cfg.rotated_bbox else 6)
        padded = np.zeros((batch, *(pad_to_32(s) for s in shape), 4), np.float32)
        padded[:, :shape[0], :shape[1], :shape[2]] = grids
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (padded, sizes, boxes, mask))

    def _card_train_step(self, batch, shape):
        """One train step on the card's synthetic batch, as a closure that
        returns the step's metrics."""
        if self.state is None:
            self.init_state()
        args = self._card_train_batch(batch, shape)
        shard = batch_shard(self.mesh, batch)
        if shard is not None:
            args = tuple(shard.take(a) for a in args)
        layout = self.grid_layout(args[0].shape[1])
        if layout is not None:
            args = (layout.take(args[0]).contiguous(), *args[1:])
        step_fn = self.train_step_fn()

        def run():
            self.state, metrics = step_fn(self.state, *args, generator=self.gen, shard=shard,
                                          layout=layout)
            return metrics

        return run

    def benchmark_train_step(self, reps=18, shape=(200, 200, 130), batch=4, warmup=3):
        """Train steps on the synthetic batch at ``shape`` (padded to 224 x
        224 x 160 by default) timed with CUDA events
        (``train/timing.py:benchmark_steps``): median and mean ms over ``reps``
        warmed steps, scenes/s, peak device memory, every step's losses. Under
        a mesh ``batch`` is the global batch, and with a spatial axis each
        rank steps on its rows of the padded grid's W."""
        return benchmark_steps(self._card_train_step(batch, shape), self.device, batch,
                               reps=reps, warmup=warmup)

    def profile_train(self, reps=5, shape=(200, 200, 130), batch=4, warmup=2, top=12):
        """Where a train step's time goes (``train/timing.py:profile_ms``), by
        span: forward, loss (targets and sampling included), backward,
        allreduce (under a mesh), halo (on a spatial axis: the exchanges,
        forward and backward), optimizer."""
        return profile_ms(self._card_train_step(batch, shape), self.device, self._train_stage,
                          reps=reps, warmup=warmup, top=top, watch=())

    # -- inference ------------------------------------------------------------

    @torch.inference_mode()
    def head_outputs(self, grid):
        """Backbone + RPN head for one scene ``(W, L, H, C)``, zero-padded to
        multiples of 32: (objectness (1, R), deltas (1, R, D), anchors per
        level, features, grid sizes (1, 3), padding mask (1, R))."""
        if not self.params_loaded:
            self.init_state()
        padded, sizes = padded_grid(grid, self.device)
        with self._stage("backbone"):
            feats = self.model.features(padded)
        with self._stage("head"):
            obj, reg = self.model.head(feats)
            anchors = self.model.anchors(feats)
            pm = anchor_padding_mask(anchors, sizes, self.cfg.fpn_strides)
        return obj, reg, anchors, feats, sizes, pm

    @torch.inference_mode()
    def filter(self, obj, reg, anchors, sizes, pm, nms_sweep=None):
        """``filter_proposals`` with the config's settings; ``nms_sweep``
        replaces the NMS sweep (see ``ops.nms.nms_mask``)."""
        cfg = self.cfg
        return filter_proposals(
            obj, reg, anchors, sizes, pre_nms_top_n=cfg.pre_nms_top_n,
            post_nms_top_n=cfg.post_nms_top_n, nms_thresh=cfg.nms_thresh,
            score_thresh=cfg.score_thresh, pad_mask=pm, rotated=cfg.rotated_bbox,
            nms_sweep=nms_sweep, stage=self._stage)

    @torch.inference_mode()
    def predict_scene(self, grid):
        """One scene ``(W, L, H, C)`` -> (boxes (P, 7|6), scores (P,), level
        ids (P,), features per level ``(w, l, h, 256)``, objectness (1, R)),
        the proposals being the valid ones, best first."""
        obj, reg, anchors, feats, sizes, pm = self.head_outputs(grid)
        props = self.filter(obj, reg, anchors, sizes, pm)
        v = props.valid[0]
        return (props.boxes[0][v], props.scores[0][v], props.level_ids[0][v],
                [f[0] for f in feats], obj)

    # -- eval and export ------------------------------------------------------

    def eval(self, dataset: RPNDataset, save_results_path=None, output_proposals=False,
             filter_mode="none", filter_threshold=0.7, output_voxel_scores=False) -> dict:
        """Proposal recall, AR and AP over ``dataset``. With
        ``save_results_path`` writes per scene ``rois/<scene>.npz``
        (proposals, level indices, scores; TP/FP-filtered with
        ``output_proposals`` and ``filter_mode``) and
        ``level_features/<scene>.npz`` (``level_k`` f32 arrays and the grid
        resolution), and with ``output_voxel_scores``
        ``voxel_scores/<scene>.npz``."""

        def predict(grid):
            b, s, lvl, feats, obj = self.predict_scene(grid)
            return (to_numpy(b), to_numpy(s), to_numpy(lvl)), (feats, obj)

        def export(scene, grid, props, extra):
            (b, s, lvl), (feats, obj) = props, extra
            for sub in ("rois", "level_features") + (
                    ("voxel_scores",) if output_voxel_scores else ()):
                os.makedirs(os.path.join(save_results_path, sub), exist_ok=True)
            np.savez(os.path.join(save_results_path, "rois", scene + ".npz"),
                     proposals=b, level_indices=lvl, scores=s)
            np.savez_compressed(
                os.path.join(save_results_path, "level_features", scene + ".npz"),
                **{f"level_{k}": to_numpy(f) for k, f in enumerate(feats)},
                resolution=np.asarray(grid.shape[:3]))
            if output_voxel_scores:
                self._dump_voxel_scores(
                    os.path.join(save_results_path, "voxel_scores", scene + ".npz"),
                    obj, grid.shape[:3], feats)

        return eval_proposals(dataset, predict, export if save_results_path else None,
                              filter_mode if output_proposals else "none", filter_threshold)

    def _dump_voxel_scores(self, path, obj, grid_shape, feats):
        """Per-voxel sigmoid objectness, max over anchors, per level, cropped
        to the grid."""
        a = self.model.gen.num_anchors_per_location()[0]
        out, offset = {}, 0
        for lvl, f in enumerate(feats):
            wl, ll, hl = f.shape[:3]
            n = wl * ll * hl * a
            sig = torch.sigmoid(obj[0, offset:offset + n]).reshape(wl, ll, hl, a).amax(-1)
            stride = self.cfg.fpn_strides[lvl]
            lim = [int(np.ceil(d / stride)) for d in grid_shape]
            out[str(lvl)] = to_numpy(sig[:lim[0], :lim[1], :lim[2]])
            offset += n
        np.savez_compressed(path, **out)

    # -- misc -----------------------------------------------------------------

    def check_arch(self, grid_size=64):
        """Smoke forward on a random grid."""
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (grid_size,) * 3 + (4,)).astype(np.float32)
        boxes, scores, lvls, feats, obj = self.predict_scene(grid)
        return {
            "device": str(self.device),
            "proposals": int(boxes.shape[0]),
            "box_dim": int(boxes.shape[-1]),
            "objectness_shape": list(obj.shape),
            "feature_shapes": [list(f.shape) for f in feats],
        }

    def benchmark(self, reps=10, shape=(200, 200, 130), warmup=2):
        """``predict_scene`` at ``shape`` timed with CUDA events: median and
        mean ms over ``reps`` warmed runs, and peak device memory."""
        grid_t = self._card_grid(shape)
        out = benchmark_ms(lambda: self.predict_scene(grid_t), self.device,
                           reps=reps, warmup=warmup)
        out["proposals"] = int(self.predict_scene(grid_t)[0].shape[0])
        return out

    def profile(self, reps=5, shape=(200, 200, 130), warmup=2, top=12):
        """Where ``predict_scene``'s time goes (``train/timing.py:profile_ms``),
        by stage: backbone, head, decode_filter, obb_iou, nms_sweep, topk."""
        grid_t = self._card_grid(shape)
        return profile_ms(lambda: self.predict_scene(grid_t), self.device,
                          self._stage, reps=reps, warmup=warmup, top=top)

    def _card_grid(self, shape):
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (*shape, 4)).astype(np.float32)
        return torch.as_tensor(grid, device=self.device)
