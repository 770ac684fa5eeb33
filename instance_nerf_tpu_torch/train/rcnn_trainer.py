"""NeRF-RCNN training, inference and eval (PyTorch counterpart of
``instance_nerf_tpu.train.rcnn_trainer``).

``RCNNTrainer`` runs on ``device="cuda"`` unless the caller asks for the
CPU; with no CUDA device it raises instead of carrying on on the CPU.
``train_loop`` trains the backbone (grafted from an FCOS or RPN checkpoint
with ``rpn_ckpt``) and the RoI heads on a ``SegmentationDataset``'s
precomputed rois, ``steps_per_call`` steps a dispatch; ``freeze_backbone``
computes the features outside autograd and leaves the backbone out of the
optimizer. ``device_data`` holds the train split on the card (grids in
bf16, or with ``freeze_backbone`` their FPN features, and the voxel masks
bit-packed) and gathers each batch there by scene index. ``eval`` scores
the detections and masks (box and mask mAP / AR at IoU 0.25 and 0.5).

``bbox_type="obb"`` builds the 8-delta box head and decodes as the JAX
trainer does: its ``predict_scene`` and its train step pass no ``box_dim``,
so the detections are the AABB decode of the first six deltas, and a train
step raises ``ValueError`` in ``fastrcnn_loss`` (8 deltas against 6-wide
targets), where the JAX step fails (ROADMAP, known gaps of the reference).
The OBB functions themselves (``models/rcnn.py`` with ``box_dim = 8``) are
complete.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax, unflatten_npz
from instance_nerf_tpu_torch.data.datasets import SegmentationDataset
from instance_nerf_tpu_torch.eval.metrics import evaluate_map_recall
from instance_nerf_tpu_torch.models.backbones import build_backbone
from instance_nerf_tpu_torch.models.rcnn import (
    ConvTranspose3d,
    Detections,
    NeRF_RCNN,
    _pack,
    fastrcnn_loss,
    maskrcnn_inference,
    maskrcnn_loss,
    paste_detections,
    postprocess_detections,
    select_training_samples,
)
from instance_nerf_tpu_torch.models.layers import Conv3d, GroupNorm, LayerNorm, Linear
from instance_nerf_tpu_torch.models.swin import ShiftedWindowAttention3D
from instance_nerf_tpu_torch.ops.nms import no_stage
from instance_nerf_tpu_torch.parallel.train_step import TrainState, apply_step, make_optimizer
from instance_nerf_tpu_torch.train.checkpoints import (
    CheckpointManager,
    load_params,
    load_params_into,
)
from instance_nerf_tpu_torch.parallel.mesh import batch_shard, launched_mesh
from instance_nerf_tpu_torch.train.loop import device_batch, device_indices, train_epochs
from instance_nerf_tpu_torch.train.timing import (
    Stages,
    benchmark_ms,
    benchmark_train_steps,
    profile_ms,
)
from instance_nerf_tpu_torch.train.train_utils import partition_optimizer

log = logging.getLogger("rcnn_trainer")

# the fields of an ``RCNNBatch`` a train step takes, in its argument order
BATCH_FIELDS = ("grids", "grid_sizes", "rois", "roi_mask", "gt_boxes", "gt_labels",
                "gt_mask", "gt_voxel_masks")


@dataclass
class RCNNConfig:
    """The JAX package's ``RCNNConfig``."""

    dataset_root: str = ""
    dataset_split: str = ""
    save_path: str = ""
    # an FCOS or RPN checkpoint (directory of the port, or a flax params
    # .npz) whose backbone is grafted in
    rpn_ckpt: str = ""
    # a checkpoint directory of the port, or a flax params tree as .npz
    # ("/"-joined keys)
    rcnn_ckpt: str = ""
    backbone_type: str = "vgg_EF"
    resolution: int = 160
    num_classes: int = 11  # 10 fg + background
    # compute dtype (params stay f32); bf16 on the card by default
    dtype: str = "bfloat16"
    bbox_type: str = "aabb"
    batch_size: int = 4
    num_epochs: int = 200
    lr: float = 1e-3
    weight_decay: float = 1e-2
    clip_grad_norm: float = 0.1
    log_interval: int = 20
    eval_interval: int = 5
    keep_checkpoints: int = 2
    # the reference's recipe trains the backbone; True computes the features
    # outside autograd and freezes the backbone's parameters
    freeze_backbone: bool = False
    # RoI heads
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    fg_iou_thresh: float = 0.25
    bg_iou_thresh: float = 0.25
    box_score_thresh: float = 0.0
    box_nms_thresh: float = 0.15
    detections_per_img: int = 25
    max_rois: int = 256
    eval_rois: int = 20  # inference.sh: rois[:20]
    max_gt: int = 32
    mask_paste_threshold: float = 0.5
    seed: int = 0
    # hold decoded scenes (grid + per-instance voxel masks) in host RAM
    cache_scenes: bool = False
    steps_per_call: int = 1
    device_data: bool = False
    # checkpoint cadence in epochs between evals (0: at evals and the end)
    save_interval: int = 0
    # recompute the backbone's forward in the backward
    remat: bool = False


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal(shape, std, gen):
    """Normal truncated to +-2 std by inverse CDF (flax's variance-scaling
    ``truncated_normal``)."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return torch.erfinv(2 * u - 1) * (math.sqrt(2) * std / _TRUNC_STD)


def _plain_conv(name: str) -> bool:
    """A flax ``nn.Conv`` outside a ``ConvBlock`` (lecun-normal init): the
    Swin patch embed and the ResNet pyramids' ``lat_*``, ``smooth_*``, ``top``."""
    last = name.rsplit(".", 1)[-1]
    return last in ("patch_embed", "top") or last.startswith(("lat_", "smooth_"))


def init_rcnn_params(model: NeRF_RCNN, seed: int) -> None:
    """Seeded random init with flax's initializers: he-normal for the
    backbone's conv blocks and the mask convs, xavier-uniform for the FPN
    convs, lecun-normal for the dense layers, the mask logits and the
    other plain convs, truncated normal(0.02) for the Swin bias tables; zero
    biases, unit norm scales. The numbers differ from JAX's (another
    generator)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (GroupNorm, LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            if isinstance(mod, ShiftedWindowAttention3D):
                t = mod.rel_pos_bias_table
                t.copy_(_trunc_normal(t.shape, 0.02 * _TRUNC_STD, gen))
            if not isinstance(mod, (Conv3d, Linear, ConvTranspose3d)):
                continue
            w = mod.weight
            rf = w[0, 0].numel()  # receptive field
            in_dim = 0 if isinstance(mod, ConvTranspose3d) else 1
            fan_in = w.shape[in_dim] * rf
            fan_out = w.shape[1 - in_dim] * rf
            if ".fpn." in f".{name}.":
                a = math.sqrt(6.0 / (fan_in + fan_out))
                val = (torch.rand(w.shape, generator=gen) * 2 - 1) * a
            elif (isinstance(mod, Linear) or name.endswith("mask_fcn_logits")
                  or _plain_conv(name)):
                val = _trunc_normal(w.shape, math.sqrt(1.0 / fan_in), gen)
            else:
                val = _trunc_normal(w.shape, math.sqrt(2.0 / fan_in), gen)
            w.copy_(val)
            if mod.bias is not None:
                mod.bias.zero_()


def rcnn_losses(model, cfg, mask_slots: int, grids, grid_sizes, rois, roi_valid, gt_boxes,
                gt_labels, gt_mask, gt_vmasks, uniforms=None, generator=None, stage=no_stage,
                precomputed_feats: bool = False, shard=None):
    """One RoI-head forward and loss (the JAX package's ``make_rcnn_step_fn``
    body): sample the rois (``uniforms`` (N, 2, P + K) per scene, else drawn
    from ``generator``), pack the positives first (stably) into
    ``mask_slots`` mask slots, classification + box + mask losses (the mask
    loss a mean over scenes). Returns (total, metrics with the train-time
    classification accuracy over the sampled rois and the positives). With
    ``precomputed_feats`` ``grids`` is the FPN pyramid, a list of levels,
    and the backbone does not run.

    ``shard`` (``parallel/mesh.py:Shard``): the batch is a data-parallel
    step's rows; the draws are its rows of the global batch's, the sampled
    and positive counts are summed over the ranks and the mask loss is over
    the global batch's scenes, so that every loss and metric sums over the
    ranks to the global batch's (``num_pos`` is this rank's count)."""
    del grid_sizes  # the rois are in grid coordinates already
    with stage("loss"):
        s = select_training_samples(
            rois, roi_valid, gt_boxes, gt_labels, gt_mask,
            batch_size_per_image=cfg.batch_size_per_image,
            positive_fraction=cfg.positive_fraction, fg_iou_thresh=cfg.fg_iou_thresh,
            bg_iou_thresh=cfg.bg_iou_thresh, uniforms=uniforms, generator=generator,
            shard=shard)
        n_valid, n_pos = s.valid.sum(), s.pos.sum()
        if shard is not None:
            n_valid, n_pos = shard.sum(torch.stack([n_valid, n_pos]))
        order, mpos = _pack(s.pos, mask_slots)
        mrois = torch.gather(s.rois, 1, order[..., None].expand(*order.shape, 6))
        mlab, mmidx = (torch.gather(t, 1, order) for t in (s.labels, s.matched_gt_idx))
    with stage("forward"):
        if precomputed_feats:
            feats = list(grids)
        elif cfg.freeze_backbone:
            with torch.no_grad():
                feats = model.features(grids)
        elif cfg.remat:
            feats = checkpoint(model.features, grids, use_reentrant=False)
        else:
            feats = model.features(grids)
        logits, deltas = model.box_forward(feats, s.rois)
        mlogits = model.mask_forward(feats, mrois)
    with stage("loss"):
        cls_loss, box_loss = fastrcnn_loss(logits, deltas, s.labels, s.reg_targets, s.valid,
                                           n_valid)
        n = gt_vmasks.shape[0]
        mloss = torch.stack([
            maskrcnn_loss(mlogits[i], mrois[i], gt_vmasks[i], mlab[i], mmidx[i], mpos[i])
            for i in range(n)]).mean()
        if shard is not None and n != shard.n:
            mloss = mloss * (n / shard.n)
        total = cls_loss + box_loss + mloss
        correct = logits.argmax(dim=-1) == s.labels
        acc = (correct & s.valid).sum() / n_valid.clamp_min(1)
        fg_acc = (correct & s.pos).sum() / n_pos.clamp_min(1)
    return total, {"loss_classifier": cls_loss, "loss_box_reg": box_loss, "loss_mask": mloss,
                   "num_pos": s.pos.sum(), "cls_acc": acc, "fg_cls_acc": fg_acc}


def make_rcnn_step_fn(model, cfg, mask_slots: int, stage=no_stage,
                      precomputed_feats: bool = False):
    """``step(state, grids, grid_sizes, rois, roi_valid, gt_boxes, gt_labels,
    gt_mask, gt_vmasks, uniforms=None, generator=None, shard=None) ->
    (state, metrics)``: ``rcnn_losses``, backward, the clipped AdamW."""

    def step(state: TrainState, *batch, uniforms=None, generator=None, shard=None):
        model.zero_grad(set_to_none=True)
        total, metrics = rcnn_losses(model, cfg, mask_slots, *batch, uniforms=uniforms,
                                     generator=generator, stage=stage,
                                     precomputed_feats=precomputed_feats, shard=shard)
        return apply_step(state, total, metrics, stage, shard)

    return step


def graft_backbone(model: NeRF_RCNN, src: str) -> None:
    """Copy the backbone of an FCOS or RPN checkpoint (a directory of the
    port, or a flax params ``.npz``) into ``model``."""
    if os.path.isdir(src):
        params = load_params(src, map_location="cpu")
    else:
        with np.load(src) as z:
            tree = unflatten_npz({k: z[k] for k in z.files})
        tree = tree.get("params", tree)
        params = rcnn_params_from_jax({"backbone": tree["backbone"]})
    bb = {k[len("backbone."):]: v for k, v in params.items() if k.startswith("backbone.")}
    model.backbone.load_state_dict(bb, strict=True)


class RCNNTrainer:
    def __init__(self, cfg: RCNNConfig | None = None, device="cuda", mesh=None):
        """``mesh`` (or ``torchrun``'s, built as the FCOS trainer's): one rank
        of a data-parallel step, each rank its rows of every global batch
        (with ``device_data`` gathered from the whole split held on each
        card), the sampler's draws its rows of the global batch's."""
        self.cfg = cfg = cfg or RCNNConfig()
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
        self.model = NeRF_RCNN(backbone, num_classes=cfg.num_classes,
                               box_dim=8 if cfg.bbox_type == "obb" else 6,
                               input_shape=(cfg.resolution,) * 3,
                               out_channels=backbone.out_channels, dtype=self.dtype)
        self.model.eval()
        self.params_loaded = False
        self.state: TrainState | None = None
        self.ckpt = (CheckpointManager(cfg.save_path, keep=cfg.keep_checkpoints,
                                       best_metric="mask_mAP_25") if cfg.save_path else None)
        self.mask_slots = int(cfg.batch_size_per_image * cfg.positive_fraction)
        # the sampler's draws
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # ``predict_scene``'s stages: profiler ranges ``rcnn.<name>``; a train
        # step's: ``rcnn_train.<name>``
        self._stage = Stages("rcnn")
        self._train_stage = Stages("rcnn_train")

    # -- state ----------------------------------------------------------------

    def init_state(self, total_steps: int | None = None):
        """Seeded random init, the backbone grafted from ``cfg.rpn_ckpt``,
        then ``cfg.rcnn_ckpt``'s params over it where given, and the optimizer
        (one-cycle over ``total_steps``, else a constant lr; without the
        backbone when ``freeze_backbone``)."""
        cfg = self.cfg
        init_rcnn_params(self.model, cfg.seed)
        if cfg.rpn_ckpt:
            graft_backbone(self.model, cfg.rpn_ckpt)
            log.info("grafted the backbone of %s", cfg.rpn_ckpt)
        if cfg.rcnn_ckpt:
            load_params_into(self.model, cfg.rcnn_ckpt, rcnn_params_from_jax)
        self.model.to(self.device)
        self.params_loaded = True
        trained, _ = partition_optimizer(
            self.model, ("backbone",) if cfg.freeze_backbone else ())
        tx = make_optimizer(trained, lr=cfg.lr, weight_decay=cfg.weight_decay,
                            clip_grad_norm=cfg.clip_grad_norm, total_steps=total_steps)
        self.state = TrainState(self.model, tx)

    def load_jax_params(self, npz_or_tree):
        """Load a flax ``NeRF_RCNN`` params tree (nested dict of arrays, or
        an ``.npz`` whose keys are the tree paths joined by ``/``)."""
        tree = npz_or_tree
        if isinstance(tree, (str, os.PathLike)):
            with np.load(tree) as z:
                tree = unflatten_npz({k: z[k] for k in z.files})
        self.model.load_state_dict(rcnn_params_from_jax(tree), strict=True)
        self.model.to(self.device)
        self.params_loaded = True

    # -- train ----------------------------------------------------------------

    def train_step_fn(self, stage=None, precomputed_feats: bool = False):
        return make_rcnn_step_fn(self.model, self.cfg, self.mask_slots,
                                 stage=stage or self._train_stage,
                                 precomputed_feats=precomputed_feats)

    def device_store(self, ds: SegmentationDataset) -> dict:
        """The split on the card, uploaded once a scene at a time: grids in
        bf16 (with ``freeze_backbone`` their FPN levels instead, computed
        once with the current backbone), the voxel masks bit-packed
        (``np.packbits`` of each instance's flattened mask), the rest as
        the host batch has it."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.resolution,) * 3
        grids, feats = [], []
        fields = {f: [] for f in ("grid_sizes", "rois", "roi_mask", "gt_boxes", "gt_labels",
                                  "gt_mask")}
        packed = []
        for i in range(len(ds)):
            b = ds.batch([i], shape, max_gt=cfg.max_gt, max_rois=cfg.max_rois)
            g = torch.as_tensor(b.grids[0], device=dev).to(torch.bfloat16)
            if cfg.freeze_backbone:
                with torch.no_grad():
                    feats.append(self.model.features(g[None].float()))
            else:
                grids.append(g)
            for f, v in fields.items():
                v.append(getattr(b, f)[0])
            packed.append(torch.as_tensor(
                np.packbits(b.gt_voxel_masks[0].reshape(cfg.max_gt, -1), axis=-1), device=dev))
        store = {f: torch.as_tensor(np.stack(v), device=dev) for f, v in fields.items()}
        store["vmasks_packed"] = torch.stack(packed)
        if feats:
            store["feats"] = [torch.cat(lv) for lv in zip(*feats)]
        else:
            store["grids"] = torch.stack(grids)
        return store

    def store_batch(self, store: dict, idx):
        """Scenes ``idx`` gathered from ``store`` on the card, the voxel masks
        unpacked: the train step's arguments (``BATCH_FIELDS``; the FPN
        levels in place of the grids in a store of features)."""
        r = self.cfg.resolution
        it = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)
        g = ([lv[it] for lv in store["feats"]] if "feats" in store
             else store["grids"][it].float())
        pk = store["vmasks_packed"][it]
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=self.device)
        vm = ((pk[..., None] >> shifts) & 1).reshape(*pk.shape[:2], r, r, r)
        return (g, *(store[f][it] for f in BATCH_FIELDS[1:-1]), vm)

    def train_loop(self) -> dict:
        """Train on the train split's precomputed rois, evaluating on the val
        split every ``eval_interval`` epochs; returns the loop's summary
        (``train/loop.py:train_epochs``). ``device_data`` holds the split on
        the card (``device_store``); a split smaller than a batch then draws
        its batch with repeats, as the JAX loop does."""
        cfg = self.cfg
        split = cfg.dataset_split or None
        ds = SegmentationDataset("train", cfg.dataset_root, split, cache=cfg.cache_scenes)
        val = SegmentationDataset("val", cfg.dataset_root, split, cache=cfg.cache_scenes)
        self.init_state(total_steps=cfg.num_epochs * max(1, len(ds) // cfg.batch_size))
        shard = batch_shard(self.mesh, cfg.batch_size)
        own = (lambda idx: idx) if shard is None else shard.take
        loop_kw = {}
        if cfg.device_data:
            store = self.device_store(ds)
            step_fn = self.train_step_fn(precomputed_feats="feats" in store)
            loop_kw = dict(epoch_indices=device_indices("draw"))

            def load(idx):
                return self.store_batch(store, own(idx))
        else:
            step_fn = self.train_step_fn()

            def load(idx):
                return device_batch(ds.batch(own(idx), (cfg.resolution,) * 3,
                                             max_gt=cfg.max_gt, max_rois=cfg.max_rois),
                                    self.device, BATCH_FIELDS)

        def step(batch):
            self.state, metrics = step_fn(self.state, *batch, generator=self.gen, shard=shard)
            return metrics

        def save(gstep, metrics):
            self.ckpt.save(gstep, self.state.state_dict(), config=asdict(cfg), metrics=metrics)

        return train_epochs(cfg, len(ds), 0, load, step, evaluate=lambda: self.eval(val),
                            save=save if self.ckpt else None, log=log, **loop_kw)

    def _card_train_batch(self, batch, shape):
        """The JAX trainer's synthetic batch for ``benchmark_train_step``:
        uniform grids, ``max_rois`` random rois and ``max_gt`` random gt boxes
        a scene from ``default_rng(0)``, random labels, and voxel masks drawn
        on the card (10% set)."""
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        cfg, dev = self.cfg, self.device
        rng = np.random.default_rng(0)
        m = min(shape)
        grids = rng.uniform(0, 1, (batch, *shape, 4)).astype(np.float32)
        rois = np.stack([_random_rois(rng, m, cfg.max_rois) for _ in range(batch)])
        gt = np.stack([_random_rois(rng, m, cfg.max_gt) for _ in range(batch)])
        labels = rng.integers(1, cfg.num_classes, (batch, cfg.max_gt))
        gen = torch.Generator(device=dev).manual_seed(0)
        vmasks = (torch.rand((batch, cfg.max_gt, *shape), generator=gen, device=dev)
                  < 0.1).to(torch.uint8)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        sizes = np.tile(np.asarray([[float(x) for x in shape]], np.float32), (batch, 1))
        return (t(grids), t(sizes), t(rois), torch.ones((batch, cfg.max_rois), dtype=torch.bool,
                                                        device=dev),
                t(gt), t(labels), torch.ones((batch, cfg.max_gt), dtype=torch.bool, device=dev),
                vmasks)

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
            self.state, metrics = step_fn(self.state, *args, generator=self.gen, shard=shard)
            return metrics

        return run

    def benchmark_train_step(self, reps=18, shape=(160, 160, 160), batch=4, warmup=3):
        """Train steps on the synthetic batch timed with CUDA events
        (``train/timing.py:benchmark_train_steps``): median and mean ms over ``reps``
        warmed steps, scenes/s, peak device memory, every step's losses, and
        the JAX trainer's ``peak_hbm_gib``, ``tflops_per_step``,
        ``achieved_tflops`` and ``mfu``."""
        return benchmark_train_steps(self._card_train_step(batch, shape), self.device, batch,
                                     reps=reps, warmup=warmup)

    def profile_train(self, reps=5, shape=(160, 160, 160), batch=4, warmup=2, top=12):
        """Where a train step's time goes (``train/timing.py:profile_ms``), by
        span: loss (sampling, packing and the losses), forward (backbone and
        heads), backward, optimizer."""
        return profile_ms(self._card_train_step(batch, shape), self.device, self._train_stage,
                          reps=reps, warmup=warmup, top=top, watch=())

    # -- inference ------------------------------------------------------------

    def _inputs(self, grid, rois):
        dev = self.device
        grid = torch.as_tensor(grid, dtype=torch.float32, device=dev)
        rois_t = torch.as_tensor(rois[:self.cfg.eval_rois], dtype=torch.float32, device=dev)
        sizes = torch.tensor([[float(s) for s in grid.shape[:3]]], device=dev)
        return grid[None], rois_t[None], sizes

    @torch.inference_mode()
    def box_outputs(self, grid, rois):
        """Backbone + box head for one scene: (features, class logits,
        box deltas, rois (1, P, 6), grid sizes (1, 3))."""
        if not self.params_loaded:
            self.init_state()
        grids, rois_t, sizes = self._inputs(grid, rois)
        with self._stage("backbone"):
            feats = self.model.features(grids)
        with self._stage("box_head"):
            logits, deltas = self.model.box_forward(feats, rois_t)
        return feats, logits, deltas, rois_t, sizes

    @torch.inference_mode()
    def predict_scene(self, grid, rois, with_masks=True):
        """One scene: grid (W, L, H, 4), rois (P, 6) -> Detections (indexed
        for the scene) + full-grid bool masks (D, W, L, H)."""
        cfg = self.cfg
        feats, logits, deltas, rois_t, sizes = self.box_outputs(grid, rois)
        p = rois_t.shape[1]
        with self._stage("postprocess"):
            det = postprocess_detections(
                logits, deltas, rois_t,
                torch.ones((1, p), dtype=torch.bool, device=self.device), sizes,
                score_thresh=cfg.box_score_thresh, nms_thresh=cfg.box_nms_thresh,
                detections_per_img=cfg.detections_per_img)
        det0 = Detections(*[x[0] for x in det])
        masks = None
        if with_masks:
            with self._stage("mask_head"):
                mlogits = self.model.mask_forward(feats, det.boxes)
                probs = maskrcnn_inference(mlogits[0], det0.labels)
            grid_shape = tuple(int(s) for s in np.shape(grid)[:3])
            with self._stage("paste"):
                masks = paste_detections(det0, probs, grid_shape,
                                         cfg.mask_paste_threshold)
        return det0, masks

    # -- eval -----------------------------------------------------------------

    def eval(self, dataset: SegmentationDataset, save_masks_path=None) -> dict:
        """Box and mask mAP / AR (IoU 0.25 and 0.5, mean over the classes
        with ground truth) and the per-class box AP at 0.25 over
        ``dataset``; with ``save_masks_path`` writes ``<scene>.npz`` (masks,
        scores, labels, boxes of the valid detections)."""
        pb, ps, pl, gb, gl = [], [], [], [], []
        pm, gm = [], []
        for i in range(len(dataset)):
            d = dataset.load_scene(i)
            det, masks = self.predict_scene(d["grid"], d["rois"])
            v = det.valid
            boxes, scores = to_numpy(det.boxes[v]), to_numpy(det.scores[v])
            labels, vmasks = to_numpy(det.labels[v]), to_numpy(masks[v])
            pb.append(boxes)
            ps.append(scores)
            pl.append(labels)
            pm.append(vmasks)
            gb.append(d["boxes"] if d["boxes"] is not None else np.zeros((0, 6)))
            gl.append(d["class_ids"] if d["class_ids"] is not None else np.zeros(0))
            gm.append(d["masks"] if d["masks"] is not None else
                      np.zeros((0, *d["grid"].shape[:3])))
            if save_masks_path:
                os.makedirs(save_masks_path, exist_ok=True)
                np.savez_compressed(os.path.join(save_masks_path, d["scene"] + ".npz"),
                                    masks=vmasks, scores=scores, labels=labels, boxes=boxes)

        def nmean(x):
            x = np.asarray(x[1:], np.float64)
            return float(np.nanmean(x)) if x.size and not np.isnan(x).all() else 0.0

        out = {}
        for thr in (0.25, 0.5):
            ap, rec = evaluate_map_recall(pb, ps, pl, gb, gl, iou_thresh=thr)
            out[f"box_mAP_{int(thr * 100)}"] = nmean(ap)
            out[f"box_AR_{int(thr * 100)}"] = nmean(rec)
            ap_m, rec_m = evaluate_map_recall(pm, ps, pl, gm, gl, iou_thresh=thr,
                                              iou_type="mask")
            out[f"mask_mAP_{int(thr * 100)}"] = nmean(ap_m)
            out[f"mask_AR_{int(thr * 100)}"] = nmean(rec_m)
            if thr == 0.25:  # per class: which classes drag the mAP
                out["box_AP_25_per_class"] = [
                    None if np.isnan(x) else round(float(x), 4)
                    for x in np.asarray(ap[1:], np.float64)]
        return out

    # -- misc -----------------------------------------------------------------

    def check_arch(self, grid_size=64):
        """Smoke forward on a random grid and rois."""
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (grid_size,) * 3 + (4,)).astype(np.float32)
        rois = _random_rois(rng, grid_size, 8)
        det, masks = self.predict_scene(grid, rois)
        return {
            "device": str(self.device),
            "detections": int(det.valid.sum()),
            "mask_shape": list(masks.shape),
        }

    def benchmark(self, reps=10, shape=(200, 200, 132), warmup=2):
        """``predict_scene`` at ``shape`` timed with CUDA events: median and
        mean ms over ``reps`` warmed runs, and peak device memory."""
        grid_t, rois = self._card_inputs(shape)
        out = benchmark_ms(lambda: self.predict_scene(grid_t, rois), self.device,
                           reps=reps, warmup=warmup)
        det, masks = self.predict_scene(grid_t, rois)
        out.update(detections=int(det.valid.sum()), mask_shape=list(masks.shape))
        return out

    def profile(self, reps=5, shape=(200, 200, 132), warmup=2, top=12):
        """Where ``predict_scene``'s time goes (``train/timing.py:profile_ms``)."""
        grid_t, rois = self._card_inputs(shape)
        return profile_ms(lambda: self.predict_scene(grid_t, rois), self.device,
                          self._stage, reps=reps, warmup=warmup, top=top)

    def _card_inputs(self, shape):
        if self.device.type != "cuda":
            raise RuntimeError("timing the card needs device='cuda'")
        rng = np.random.default_rng(0)
        grid = rng.uniform(0, 1, (*shape, 4)).astype(np.float32)
        rois = _random_rois(rng, min(shape), self.cfg.eval_rois)
        return torch.as_tensor(grid, device=self.device), rois


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 becomes f32 (numpy has no bf16), values unchanged."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _random_rois(rng, grid_size, n):
    lo = rng.uniform(0, grid_size * 0.6, (n, 3))
    hi = lo + rng.uniform(grid_size * 0.1, grid_size * 0.4, (n, 3))
    return np.concatenate([lo, np.minimum(hi, grid_size)], 1).astype(np.float32)
