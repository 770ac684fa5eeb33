"""Anchor NeRF-RPN proposal inference and eval (PyTorch counterpart of
``instance_nerf_tpu.train.rpn_trainer``; the training methods come with
slice 5).

``RPNTrainer`` runs on ``device="cuda"`` unless the caller asks for the
CPU; with no CUDA device it raises instead of carrying on on the CPU.
``predict_scene`` pads a scene's grid to multiples of 32, runs the
backbone and the RPN head, masks the anchors of the padding and filters
the proposals: with ``rotated_bbox`` the per-level NMS computes the dense
rotated IoU and sweeps it with kernel B2, else it runs kernel B1. ``eval``
scores the proposals of a dataset and exports them with the FPN level
features: the files the RCNN's ``SegmentationDataset`` reads as ``rois/``.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

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
from instance_nerf_tpu_torch.train.rcnn_trainer import init_rcnn_params, to_numpy
from instance_nerf_tpu_torch.train.timing import Stages, benchmark_ms, profile_ms


@dataclass
class RPNConfig:
    """The inference and data fields of the JAX package's ``RPNConfig``."""

    features_path: str = ""
    boxes_path: str = ""
    dataset_split: str = ""
    save_path: str = ""
    checkpoint: str = ""  # .npz of a flax params tree ("/"-joined keys)
    normalize_density: bool = True
    backbone_type: str = "vgg_EF"
    resolution: int = 160
    rotated_bbox: bool = False
    # compute dtype (params stay f32); bf16 on the card by default
    dtype: str = "bfloat16"
    conv_depth: int = 4
    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 1000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    fpn_strides: tuple = (4, 8, 16, 32)
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
    """The eval split ``mode`` of ``cfg``'s dataset (all scenes without a
    split file), unaugmented as the JAX trainers build it. The train split,
    which they augment, comes with training in slice 5."""
    if mode == "train":
        raise NotImplementedError("the augmented train split comes with slice 5 "
                                  "(detector training)")
    scene_list = read_split(cfg.dataset_split, mode) if cfg.dataset_split else None
    return RPNDataset(
        features_path=cfg.features_path, boxes_path=cfg.boxes_path or None,
        scene_list=scene_list, normalize_density=cfg.normalize_density, preload=preload,
        seed=cfg.seed)


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
    def __init__(self, cfg: RPNConfig | None = None, device="cuda"):
        self.cfg = cfg = cfg or RPNConfig()
        self.device = resolve_device(device)
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
            fpn_strides=cfg.fpn_strides, dtype=self.dtype)
        self.model.eval()
        self.params_loaded = False
        # ``predict_scene``'s stages: profiler ranges ``rpn.<name>``
        self._stage = Stages("rpn")

    def make_dataset(self, mode: str) -> RPNDataset:
        return rpn_dataset(self.cfg, mode)

    # -- state ----------------------------------------------------------------

    def init_state(self):
        """Seeded random init, or ``cfg.checkpoint`` (a flax params ``.npz``)."""
        if self.cfg.checkpoint:
            self.load_jax_params(self.cfg.checkpoint)
            return
        init_rpn_params(self.model, self.cfg.seed)
        self.model.to(self.device)
        self.params_loaded = True

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
