"""NeRF-RCNN inference and eval (PyTorch counterpart of
``instance_nerf_tpu.train.rcnn_trainer``; the training methods come with
slice 5).

``RCNNTrainer`` runs on ``device="cuda"`` unless the caller asks for the
CPU; with no CUDA device it raises instead of carrying on on the CPU.
``eval`` scores the detections and masks of a ``SegmentationDataset``
(box and mask mAP / AR at IoU 0.25 and 0.5).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.convert import rcnn_params_from_jax, unflatten_npz
from instance_nerf_tpu_torch.data.datasets import SegmentationDataset
from instance_nerf_tpu_torch.eval.metrics import evaluate_map_recall
from instance_nerf_tpu_torch.models.backbones import build_backbone
from instance_nerf_tpu_torch.models.rcnn import (
    ConvTranspose3d,
    Detections,
    NeRF_RCNN,
    maskrcnn_inference,
    paste_detections,
    postprocess_detections,
)
from instance_nerf_tpu_torch.models.layers import Conv3d, GroupNorm, Linear
from instance_nerf_tpu_torch.train.timing import Stages, benchmark_ms, profile_ms


@dataclass
class RCNNConfig:
    rcnn_ckpt: str = ""  # .npz of a flax params tree ("/"-joined keys)
    backbone_type: str = "vgg_EF"
    resolution: int = 160
    num_classes: int = 11  # 10 fg + background
    # compute dtype (params stay f32); bf16 on the card by default
    dtype: str = "bfloat16"
    bbox_type: str = "aabb"
    box_score_thresh: float = 0.0
    box_nms_thresh: float = 0.15
    detections_per_img: int = 25
    eval_rois: int = 20  # inference.sh: rois[:20]
    mask_paste_threshold: float = 0.5
    seed: int = 0


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal(shape, std, gen):
    """Normal truncated to +-2 std by inverse CDF (flax's variance-scaling
    ``truncated_normal``)."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return torch.erfinv(2 * u - 1) * (math.sqrt(2) * std / _TRUNC_STD)


def init_rcnn_params(model: NeRF_RCNN, seed: int) -> None:
    """Seeded random init with flax's initializers: he-normal for the
    backbone and mask convs, xavier-uniform for the FPN convs, lecun-normal
    for the dense layers and the mask logits; zero biases, unit norm
    scales. The numbers differ from JAX's (another generator)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
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
            elif isinstance(mod, Linear) or name.endswith("mask_fcn_logits"):
                val = _trunc_normal(w.shape, math.sqrt(1.0 / fan_in), gen)
            else:
                val = _trunc_normal(w.shape, math.sqrt(2.0 / fan_in), gen)
            w.copy_(val)
            mod.bias.zero_()


class RCNNTrainer:
    def __init__(self, cfg: RCNNConfig | None = None, device="cuda"):
        self.cfg = cfg = cfg or RCNNConfig()
        self.device = resolve_device(device)
        if cfg.bbox_type != "aabb":
            raise NotImplementedError("OBB RCNN comes with slice 5 (ROADMAP queue A)")
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else None
        if self.dtype is None and self.device.type == "cuda":
            # f32 means f32: cuDNN convs and matmuls default to TF32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        backbone = build_backbone(cfg.backbone_type,
                                  input_size=max(cfg.resolution, 160),
                                  dtype=self.dtype)
        self.model = NeRF_RCNN(backbone, num_classes=cfg.num_classes,
                               input_shape=(cfg.resolution,) * 3,
                               dtype=self.dtype)
        self.model.eval()
        self.params_loaded = False
        # ``predict_scene``'s stages: profiler ranges ``rcnn.<name>``
        self._stage = Stages("rcnn")

    # -- state ----------------------------------------------------------------

    def init_state(self):
        """Seeded random init, or ``cfg.rcnn_ckpt`` (a flax params ``.npz``)."""
        if self.cfg.rcnn_ckpt:
            self.load_jax_params(self.cfg.rcnn_ckpt)
            return
        init_rcnn_params(self.model, self.cfg.seed)
        self.model.to(self.device)
        self.params_loaded = True

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
