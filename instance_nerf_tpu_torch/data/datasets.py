"""On-disk dataset loading + fixed-shape batching (host-side numpy): the
port's copy of ``instance_nerf_tpu.data.datasets``.

Two dependencies are the port's own: density -> alpha goes through the
port's build of the native library (``data/native.py``, numpy without a
toolchain), and OBB rois become AABBs through the port's
``ops/boxes.py:obb2hbb_3d`` on a CPU tensor.

Capability parity with ``nerf_rcnn/datasets.py``: the reference's on-disk
layout is preserved (``features/<scene>.npz['rgbsigma','resolution']``,
``metadata/<scene>.json`` instances with world-coord aabbs rescaled into
grid coords, ``masks/<scene>.npy`` int instance-id voxel grids,
``rois/<scene>.npz['proposals','level_indices']``,
``dataset_split.json``), density→alpha normalizations for both NGP and
dense-depth-priors NeRFs, and the 3D-FRONT NYU40 10-class remap.

TPU redesign: instead of list-of-variable-tensors collation (ref
collate_fn), batches are padded to fixed shapes once on the host —
``RPNBatch``/``RCNNBatch`` arrays ship straight to device and every jit
sees one signature. Layout stays channels-last ``(W, L, H, C)`` end to
end (the reference transposes to torch's channels-first).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from instance_nerf_tpu_torch.data import native
from instance_nerf_tpu_torch.data.augment import augment_rpn_inputs, draw_augment

# 3D-FRONT NYU40 subset; remapped to 1..10, 0 = background
# (ref: datasets.py:829-862)
FRONT3D_CLASS_IDS = [3, 4, 5, 6, 7, 10, 14, 32, 35, 39]
FRONT3D_NUM_CLASSES = len(FRONT3D_CLASS_IDS)
FRONT3D_CLASS_MAP = {cid: i + 1 for i, cid in enumerate(FRONT3D_CLASS_IDS)}


def ngp_density_to_alpha(density: np.ndarray) -> np.ndarray:
    """instant-ngp σ -> alpha (ref: datasets.py:865-866), through the native
    library (``data/native.py``)."""
    return native.density_to_alpha(density, "ngp")


def ddp_nerf_density_to_alpha(density: np.ndarray) -> np.ndarray:
    """dense-depth-priors (ScanNet) σ -> alpha (ref: datasets.py:869-872)."""
    return native.density_to_alpha(density, "ddp_nerf")


DENSITY_FNS = {"ngp": ngp_density_to_alpha, "ddp_nerf": ddp_nerf_density_to_alpha}


def load_feature_grid(
    path: str,
    normalize_density: bool = True,
    density_type: str = "ngp",
    transpose_yz: bool = True,
) -> np.ndarray:
    """Load ``rgbsigma`` as float32 channels-last ``(W, L, H, 4)``.

    Handles both storage forms the reference accepts: 4-D ``(W, L, H, C)``
    grids and flat ``(H*L*W, C)`` + resolution (ref: datasets.py:768-793).
    """
    with np.load(path) as f:
        raw = f["rgbsigma"]
        is_u8 = raw.dtype == np.uint8
        rgbsigma = raw.astype(np.float32, copy=True)
        if is_u8:  # uint8 storage keeps rgb (and σ) in 0-255 — rescale
            rgbsigma /= 255.0  # before alpha (ref: datasets.py:788-791)
        res = f["resolution"] if "resolution" in f else None
        if rgbsigma.ndim == 2:
            rgbsigma = rgbsigma.reshape(res[2], res[1], res[0], -1)
            if transpose_yz:
                rgbsigma = np.transpose(rgbsigma, (0, 2, 1, 3))  # (W, L, H, C)
            else:
                rgbsigma = np.transpose(rgbsigma, (2, 1, 0, 3))
        if normalize_density:
            rgbsigma[..., -1] = DENSITY_FNS[density_type](rgbsigma[..., -1])
    return rgbsigma


def boxes_from_metadata(metadata: dict, grid_res: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """World-coord instance aabbs -> grid coords (ref: datasets.py:243-263).

    Returns (boxes (N, 6), class_ids (N,) raw NYU40 ids).
    """
    scene_bbox = np.asarray(metadata["scene_bbox"], np.float32)
    diag = scene_bbox[3:] - scene_bbox[:3]
    instances = sorted(metadata["instances"], key=lambda x: x["id"])
    boxes = np.asarray([x["aabb"] for x in instances], np.float32).reshape(-1, 6)
    boxes[:, :3] = (boxes[:, :3] - scene_bbox[:3]) / diag * np.asarray(grid_res)
    boxes[:, 3:] = (boxes[:, 3:] - scene_bbox[:3]) / diag * np.asarray(grid_res)
    class_ids = np.asarray([x.get("class_id", 0) for x in instances], np.int64)
    return boxes, class_ids


def remap_front3d_classes(class_ids: np.ndarray) -> np.ndarray:
    return np.asarray([FRONT3D_CLASS_MAP.get(int(c), 0) for c in class_ids], np.int64)


def read_split(split_path: str, mode: str) -> list[str]:
    with open(split_path) as f:
        split = json.load(f)
    # accept both the rcnn {"train": [...]} layout and npz-style keys
    key = mode if mode in split else f"{mode}_scenes"
    return list(split[key])


# ---------------------------------------------------------------------------
# RPN dataset
# ---------------------------------------------------------------------------


@dataclass
class RPNBatch:
    grids: np.ndarray  # (N, W, L, H, 4) padded
    grid_sizes: np.ndarray  # (N, 3) float
    gt_boxes: np.ndarray  # (N, K, 6|7) padded
    gt_mask: np.ndarray  # (N, K) bool
    scenes: list[str]


class RPNDataset:
    """Scene grids + gt boxes (Front3D/Hypersim/ScanNet/general layouts).

    ``boxes_path`` may hold ``<scene>.npy`` box arrays or ``<scene>.json``
    metadata (3D-FRONT); both are accepted like Front3DRPNDataset.
    """

    def __init__(
        self,
        features_path: str,
        boxes_path: str | None = None,
        scene_list: Sequence[str] | None = None,
        normalize_density: bool = True,
        density_type: str = "ngp",
        flip_prob: float = 0.0,
        rotate_prob: float = 0.0,
        rot_scale_prob: float = 0.0,
        preload: bool = False,
        seed: int = 0,
    ):
        self.features_path = features_path
        self.boxes_path = boxes_path
        self.normalize_density = normalize_density
        self.density_type = density_type
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rot_scale_prob = rot_scale_prob
        self.rng = np.random.default_rng(seed)

        if scene_list is None:
            scene_list = sorted(
                f[:-4] for f in os.listdir(features_path) if f.endswith(".npz")
            )
        self.scenes = [s for s in scene_list if self._has_data(s)]
        self._cache = {}
        if preload:
            for s in self.scenes:
                self._cache[s] = self._load(s)

    def _has_data(self, scene: str) -> bool:
        if not os.path.isfile(os.path.join(self.features_path, scene + ".npz")):
            return False
        if self.boxes_path is None:
            return True
        npy = os.path.join(self.boxes_path, scene + ".npy")
        js = os.path.join(self.boxes_path, scene + ".json")
        if os.path.isfile(npy):
            return np.load(npy).shape[0] > 0
        return os.path.isfile(js)

    def _load(self, scene: str):
        grid = load_feature_grid(
            os.path.join(self.features_path, scene + ".npz"),
            self.normalize_density,
            self.density_type,
        )
        boxes = None
        if self.boxes_path is not None:
            npy = os.path.join(self.boxes_path, scene + ".npy")
            js = os.path.join(self.boxes_path, scene + ".json")
            if os.path.isfile(npy):
                boxes = np.load(npy).astype(np.float32)
            else:
                with open(js) as f:
                    boxes, _ = boxes_from_metadata(json.load(f), grid.shape[:3])
        return grid, boxes

    def __len__(self):
        return len(self.scenes)

    def get(self, index: int, augment: bool = False):
        scene = self.scenes[index]
        grid, boxes = self._cache.get(scene) or self._load(scene)
        if augment:
            grid, boxes = augment_rpn_inputs(
                self.rng, grid, boxes,
                self.flip_prob, self.rotate_prob, self.rot_scale_prob,
            )
        return scene, grid, boxes

    def _has_obb(self, scene: str) -> bool:
        """Whether the scene's boxes are OBBs (seven numbers), without
        loading its grid."""
        if scene in self._cache:
            boxes = self._cache[scene][1]
            return boxes is not None and boxes.shape[1] == 7
        if self.boxes_path is None:
            return False
        npy = os.path.join(self.boxes_path, scene + ".npy")
        return os.path.isfile(npy) and np.load(npy, mmap_mode="r").shape[1] == 7

    def skip(self, index: int) -> None:
        """Take the augmentation draws ``get(index, augment=True)`` would,
        without loading the scene (another rank's row of a batch)."""
        draw_augment(self.rng, self._has_obb(self.scenes[index]), self.flip_prob,
                     self.rotate_prob, self.rot_scale_prob)

    def batch(
        self,
        indices: Sequence[int],
        pad_shape: tuple[int, int, int],
        max_gt: int = 64,
        box_dim: int = 6,
        augment: bool = False,
        rows: tuple | None = None,
    ) -> RPNBatch:
        """The scenes ``indices`` padded to ``pad_shape``; ``rows = (lo,
        hi)`` loads only ``indices[lo:hi]`` (a rank's share), the others'
        augmentation draws taken and dropped, so every rank's draws are
        those of the whole batch."""
        if rows is not None:
            lo, hi = rows
            if augment:
                for idx in indices[:lo]:
                    self.skip(idx)
            out = self.batch(indices[lo:hi], pad_shape, max_gt, box_dim, augment)
            if augment:
                for idx in indices[hi:]:
                    self.skip(idx)
            return out
        n = len(indices)
        grids = np.zeros((n, *pad_shape, 4), np.float32)
        sizes = np.zeros((n, 3), np.float32)
        gt = np.zeros((n, max_gt, box_dim), np.float32)
        gt_m = np.zeros((n, max_gt), bool)
        scenes = []
        for i, idx in enumerate(indices):
            scene, grid, boxes = self.get(idx, augment=augment)
            w, l, h = grid.shape[:3]
            grids[i, :w, :l, :h] = grid[: pad_shape[0], : pad_shape[1], : pad_shape[2]]
            sizes[i] = (min(w, pad_shape[0]), min(l, pad_shape[1]), min(h, pad_shape[2]))
            if boxes is not None and boxes.shape[0] > 0:
                k = min(boxes.shape[0], max_gt)
                gt[i, :k] = boxes[:k, :box_dim]
                gt_m[i, :k] = True
            scenes.append(scene)
        return RPNBatch(grids, sizes, gt, gt_m, scenes)


# ---------------------------------------------------------------------------
# RCNN (segmentation) dataset
# ---------------------------------------------------------------------------


@dataclass
class RCNNBatch:
    grids: np.ndarray  # (N, W, L, H, 4)
    grid_sizes: np.ndarray  # (N, 3)
    gt_boxes: np.ndarray  # (N, K, 6)
    gt_labels: np.ndarray  # (N, K) int
    gt_mask: np.ndarray  # (N, K) bool
    gt_voxel_masks: np.ndarray  # (N, K, W, L, H) uint8 per-instance masks
    rois: np.ndarray  # (N, P, 6)
    roi_level: np.ndarray  # (N, P) int
    roi_mask: np.ndarray  # (N, P) bool
    scenes: list[str]


class SegmentationDataset:
    """RCNN dataset over the reference layout: features/ masks/ rois/
    metadata/ + dataset_split.json (ref: datasets.py:668-824,
    nerf_rcnn/README.md:11-31)."""

    def __init__(
        self,
        mode: str,
        root_dir: str,
        data_split: str | None = None,
        normalize_density: bool = True,
        density_type: str = "ngp",
        transpose_yz: bool = True,
        remap_classes: bool = True,
        cache: bool = False,
    ):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.root = root_dir
        self.normalize_density = normalize_density
        self.density_type = density_type
        self.transpose_yz = transpose_yz
        self.remap_classes = remap_classes
        split_path = data_split or os.path.join(root_dir, "dataset_split.json")
        self.scenes = read_split(split_path, mode)
        self.n_classes = FRONT3D_NUM_CLASSES
        # optional host-RAM cache of decoded scenes (single-core host:
        # one decompress per scene instead of one per epoch)
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.scenes)

    def load_scene(self, index: int):
        if self._cache is not None and index in self._cache:
            # shallow copy: callers may add/replace keys (e.g. augmented
            # grids) without corrupting the cache across epochs; the
            # array VALUES are still shared and must not be mutated
            return dict(self._cache[index])
        d = self._load_scene(index)
        if self._cache is not None:
            self._cache[index] = d
        return dict(d) if self._cache is not None else d

    def _load_scene(self, index: int):
        scene = self.scenes[index]
        grid = load_feature_grid(
            os.path.join(self.root, "features", scene + ".npz"),
            self.normalize_density,
            self.density_type,
            self.transpose_yz,
        )
        roi_npz = np.load(os.path.join(self.root, "rois", scene + ".npz"))
        rois = roi_npz["proposals"].astype(np.float32)
        level_indices = roi_npz["level_indices"].astype(np.int64)
        if rois.shape[1] == 7:  # OBB proposals -> enclosing AABB
            import torch

            from instance_nerf_tpu_torch.ops.boxes import obb2hbb_3d

            rois = obb2hbb_3d(torch.from_numpy(rois)).numpy()

        if self.mode == "test":
            return dict(scene=scene, grid=grid, rois=rois,
                        level_indices=level_indices, boxes=None,
                        class_ids=None, masks=None)

        mask_grid = np.load(os.path.join(self.root, "masks", scene + ".npy"))
        with open(os.path.join(self.root, "metadata", scene + ".json")) as f:
            metadata = json.load(f)
        boxes, class_ids = boxes_from_metadata(metadata, mask_grid.shape)
        if self.remap_classes:
            class_ids = remap_front3d_classes(class_ids)
        instances = sorted(metadata["instances"], key=lambda x: x["id"])
        inst_masks = np.stack(
            [(mask_grid == inst["id"]).astype(np.uint8) for inst in instances]
        ) if instances else np.zeros((0, *mask_grid.shape), np.uint8)
        return dict(scene=scene, grid=grid, rois=rois,
                    level_indices=level_indices, boxes=boxes,
                    class_ids=class_ids, masks=inst_masks)

    def batch(
        self,
        indices: Sequence[int],
        pad_shape: tuple[int, int, int],
        max_gt: int = 32,
        max_rois: int = 256,
    ) -> RCNNBatch:
        n = len(indices)
        w0, l0, h0 = pad_shape
        grids = np.zeros((n, w0, l0, h0, 4), np.float32)
        sizes = np.zeros((n, 3), np.float32)
        gt = np.zeros((n, max_gt, 6), np.float32)
        labels = np.zeros((n, max_gt), np.int64)
        gt_m = np.zeros((n, max_gt), bool)
        vmasks = np.zeros((n, max_gt, w0, l0, h0), np.uint8)
        rois = np.zeros((n, max_rois, 6), np.float32)
        rlvl = np.zeros((n, max_rois), np.int64)
        rm = np.zeros((n, max_rois), bool)
        scenes = []
        for i, idx in enumerate(indices):
            d = self.load_scene(idx)
            scenes.append(d["scene"])
            g = d["grid"]
            w, l, h = (min(g.shape[0], w0), min(g.shape[1], l0), min(g.shape[2], h0))
            grids[i, :w, :l, :h] = g[:w, :l, :h]
            sizes[i] = (w, l, h)
            p = min(d["rois"].shape[0], max_rois)
            rois[i, :p] = d["rois"][:p]
            rlvl[i, :p] = d["level_indices"][:p]
            rm[i, :p] = True
            if d["boxes"] is not None:
                k = min(d["boxes"].shape[0], max_gt)
                gt[i, :k] = d["boxes"][:k]
                labels[i, :k] = d["class_ids"][:k]
                gt_m[i, :k] = True
                vmasks[i, :k, :w, :l, :h] = d["masks"][:k, :w, :l, :h]
        return RCNNBatch(grids, sizes, gt, labels, gt_m, vmasks, rois, rlvl, rm, scenes)


class RPNClassificationDataset:
    """Legacy two-stage classification dataset: precomputed FPN
    ``level_features`` + proposals per scene (the run_rpn --save_results
    export), with the fine-tune filter dropping RoIs covering > half the
    scene volume. Semantics: datasets.py:500-664 (SURVEY.md §2.13 —
    legacy path, kept for capability parity)."""

    def __init__(self, features_dir: str, rois_dir: str,
                 boxes_path: str | None = None,
                 scene_list: Sequence[str] | None = None,
                 filter_large_rois: bool = False,
                 max_volume_fraction: float = 0.5):
        self.features_dir = features_dir
        self.rois_dir = rois_dir
        self.boxes_path = boxes_path
        self.filter_large = filter_large_rois
        self.max_volume_fraction = max_volume_fraction
        if scene_list is None:
            scene_list = sorted(
                f[:-4] for f in os.listdir(rois_dir) if f.endswith(".npz")
            )
        self.scenes = list(scene_list)

    def __len__(self):
        return len(self.scenes)

    def load_scene(self, index: int):
        scene = self.scenes[index]
        feats_npz = np.load(os.path.join(self.features_dir, scene + ".npz"))
        levels = [feats_npz[k] for k in sorted(feats_npz.files) if k.startswith("level_")]
        rois_npz = np.load(os.path.join(self.rois_dir, scene + ".npz"))
        proposals = rois_npz["proposals"].astype(np.float32)
        level_indices = rois_npz["level_indices"].astype(np.int64)
        if self.filter_large and "resolution" in feats_npz:
            res = feats_npz["resolution"].astype(np.float64)
            vol = np.prod(
                np.clip(proposals[:, 3:6] - proposals[:, 0:3], 0, None), axis=1
            )
            keep = vol <= self.max_volume_fraction * np.prod(res)
            proposals, level_indices = proposals[keep], level_indices[keep]
        boxes = None
        if self.boxes_path:
            js = os.path.join(self.boxes_path, scene + ".json")
            npy = os.path.join(self.boxes_path, scene + ".npy")
            if os.path.isfile(npy):
                boxes = np.load(npy).astype(np.float32)
            elif os.path.isfile(js):
                with open(js) as f:
                    res = feats_npz.get("resolution", np.asarray(levels[0].shape[:3]) * 4)
                    boxes, _ = boxes_from_metadata(json.load(f), res)
        return dict(scene=scene, level_features=levels, proposals=proposals,
                    level_indices=level_indices, boxes=boxes)


class GeneralRPNDataset(RPNDataset):
    """CSV-driven scene list (ref: datasets.py:363-436 'general' layout):
    a csv with one scene id per line (optional header)."""

    def __init__(self, csv_path: str, features_path: str,
                 boxes_path: str | None = None, **kwargs):
        with open(csv_path) as f:
            lines = [ln.strip().split(",")[0] for ln in f if ln.strip()]
        if lines and lines[0].lower() in ("scene", "scene_id", "id"):
            lines = lines[1:]
        super().__init__(features_path, boxes_path, scene_list=lines, **kwargs)


class HypersimRPNDataset(RPNDataset):
    """Hypersim variant (npy boxes; same on-disk layout)."""


class ScanNetRPNDataset(RPNDataset):
    """ScanNet variant — dense-depth-priors NeRF densities
    (density_type='ddp_nerf', ref: datasets.py:869-872)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("density_type", "ddp_nerf")
        super().__init__(*args, **kwargs)


def split_dataset(scenes: Sequence[str], train_ratio: float, val_ratio: float,
                  output_path: str, seed: int = 0):
    """Random train/val/test split -> json (ref: split_hypersim_dataset,
    datasets.py:438-456; json instead of npz so RCNN + RPN share one format)."""
    rng = np.random.default_rng(seed)
    scenes = list(scenes)
    rng.shuffle(scenes)
    n_train = int(len(scenes) * train_ratio)
    n_val = int(len(scenes) * (train_ratio + val_ratio))
    split = {
        "train": scenes[:n_train],
        "val": scenes[n_train:n_val],
        "test": scenes[n_val:],
    }
    with open(output_path, "w") as f:
        json.dump(split, f)
    return split
