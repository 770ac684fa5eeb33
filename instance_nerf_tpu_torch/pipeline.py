"""The five-stage Instance-NeRF pipeline on synthetic data (PyTorch
counterpart of ``examples/full_pipeline_synthetic.py``, at its defaults):

  1. per-scene field training (brick tables T = 2^15, 3 levels x 4 features,
     adaptive-K over 48 jittered candidates, coarse occupancy 32^3 over
     64^3, background-transparency weight 0.5) and the RGBσ grid extracted;
  2. NeRF-RCNN (VGG-AF, 5 classes, trainable backbone) trained on that grid
     against jittered gt rois: ``select_training_samples`` (16 a scene), the
     box losses and the mask loss of the first 8 sampled rois, clip by global
     norm 1.0 then Adam 3e-4;
  3. NeRF-RCNN inference: ``postprocess_detections`` (its batched NMS is
     kernel B1 on the card), 4 detections, masks pasted into the grid;
  4. the 3D masks projected into every training view, and ``match_view``
     against per-view panoptic stand-ins (the gt segments with shuffled ids:
     the matcher is the real one);
  5. the field's instance stage on the matched masks; instance mIoU / PQ
     and the render PSNR on the held-out views no stage trained on.

Run on the card (the default) or with ``--device cpu``::

    python -m instance_nerf_tpu_torch.pipeline --workdir WORK [--out summary.json]

After every stage the summary lands atomically in ``--out`` (default
``WORK/summary.json``) with the JAX example's keys, the device (the card's
name and power limit) and, on the card, each stage's peak device memory
(``stageN_peak_bytes``). The files are the JAX example's: ``scene/`` (the
training views, ``images/r_###.png``, ``masks/r_###.npy``, ``boxes.npy``),
``rgbsigma.npy``, ``masks.npz`` (masks, scores, labels, boxes),
``projections/`` and ``masks_matched/r_###.npy``.

The draws come from numpy and torch generators seeded as the example seeds
its keys: the same recipe, not the same numbers as a JAX run. The summary is
a first reading, not a target.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device
from instance_nerf_tpu_torch.data.datasets import ngp_density_to_alpha
from instance_nerf_tpu_torch.data.nerf_dataset import (
    NeRFScene,
    load_nerf_scene,
    make_synthetic_nerf_scene,
    write_nerf_scene,
)
from instance_nerf_tpu_torch.data.synthetic import jittered_rois
from instance_nerf_tpu_torch.eval.instance_field_metrics import evaluate_instance_masks
from instance_nerf_tpu_torch.masks2d.match_seg import match_view
from instance_nerf_tpu_torch.masks2d.project_masks import write_projections
from instance_nerf_tpu_torch.models.backbones import VGG_FPN
from instance_nerf_tpu_torch.models.rcnn import (
    Detections,
    NeRF_RCNN,
    fastrcnn_loss,
    maskrcnn_inference,
    maskrcnn_loss,
    paste_detections,
    postprocess_detections,
    select_training_samples,
)
from instance_nerf_tpu_torch.parallel.train_step import Optimizer
from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer, fast_ngp_config
from instance_nerf_tpu_torch.train.rcnn_trainer import init_rcnn_params

N_ROIS = 16  # jittered gt rois, the RPN's stand-in
MASK_ROIS = 8  # sampled rois the mask loss sees
NUM_CLASSES = 5
VIEW_STEM = "r_{:03d}"  # the JAX scene writer's view names


def field_config():
    """Stage 1's field: the example's shipping adaptive-K config."""
    return fast_ngp_config(
        table_size=2 ** 15, n_levels=3, n_features=4, num_instances=5, n_rays=4096,
        n_samples=48, k_buckets=((0.5, 2), (0.25, 4), (0.25, 8)), ray_jitter=True,
        occ_res=64, occ_coarse_res=32,
        # the train split has gt masks: press background rays transparent so
        # few-view training cannot fake its PSNR with view-dependent fog
        bg_acc_weight=0.5)


def rcnn_losses(model: NeRF_RCNN, grids, s, masks):
    """Stage 2's loss of one sampled batch (the example's ``lf``): the box
    losses of every sampled roi and the mask loss of the first
    ``MASK_ROIS``. Returns ``(c + b + ml, (c, b, ml))``."""
    f, lg, dl = model(grids, s.rois)
    c, b = fastrcnn_loss(lg, dl, s.labels, s.reg_targets, s.valid)
    mlg = model.mask_forward(f, s.rois[:, :MASK_ROIS])
    ml = maskrcnn_loss(mlg[0], s.rois[0, :MASK_ROIS], masks, s.labels[0, :MASK_ROIS],
                       s.matched_gt_idx[0, :MASK_ROIS], s.pos[0, :MASK_ROIS])
    return c + b + ml, (c, b, ml)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class Pipeline:
    """The five stages over one synthetic scene; each ``stageN()`` lands its
    summary keys. The stage-3 inputs and detections stay on the object
    (``det``, ``postprocess``) so that a caller can re-run the
    post-processing with another NMS sweep."""

    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device)
        self.wd = args.workdir
        os.makedirs(self.wd, exist_ok=True)
        self.out_path = args.out or os.path.join(self.wd, "summary.json")
        self.summary = {"config": vars(args), "device": device_line(self.device)}
        self.rng = np.random.default_rng(0)
        self.g = args.grid

    def land(self, stage: str, **kv):
        self.summary.update(kv)
        os.makedirs(os.path.dirname(os.path.abspath(self.out_path)), exist_ok=True)
        tmp = self.out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.summary, f, indent=2)
        os.replace(tmp, self.out_path)
        print(f"[{stage}]", json.dumps(kv), flush=True)

    def _timed(self, stage: int, run) -> dict:
        """``run()`` -> its keys, with the stage's wall (synchronized) and,
        on the card, its peak device memory."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        kv = run()
        if cuda:
            torch.cuda.synchronize(self.device)
            kv[f"stage{stage}_peak_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        kv[f"stage{stage}_wall_s"] = round(time.time() - t0, 1)
        return kv

    # -- stage 0: the scene; the last ``holdout`` views stay out of every
    # training stage
    def stage0(self):
        a = self.args
        self.n_train = a.views - a.holdout
        # a view-filling scene (blobs about a third of the cube, a close
        # orbit): at the generator's defaults instances cover 1-5% of the
        # pixels and label-starve the stage-5 field
        self.full, self.gt_boxes_unit = make_synthetic_nerf_scene(
            self.rng, n_views=a.views, hw=(a.hw, a.hw), n_blobs=3, blob_lo=(0.1, 0.45),
            blob_size=(0.25, 0.4), cam_radius=1.05, cam_height=0.95, device=self.device)
        full, n = self.full, self.n_train
        self.scene = NeRFScene(full.images[:n], full.poses[:n], full.intrinsics, full.hw,
                               full.masks[:n])
        self.scene_dir = os.path.join(self.wd, "scene")
        write_nerf_scene(self.scene_dir, self.scene, boxes=self.gt_boxes_unit, stem=VIEW_STEM)
        self.land("0", scene=self.scene_dir, train_views=n, holdout=a.holdout)

    # -- stage 1: the field's rgb stage, then the RGBσ grid
    def stage1(self):
        def run():
            self.field = InstanceFieldTrainer(field_config(), seed=0, device=self.device)
            m = self.field.train(self.scene, self.args.ngp_steps, stage="rgb",
                                 log_every=10 ** 9)
            self.grid = self.field.extract_rgbsigma((self.g,) * 3)
            np.save(os.path.join(self.wd, "rgbsigma.npy"), self.grid)
            return {"psnr": round(float(m["psnr"]), 2)}

        self.land("1", **self._timed(1, run))

    # -- stage 2: RCNN training on the extracted grid (gt boxes in grid
    # coordinates, jittered gt as rois, the backbone trains)
    def stage2(self):
        g, dev = self.g, self.device
        self.gt_boxes = (self.gt_boxes_unit * g).astype(np.float32)
        self.feats_grid = np.concatenate(
            [self.grid[..., :3], ngp_density_to_alpha(self.grid[..., 3])[..., None]], -1)
        inst_grid = np.zeros((g, g, g), np.int64)
        for k, b in enumerate(self.gt_boxes):
            lo = np.floor(b[:3]).astype(int)
            hi = np.ceil(b[3:]).astype(int)
            inst_grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = k + 1
        k = len(self.gt_boxes)
        inst_masks = np.stack([(inst_grid == i + 1) for i in range(k)])
        rois, _ = jittered_rois(self.rng, self.gt_boxes, (g, g, g), num_rois=N_ROIS, noise=1.0)

        def run():
            if dev.type == "cuda":  # f32 means f32: no TF32 in cuDNN or the matmuls
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self.model = NeRF_RCNN(VGG_FPN(cfg="AF", input_size=160), num_classes=NUM_CLASSES,
                                   input_shape=(g, g, g))
            init_rcnn_params(self.model, 0)
            self.model.to(dev).train()
            self.grids = torch.as_tensor(self.feats_grid, device=dev)[None]
            self.rois = torch.as_tensor(rois, device=dev)[None]
            gt_b = torch.as_tensor(self.gt_boxes, device=dev)[None]
            gt_l = torch.arange(1, k + 1, device=dev)[None]
            masks = torch.as_tensor(inst_masks, dtype=torch.float32, device=dev)
            opt = Optimizer(self.model.named_parameters(), lr=3e-4, weight_decay=0.0,
                            clip_grad_norm=1.0)
            gen = torch.Generator(device=dev).manual_seed(1)
            tot = torch.zeros((), device=dev)
            for _ in range(self.args.rcnn_steps):
                s = select_training_samples(
                    self.rois, torch.ones((1, N_ROIS), dtype=torch.bool, device=dev), gt_b,
                    gt_l, torch.ones((1, k), dtype=torch.bool, device=dev),
                    batch_size_per_image=16, generator=gen)
                for p in self.model.parameters():
                    p.grad = None
                tot, _ = rcnn_losses(self.model, self.grids, s, masks)
                tot.backward()
                opt.step()
            self.model.eval()
            return {"rcnn_loss": round(float(tot.detach()), 3)}

        self.land("2", **self._timed(2, run))

    @torch.no_grad()
    def postprocess(self, nms_sweep=None) -> Detections:
        """Stage 3's detections of the trained RCNN's box outputs;
        ``nms_sweep`` replaces the NMS sweep (see ``ops.nms.nms_mask``)."""
        dev = self.device
        return postprocess_detections(
            self.lg, self.dl, self.rois, torch.ones((1, N_ROIS), dtype=torch.bool, device=dev),
            torch.tensor([[float(self.g)] * 3], device=dev), detections_per_img=4,
            nms_sweep=nms_sweep)

    # -- stage 3: RCNN inference -> 3D masks
    def stage3(self):
        g = self.g

        @torch.no_grad()
        def run():
            feats, self.lg, self.dl = self.model(self.grids, self.rois)
            self.det = det = self.postprocess()
            det0 = Detections(*[x[0] for x in det])
            mlg = self.model.mask_forward(feats, det.boxes)
            probs = maskrcnn_inference(mlg[0], det0.labels)
            masks3d = paste_detections(det0, probs, (g, g, g))
            v = det0.valid.cpu().numpy()
            self.det_masks = masks3d.cpu().numpy()[v]
            np.savez(os.path.join(self.wd, "masks.npz"), masks=self.det_masks,
                     scores=det0.scores.cpu().numpy()[v], labels=det0.labels.cpu().numpy()[v],
                     boxes=det0.boxes.cpu().numpy()[v])
            return {"detections": int(v.sum())}

        self.land("3", **self._timed(3, run))

    # -- stage 4: the 3D masks projected per view, then match_seg
    def stage4(self):
        def run():
            g, scene = self.g, self.scene
            det_grid = np.zeros((g, g, g), np.int32)
            for k in range(self.det_masks.shape[0]):
                det_grid[self.det_masks[k] > 0] = k + 1
            proj_dir = os.path.join(self.wd, "projections")
            write_projections(proj_dir, det_grid, self.feats_grid[..., 3], scene.poses,
                              scene.intrinsics, scene.hw, device=self.device)
            # the panoptic stand-in: gt segments with shuffled ids (the
            # Mask2Former slot); the matcher is the real one
            self.matched_dir = os.path.join(self.wd, "masks_matched")
            os.makedirs(self.matched_dir, exist_ok=True)
            n_matched = 0
            for vi in range(scene.num_views):
                seg = scene.masks[vi].astype(np.int32) * 7
                ids = np.load(os.path.join(proj_dir, f"{vi:04d}.npy"))
                proj_ids = [i for i in np.unique(ids) if i > 0]
                projs = (np.stack([ids == i for i in proj_ids]) if proj_ids
                         else np.zeros((0, *ids.shape), bool))
                out = match_view(seg, projs, np.asarray(proj_ids), iou_thresh=0.05)
                np.save(os.path.join(self.matched_dir, VIEW_STEM.format(vi) + ".npy"), out)
                n_matched += bool((out > 0).any())
            return {"matched_views": int(n_matched)}

        self.land("4", **self._timed(4, run))

    # -- stage 5: the instance stage on the matched masks; held-out views
    def stage5(self):
        def run():
            a, full = self.args, self.full
            scene_matched = load_nerf_scene(self.scene_dir, masks_dir=self.matched_dir)
            mi = self.field.train(scene_matched, a.field_steps, stage="instance",
                                  log_every=10 ** 9)
            preds, gts, holdout_psnr = [], [], []
            for vi in range(self.n_train, a.views):  # views no stage trained on
                out = self.field.render_image(full.poses[vi], full.intrinsics, full.hw,
                                              chunk=4096)
                preds.append(out["instance"])
                gts.append(full.masks[vi].astype(np.int32))
                # the render PSNR of a held-out view: density warped during
                # the instance stage shows here and not in the train PSNR
                mse = float(np.mean((out["rgb"] - np.asarray(full.images[vi])) ** 2))
                holdout_psnr.append(-10.0 * np.log10(max(mse, 1e-10)))
            m5 = evaluate_instance_masks(preds, gts, iou_thresh=0.3)
            return {"instance_ce": round(float(mi["instance"]), 4),
                    "pq": round(float(m5["pq"]), 4), "miou": round(float(m5["miou"]), 4),
                    "holdout_render_psnr": round(float(np.mean(holdout_psnr)), 2)}

        self.land("5", **self._timed(5, run))

    def run(self) -> "Pipeline":
        for stage in (self.stage0, self.stage1, self.stage2, self.stage3, self.stage4,
                      self.stage5):
            stage()
        print("PIPELINE OK", json.dumps(
            {k: self.summary[k] for k in ("psnr", "detections", "matched_views", "pq",
                                          "miou")}), flush=True)
        return self


def parse_args(argv=None):
    p = argparse.ArgumentParser("pipeline")
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--hw", type=int, default=64)
    p.add_argument("--views", type=int, default=10)
    p.add_argument("--holdout", type=int, default=2)
    p.add_argument("--ngp_steps", type=int, default=1500)
    p.add_argument("--rcnn_steps", type=int, default=200)
    p.add_argument("--field_steps", type=int, default=500)
    return p.parse_args(argv)


def main(argv=None) -> Pipeline:
    """Run the five stages; returns the finished ``Pipeline`` (its
    ``summary`` is what ``--out`` holds)."""
    return Pipeline(parse_args(argv)).run()


if __name__ == "__main__":
    main()
