"""NeRF-RCNN CLI on PyTorch (same argparse surface as
``instance_nerf_tpu.cli.run_rcnn``, plus ``--device``, ``--dtype``,
``--grid`` and ``--device_data``).

Modes: ``train`` (``RCNNTrainer.train_loop`` on the dataset's precomputed
rois, the backbone grafted from ``--rpn_ckpt``: checkpoints under
``--save_path``, an eval every ``--eval_interval`` epochs; prints the loop's
summary as JSON), ``eval`` (box and mask mAP / AR over a
``SegmentationDataset``; with ``--save_path`` the masks of each scene and
``eval.json``), ``check_arch``, ``benchmark`` and ``profile`` (a
``torch.profiler`` split of ``predict_scene`` by stage and kernel).
``--rpn_ckpt`` and ``--rcnn_ckpt`` are checkpoint directories of the port or
flax params ``.npz`` files.

    python -m instance_nerf_tpu_torch.cli.run_rcnn --mode train --dataset_root D \
        --rpn_ckpt FCOS_OUT --save_path OUT

    python -m instance_nerf_tpu_torch.cli.run_rcnn --mode check_arch
    python -m instance_nerf_tpu_torch.cli.run_rcnn --mode eval --dataset_root D --save_path OUT
    python -m instance_nerf_tpu_torch.cli.run_rcnn --mode benchmark --resolution 200
    python -m instance_nerf_tpu_torch.cli.run_rcnn --mode profile --resolution 200 --grid 200 200 132
"""
from __future__ import annotations

import argparse
import json
import os

from instance_nerf_tpu_torch.cli.common import finish, report_eval, setup_logging


def build_parser():
    p = argparse.ArgumentParser("run_rcnn")
    p.add_argument("--mode", default="train",
                   choices=["train", "eval", "benchmark", "check_arch",
                            "profile"])
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--dataset_root", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--rpn_ckpt", default="",
                   help="FCOS or RPN checkpoint whose backbone is grafted in")
    p.add_argument("--rcnn_ckpt", default="",
                   help="checkpoint directory of the port, or a flax params tree as .npz")
    p.add_argument("--rpn_type", choices=["anchor", "fcos"], default="fcos")
    p.add_argument("--backbone_type", default="vgg_EF")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--num_classes", type=int, default=11)
    p.add_argument("--bbox_type", choices=["aabb", "obb"], default="aabb")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--grid", type=int, nargs=3, default=None, metavar=("W", "L", "H"),
                   help="benchmark/profile grid (default R R 13R/16)")
    p.add_argument("--use_input_rois", action="store_true", default=True)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--eval_interval", type=int, default=5)
    p.add_argument("--keep_checkpoints", type=int, default=2)
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--rpn_batch_size_per_mesh", type=int, default=256)
    p.add_argument("--batch_size_per_image", type=int, default=512)
    p.add_argument("--positive_fraction", type=float, default=0.25)
    p.add_argument("--box_fg_iou_thresh", type=float, default=0.25)
    p.add_argument("--box_bg_iou_thresh", type=float, default=0.25)
    p.add_argument("--RCNN_box_score_thresh", type=float, default=0.0)
    p.add_argument("--RCNN_box_nms_thresh", type=float, default=0.15)
    p.add_argument("--RCNN_detections_per_img", type=int, default=25)
    p.add_argument("--max_rois", type=int, default=256)
    p.add_argument("--eval_rois", type=int, default=20)
    p.add_argument("--max_gt", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps a dispatch (run one after another)")
    p.add_argument("--device_data", action="store_true",
                   help="hold the train split on the card")
    return p


def config_from_args(args):
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNConfig

    return RCNNConfig(
        dataset_root=args.dataset_root,
        dataset_split=args.dataset_split,
        save_path=args.save_path,
        rpn_ckpt=args.rpn_ckpt,
        rcnn_ckpt=args.rcnn_ckpt,
        backbone_type=args.backbone_type,
        resolution=args.resolution,
        num_classes=args.num_classes,
        dtype=args.dtype,
        bbox_type=args.bbox_type,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm,
        log_interval=args.log_interval,
        eval_interval=args.eval_interval,
        keep_checkpoints=args.keep_checkpoints,
        steps_per_call=args.steps_per_call,
        device_data=args.device_data,
        freeze_backbone=args.freeze_backbone,
        batch_size_per_image=args.batch_size_per_image,
        positive_fraction=args.positive_fraction,
        fg_iou_thresh=args.box_fg_iou_thresh,
        bg_iou_thresh=args.box_bg_iou_thresh,
        box_score_thresh=args.RCNN_box_score_thresh,
        box_nms_thresh=args.RCNN_box_nms_thresh,
        detections_per_img=args.RCNN_detections_per_img,
        max_rois=args.max_rois,
        eval_rois=args.eval_rois,
        max_gt=args.max_gt,
        seed=args.seed,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args)

    from instance_nerf_tpu_torch.data.datasets import SegmentationDataset
    from instance_nerf_tpu_torch.train.rcnn_trainer import RCNNTrainer

    trainer = RCNNTrainer(config_from_args(args), device=args.device)
    if args.mode == "train":
        finish(trainer.train_loop())
        return
    trainer.init_state()
    if args.mode == "eval":
        ds = SegmentationDataset("val", args.dataset_root, args.dataset_split or None)
        metrics = trainer.eval(
            ds, save_masks_path=os.path.join(args.save_path, "masks") if args.save_path else None)
        report_eval(metrics, args.save_path)
        return
    shape = tuple(args.grid or (args.resolution,) * 2 + (args.resolution * 13 // 16,))
    if args.mode == "benchmark":
        print(json.dumps(trainer.benchmark(reps=20, shape=shape)))
    elif args.mode == "profile":
        print(json.dumps(trainer.profile(shape=shape)))
    else:
        print(json.dumps(trainer.check_arch(min(args.resolution, 64))))


if __name__ == "__main__":
    main()
