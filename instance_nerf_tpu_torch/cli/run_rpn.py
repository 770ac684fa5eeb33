"""Anchor NeRF-RPN CLI on PyTorch (the argparse surface of
``instance_nerf_tpu.cli.run_rpn``, plus ``--device``, ``--dtype`` and
``--grid``).

Modes: ``train`` (``RPNTrainer.train_loop``: checkpoints under
``--save_path``, an eval of the val split every ``--eval_interval`` epochs;
prints the loop's summary as JSON), ``eval`` (recall / AP over a dataset;
with ``--save_results`` the per-scene proposals and FPN level features that
build the RCNN's ``rois/``), ``check_arch``, ``benchmark`` and ``profile``
(``predict_scene`` split by stage and kernel).

    python -m instance_nerf_tpu_torch.cli.run_rpn --mode train --rotated_bbox \
        --features_path D/features --boxes_path D/boxes_obb --save_path OUT

    python -m instance_nerf_tpu_torch.cli.run_rpn --mode check_arch --device cpu --rotated_bbox
    python -m instance_nerf_tpu_torch.cli.run_rpn --mode eval --features_path D/features \
        --boxes_path D/metadata --dataset_split D/dataset_split.json --save_path OUT --save_results
    python -m instance_nerf_tpu_torch.cli.run_rpn --mode profile --rotated_bbox --resolution 200
"""
from __future__ import annotations

import argparse
import json

from instance_nerf_tpu_torch.cli.common import finish, report_eval, setup_logging


def build_parser():
    p = argparse.ArgumentParser("run_rpn")
    p.add_argument("--mode", default="train",
                   choices=["train", "eval", "benchmark", "check_arch", "profile"])
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--features_path", default="")
    p.add_argument("--boxes_path", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory of the port, or a flax params tree as .npz")
    p.add_argument("--backbone_type", default="vgg_EF")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--normalize_density", action="store_true", default=True)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--grid", type=int, nargs=3, default=None, metavar=("W", "L", "H"),
                   help="benchmark/profile grid (default R R 13R/20)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=160)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--log_interval", type=int, default=30)
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--eval_interval", type=int, default=4)
    p.add_argument("--keep_checkpoints", type=int, default=2)
    p.add_argument("--rotate_prob", type=float, default=0.5)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--rot_scale_prob", type=float, default=0.0)
    p.add_argument("--rpn_head_conv_depth", type=int, default=4)
    p.add_argument("--rpn_pre_nms_top_n", type=int, default=1000)
    p.add_argument("--rpn_post_nms_top_n", type=int, default=1000)
    p.add_argument("--rpn_nms_thresh", type=float, default=0.7)
    p.add_argument("--rpn_score_thresh", type=float, default=0.0)
    p.add_argument("--reg_loss_type", default="smooth_l1",
                   choices=["smooth_l1", "iou", "linear_iou", "giou", "diou"])
    p.add_argument("--proj2d_loss_weight", type=float, default=1.0)
    p.add_argument("--batch_size_per_mesh", type=int, default=256)
    # eval export
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--output_proposals", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.7)
    p.add_argument("--output_voxel_scores", action="store_true")
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args):
    from instance_nerf_tpu_torch.train.rpn_trainer import RPNConfig

    return RPNConfig(
        features_path=args.features_path,
        boxes_path=args.boxes_path,
        dataset_split=args.dataset_split,
        save_path=args.save_path,
        checkpoint=args.checkpoint,
        normalize_density=args.normalize_density,
        backbone_type=args.backbone_type,
        resolution=args.resolution,
        rotated_bbox=args.rotated_bbox,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm,
        log_interval=args.log_interval,
        eval_interval=args.eval_interval,
        keep_checkpoints=args.keep_checkpoints,
        dtype=args.dtype,
        conv_depth=args.rpn_head_conv_depth,
        pre_nms_top_n=args.rpn_pre_nms_top_n,
        post_nms_top_n=args.rpn_post_nms_top_n,
        nms_thresh=args.rpn_nms_thresh,
        score_thresh=args.rpn_score_thresh,
        reg_loss_type=args.reg_loss_type,
        proj2d_loss_weight=args.proj2d_loss_weight,
        batch_size_per_mesh=args.batch_size_per_mesh,
        flip_prob=args.flip_prob,
        rotate_prob=args.rotate_prob,
        rot_scale_prob=args.rot_scale_prob,
        max_gt=args.max_gt,
        resume=args.resume,
        seed=args.seed,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args)

    from instance_nerf_tpu_torch.train.rpn_trainer import RPNTrainer

    trainer = RPNTrainer(config_from_args(args), device=args.device)
    if args.mode == "train":
        finish(trainer.train_loop())
        return
    trainer.init_state()
    if args.mode == "eval":
        ds = trainer.make_dataset("test" if args.dataset_split else "val")
        metrics = trainer.eval(
            ds, save_results_path=args.save_path if args.save_results else None,
            output_proposals=args.output_proposals, filter_mode=args.filter,
            filter_threshold=args.filter_threshold,
            output_voxel_scores=args.output_voxel_scores)
        report_eval(metrics, args.save_path)
        return
    shape = tuple(args.grid or (args.resolution,) * 2 + (args.resolution * 13 // 20,))
    if args.mode == "benchmark":
        print(json.dumps(trainer.benchmark(reps=20, shape=shape)))
    elif args.mode == "profile":
        print(json.dumps(trainer.profile(shape=shape)))
    else:
        print(json.dumps(trainer.check_arch(min(args.resolution, 64))))


if __name__ == "__main__":
    main()
