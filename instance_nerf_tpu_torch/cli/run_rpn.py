"""Anchor NeRF-RPN CLI on PyTorch (the argparse surface of
``instance_nerf_tpu.cli.run_rpn``, plus ``--device``, ``--dtype`` and
``--grid``).

Modes: ``eval`` (recall / AP over a dataset; with ``--save_results`` the
per-scene proposals and FPN level features that build the RCNN's
``rois/``), ``check_arch``, ``benchmark`` and ``profile`` (``predict_scene``
split by stage and kernel). ``train`` comes with slice 5 and raises
``NotImplementedError``; its flags come with it.

    python -m instance_nerf_tpu_torch.cli.run_rpn --mode check_arch --device cpu --rotated_bbox
    python -m instance_nerf_tpu_torch.cli.run_rpn --mode eval --features_path D/features \
        --boxes_path D/metadata --dataset_split D/dataset_split.json --save_path OUT --save_results
    python -m instance_nerf_tpu_torch.cli.run_rpn --mode profile --rotated_bbox --resolution 200
"""
from __future__ import annotations

import argparse
import json

from instance_nerf_tpu_torch.cli.common import report_eval, setup_logging


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
    p.add_argument("--checkpoint", default="", help="flax params tree as .npz")
    p.add_argument("--backbone_type", default="vgg_EF")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--normalize_density", action="store_true", default=True)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--grid", type=int, nargs=3, default=None, metavar=("W", "L", "H"),
                   help="benchmark/profile grid (default R R 13R/20)")
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--rpn_head_conv_depth", type=int, default=4)
    p.add_argument("--rpn_pre_nms_top_n", type=int, default=1000)
    p.add_argument("--rpn_post_nms_top_n", type=int, default=1000)
    p.add_argument("--rpn_nms_thresh", type=float, default=0.7)
    p.add_argument("--rpn_score_thresh", type=float, default=0.0)
    # eval export
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--output_proposals", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.7)
    p.add_argument("--output_voxel_scores", action="store_true")
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
        dtype=args.dtype,
        conv_depth=args.rpn_head_conv_depth,
        pre_nms_top_n=args.rpn_pre_nms_top_n,
        post_nms_top_n=args.rpn_post_nms_top_n,
        nms_thresh=args.rpn_nms_thresh,
        score_thresh=args.rpn_score_thresh,
        seed=args.seed,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args)
    if args.mode == "train":
        raise NotImplementedError("--mode train comes with slice 5 (detector training)")

    from instance_nerf_tpu_torch.train.rpn_trainer import RPNTrainer

    trainer = RPNTrainer(config_from_args(args), device=args.device)
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
