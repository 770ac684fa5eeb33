"""FCOS NeRF-RPN CLI on PyTorch (the argparse surface of
``instance_nerf_tpu.cli.run_fcos``, plus ``--device``, ``--dtype``,
``--grid`` and ``--device_data``).

Modes: ``train`` (``FCOSTrainer.train_loop``: checkpoints under
``--save_path``, an eval of the val split every ``--eval_interval`` epochs;
prints the loop's summary as JSON), ``eval`` (recall / AP over a dataset;
``--save_results`` writes the proposals of each scene,
``--output_voxel_scores`` the per-voxel scores), ``check_arch``,
``benchmark`` (``predict_scene`` by CUDA events) and ``profile``
(``predict_scene`` split by stage and kernel). ``--checkpoint`` is a
checkpoint directory of the port or a flax params ``.npz``.

    python -m instance_nerf_tpu_torch.cli.run_fcos --mode train --features_path D/features \
        --boxes_path D/metadata --dataset_split D/dataset_split.json --save_path OUT
    python -m instance_nerf_tpu_torch.cli.run_fcos --mode train --backbone_type swin_s \
        --device_data --rot_scale_prob 0 --steps_per_call 4 --features_path D/features ...
    python -m instance_nerf_tpu_torch.cli.run_fcos --mode check_arch --device cpu --rotated_bbox
    python -m instance_nerf_tpu_torch.cli.run_fcos --mode eval --features_path D/features \
        --boxes_path D/metadata --dataset_split D/dataset_split.json --save_path OUT --save_results
    python -m instance_nerf_tpu_torch.cli.run_fcos --mode profile --rotated_bbox
    # data-parallel over 4 cards (each rank its rows of every batch; the
    # RPN and RCNN CLIs launch the same way); --device cpu trains over gloo
    python -m torch.distributed.run --nproc_per_node 4 -m instance_nerf_tpu_torch.cli.run_fcos \\
        --mode train --features_path D/features ... --save_path OUT
    # each scene's voxel W axis split over 2 ranks (the mesh's spatial axis,
    # ``parallel/spatial.py``), the batch over the other 2
    python -m torch.distributed.run --nproc_per_node 4 -m instance_nerf_tpu_torch.cli.run_fcos \\
        --mode train --n_spatial 2 --features_path D/features ... --save_path OUT
"""
from __future__ import annotations

import argparse
import json

from instance_nerf_tpu_torch.cli.common import finish, report_eval, setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_fcos")
    p.add_argument("--mode", default="train",
                   choices=["train", "eval", "benchmark", "check_arch", "profile"])
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--grid", type=int, nargs=3, default=None, metavar=("W", "L", "H"),
                   help="benchmark/profile grid (default R R R)")
    p.add_argument("--features_path", default="")
    p.add_argument("--boxes_path", default="")
    p.add_argument("--dataset_split", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory of the port, or a flax params tree as .npz")
    p.add_argument("--backbone_type", default="vgg_EF")
    p.add_argument("--input_dim", type=int, default=4)
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--normalize_density", action="store_true")
    # training
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg_loss_weight", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad_norm", type=float, default=0.1)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--log_to_file", action="store_true")
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--keep_checkpoints", type=int, default=1)
    p.add_argument("--rotate_prob", type=float, default=0.5)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--rot_scale_prob", type=float, default=0.5)
    p.add_argument("--num_convs", type=int, default=4)
    p.add_argument("--norm_reg_targets", action="store_true", default=True)
    p.add_argument("--centerness_on_reg", action="store_true", default=True)
    p.add_argument("--center_sampling_radius", type=float, default=1.5)
    p.add_argument("--iou_loss_type", default="iou",
                   choices=["iou", "linear_iou", "giou", "diou", "smooth_l1"])
    p.add_argument("--use_additional_l1_loss", action="store_true")
    p.add_argument("--proj2d_loss_weight", type=float, default=0.0)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps a dispatch (run one after another)")
    p.add_argument("--device_data", action="store_true",
                   help="hold the train split on the card; needs --rot_scale_prob 0")
    p.add_argument("--conv_at_start", action="store_true")
    # inference
    p.add_argument("--pre_nms_top_n", type=int, default=2500)
    p.add_argument("--fpn_post_nms_top_n", type=int, default=2500)
    p.add_argument("--nms_thresh", type=float, default=0.3)
    p.add_argument("--pre_nms_thresh", type=float, default=0.0)
    p.add_argument("--min_size", type=float, default=0.0)
    p.add_argument("--ap_top_n", type=int, default=None)
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--output_voxel_scores", action="store_true")
    p.add_argument("--filter", choices=["none", "tp", "fp"], default="none")
    p.add_argument("--filter_threshold", type=float, default=0.7)
    p.add_argument("--n_spatial", type=int, default=1,
                   help="ranks of torch.distributed.run that split each scene's W axis")
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args):
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig

    keys = FCOSConfig.__dataclass_fields__.keys()
    return FCOSConfig(**{k: v for k, v in vars(args).items() if k in keys})


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args)

    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSTrainer

    trainer = FCOSTrainer(config_from_args(args), device=args.device)
    if args.mode == "train":
        finish(trainer.train_loop())
        return
    trainer.init_state()
    if args.mode == "eval":
        ds = trainer.make_dataset("test" if args.dataset_split else "val")
        save = args.save_results or args.output_voxel_scores
        metrics = trainer.eval(
            ds, save_results_path=args.save_path if save else None,
            output_voxel_scores=args.output_voxel_scores, filter_mode=args.filter,
            filter_threshold=args.filter_threshold)
        report_eval(metrics, args.save_path)
        return
    shape = tuple(args.grid or (args.resolution,) * 3)
    if args.mode == "benchmark":
        print(json.dumps(trainer.benchmark(reps=10, shape=shape)))
    elif args.mode == "profile":
        print(json.dumps(trainer.profile(shape=shape)))
    else:
        print(json.dumps(trainer.check_arch(min(args.resolution, 64))))


if __name__ == "__main__":
    main()
