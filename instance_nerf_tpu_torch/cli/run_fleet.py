"""Fleet CLI: batched multi-scene instance-field training (PyTorch
counterpart of ``instance_nerf_tpu.cli.run_fleet``). A fleet of fields
advances in lock-step as one batched field (``train/multiscene.py``). Runs
on the card unless ``--device cpu`` is given; under ``torchrun`` the fleet
splits over the ranks' cards (gloo with ``--device cpu``).

Usage:
  # stage A: radiance fields for every scene under ROOT
  python -m instance_nerf_tpu_torch.cli.run_fleet --scenes 'ROOT/scene_*' \\
      --steps 20000 --save_path OUT [--pallas_grad]
  # stage B: instance fields from per-scene matched masks
  python -m ... --mode train_instance --masks_subdir masks_matched \\
      --checkpoint OUT --save_path OUT
  # aggregate rays/s, step ms, peak bytes, busy share, top kernels
  python -m ... --mode benchmark --steps 64
  # the fleet split over 4 cards
  python -m torch.distributed.run --nproc_per_node 4 -m instance_nerf_tpu_torch.cli.run_fleet \\
      --scenes 'ROOT/scene_*' --steps 20000 --save_path OUT --pallas_grad
"""
from __future__ import annotations

import argparse
import glob
import os

from instance_nerf_tpu_torch.cli.common import finish


def build_parser():
    p = argparse.ArgumentParser("run_fleet")
    p.add_argument("--mode", default="train", choices=["train", "train_instance", "benchmark"])
    p.add_argument("--scenes", nargs="+", default=[],
                   help="scene roots (each with transforms.json); globs are expanded")
    p.add_argument("--masks_subdir", default="",
                   help="per-scene matched-mask dir name for train_instance "
                        "(e.g. masks_matched)")
    p.add_argument("--save_path", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--n_rays", type=int, default=1024,
                   help="PER-SCENE ray batch (aggregate = B x n_rays)")
    p.add_argument("--n_samples", type=int, default=48)
    p.add_argument("--k_occupied", type=int, default=16)
    p.add_argument("--occ_res", type=int, default=64)
    p.add_argument("--occ_coarse_res", type=int, default=32)
    p.add_argument("--occ_subsample", type=float, default=0.25,
                   help="fraction of occupancy cells re-sampled per refresh")
    p.add_argument("--k_buckets", default="", help="adaptive-K ladder 'frac:K,frac:K,...'")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_instances", type=int, default=33)
    p.add_argument("--table_log2", type=int, default=15)
    p.add_argument("--n_levels", type=int, default=3)
    p.add_argument("--n_features", type=int, default=4)
    p.add_argument("--device_data", action="store_true", default=True,
                   help="keep uint8 images / int8 masks on the card "
                        "(MultiSceneFieldTrainer.fleet_data_bytes says what it takes)")
    p.add_argument("--host_data", dest="device_data", action="store_false")
    p.add_argument("--steps_per_call", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=0,
                   help="background-checkpoint cadence in steps (0 = only at the end)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pallas_grad", action="store_true",
                   help="the fleet's table gradient through the scatter-add kernel B3, "
                        "one launch a step for all scenes")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def load_scenes(args):
    from instance_nerf_tpu_torch.data.nerf_dataset import load_nerf_scene

    roots = []
    for pat in args.scenes:
        hits = sorted(glob.glob(pat))
        roots.extend(hits if hits else [pat])
    if not roots:
        raise SystemExit("run_fleet: no scenes matched --scenes")
    scenes = []
    for r in roots:
        masks_dir = os.path.join(r, args.masks_subdir) if args.masks_subdir else None
        scenes.append(load_nerf_scene(r, downscale=args.downscale, masks_dir=masks_dir))
    return roots, scenes


def make_config(args):
    from instance_nerf_tpu_torch.cli.run_instance_field import parse_k_buckets
    from instance_nerf_tpu_torch.train.ngp_trainer import fast_ngp_config

    return fast_ngp_config(
        n_rays=args.n_rays, n_samples=args.n_samples, k_occupied=args.k_occupied or None,
        occ_res=args.occ_res, occ_coarse_res=args.occ_coarse_res or None,
        occ_subsample=args.occ_subsample, k_buckets=parse_k_buckets(args.k_buckets),
        lr=args.lr, num_instances=args.num_instances, table_size=2 ** args.table_log2,
        n_levels=args.n_levels, n_features=args.n_features, ray_jitter=True,
        pallas_grad=args.pallas_grad)


def make_trainer(args, scenes):
    from instance_nerf_tpu_torch.train.multiscene import MultiSceneFieldTrainer

    return MultiSceneFieldTrainer(scenes, make_config(args), seed=args.seed,
                                  device_data=args.device_data, device=args.device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from instance_nerf_tpu_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise before loading
    roots, scenes = load_scenes(args)
    tr = make_trainer(args, scenes)
    if args.checkpoint:
        tr.restore(args.checkpoint)
    stage = "instance" if args.mode == "train_instance" else "rgb"
    if args.mode == "benchmark":
        spc = args.steps_per_call or 32
        if tr.device.type == "cuda":
            out = tr.benchmark(args.steps, steps_per_call=spc)
            prof = tr.profile(reps=5, warmup=2)
            out.update(busy_share=prof["device_busy_share"],
                       stages_ms=prof["stages_ms_median"], top_kernels=prof["top_kernels"],
                       profiled_step_ms=prof["wall_ms_median"])
        else:  # the host clock: a run of the mode, not a device figure
            import time

            tr.train(spc, stage="rgb", log_every=0, steps_per_call=spc)
            t0 = time.perf_counter()
            tr.train(args.steps, stage="rgb", log_every=0, steps_per_call=spc)
            dt = time.perf_counter() - t0
            out = {"B": len(scenes), "n_rays": args.n_rays,
                   "aggregate_rays_per_s": len(scenes) * args.n_rays * args.steps / dt,
                   "step_ms": dt / args.steps * 1e3, "clock": "host"}
        finish(out)
        return out
    done = 0
    chunk = args.save_every or args.steps
    metrics = {}
    while done < args.steps:
        k = min(chunk, args.steps - done)
        metrics = tr.train(k, stage=stage, log_every=args.log_every,
                           steps_per_call=args.steps_per_call or None)
        done += k
        if args.save_path:
            tr.save(args.save_path, step=done, metrics=metrics, background=done < args.steps)
    tr.wait_for_save()
    out = {"scenes": len(scenes), "steps": args.steps, "stage": stage, **metrics}
    finish(out)
    return out


if __name__ == "__main__":
    main()
