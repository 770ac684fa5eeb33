"""Instance-field CLI (PyTorch counterpart of
``instance_nerf_tpu.cli.run_instance_field``): per-scene NeRF training,
instance-field training from matched 2D masks, novel-view rgb / instance
rendering, regular-grid RGBσ extraction for the detectors, and a train-step
benchmark. Runs on the card unless ``--device cpu`` is given.

Usage:
  # stage A: radiance field
  python -m instance_nerf_tpu_torch.cli.run_instance_field --scene S --mode train \\
      --steps 20000 --save_path OUT [--pallas_grad]
  # stage B: instance field from matched masks
  python -m ... --mode train_instance --masks_dir S/masks_matched \\
      --checkpoint OUT --save_path OUT
  # render novel views / extract detector features / time a step
  python -m ... --mode render --checkpoint OUT --save_path OUT/renders
  python -m ... --mode extract_features --checkpoint OUT \\
      --resolution 160 --out_features features/scene.npz
  python -m ... --mode benchmark [--preset tpu_fast]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("run_instance_field")
    p.add_argument("--mode", default="train",
                   choices=["train", "train_instance", "render", "extract_features",
                            "benchmark"])
    p.add_argument("--scene", default="", help="scene root with transforms.json")
    p.add_argument("--transforms", default="transforms.json")
    p.add_argument("--masks_dir", default="", help="matched 2D instance masks (.npy per view)")
    p.add_argument("--save_path", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--n_rays", type=int, default=4096)
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--k_occupied", type=int, default=32,
                   help="fixed-K occupancy compaction (0 = query all samples)")
    p.add_argument("--k_buckets", default="",
                   help="adaptive-K routing, 'frac:K,frac:K,...' e.g. "
                        "'0.5:8,0.25:16,0.25:32': rays sorted by occupancy hits, the "
                        "emptiest fraction gets the smallest K; or 'auto' to choose the "
                        "fractions from the measured per-ray hit histogram after a short "
                        "warm-up (models/render.py:choose_k_buckets)")
    p.add_argument("--occ_coarse_res", type=int, default=0,
                   help="two-stage occupancy: coarse selection at this res + fine mask on "
                        "the K compacted samples (0 = single-stage)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--preset", default="", choices=["", "tpu_fast"],
                   help="tpu_fast: the quality-validated recipe of the JAX package: packed "
                        "T=2^15 tables, 2 levels x 6 features, coarse occupancy, adaptive-K "
                        "buckets 0.625:2/0.25:4/0.125:8 over 32 stratified candidates, "
                        "12288 rays/step. Flags typed on the command line still win.")
    p.add_argument("--encoding", default="hash", choices=["hash", "fast"],
                   help="'hash' = shared-corner NGP encoding; 'fast' = brick encoding "
                        "(models/fast_encode.py)")
    p.add_argument("--n_levels", type=int, default=16)
    p.add_argument("--log2_table_size", type=int, default=19)
    p.add_argument("--max_res", type=int, default=1024)
    p.add_argument("--num_instances", type=int, default=33)
    p.add_argument("--occ_res", type=int, default=128)
    p.add_argument("--resolution", type=int, default=160,
                   help="feature-grid resolution for extract_features")
    p.add_argument("--out_features", default="")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--steps_per_call", type=int, default=0,
                   help="steps per training call (0 = the occupancy cadence)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pallas_grad", action="store_true",
                   help="table gradient through the scatter-add kernel B3 (the JAX "
                        "config's pallas_grad field)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def parse_with_provenance(argv=None):
    """Parse argv and record which flags the user typed
    (``args.provided_flags``), so that a preset fills every other flag, even
    one typed at its default value."""
    args = build_parser().parse_args(argv)
    sentinel = build_parser()
    for action in sentinel._actions:
        action.default = argparse.SUPPRESS
    args.provided_flags = sorted(vars(sentinel.parse_args(argv)))
    return args


PRESETS = {
    "tpu_fast": dict(encoding="fast", n_rays=12288, n_samples=32, k_occupied=16,
                     occ_coarse_res=32, k_buckets="0.625:2,0.25:4,0.125:8"),
}
# the ladder an 'auto' run starts on before it measures its own
AUTO_START_LADDER = ((0.625, 2), (0.25, 4), (0.125, 8))


def parse_k_buckets(text: str):
    if not text:
        return None
    return tuple((float(f), int(k)) for f, k in (pair.split(":") for pair in text.split(",")))


def make_config(args):
    """The ``NGPConfig`` of ``args``, the preset applied to every flag the
    user did not type (without provenance, to every flag at its default)."""
    from instance_nerf_tpu_torch.train.ngp_trainer import NGPConfig, fast_ngp_config

    if args.preset:
        parser = build_parser()
        provided = set(getattr(args, "provided_flags", ()))
        for flag, val in PRESETS[args.preset].items():
            user_set = (flag in provided if provided
                        else getattr(args, flag) != parser.get_default(flag))
            if not user_set:
                setattr(args, flag, val)
    k_buckets = AUTO_START_LADDER if args.k_buckets == "auto" else parse_k_buckets(
        args.k_buckets)
    common = dict(max_res=args.max_res, num_instances=args.num_instances, n_rays=args.n_rays,
                  n_samples=args.n_samples, lr=args.lr, occ_res=args.occ_res,
                  k_occupied=args.k_occupied or None,
                  occ_coarse_res=args.occ_coarse_res or None, k_buckets=k_buckets,
                  pallas_grad=args.pallas_grad)
    if args.encoding == "fast":
        if args.preset == "tpu_fast":
            # packed tables, per-ray stratified jitter
            return fast_ngp_config(table_size=2 ** 15, n_levels=2, n_features=6,
                                   ray_jitter=True, **common)
        return fast_ngp_config(**common)
    return NGPConfig(n_levels=args.n_levels, table_size=2 ** args.log2_table_size, **common)


def make_trainer(args):
    from instance_nerf_tpu_torch.train.ngp_trainer import InstanceFieldTrainer

    return InstanceFieldTrainer(make_config(args), seed=args.seed, device=args.device)


def _config_json(args) -> dict:
    return {k: v for k, v in vars(args).items() if k != "provided_flags"}


def save_state(trainer, path, args, metrics=None) -> None:
    """The field's params and occupancy grid, the CLI's flags embedded."""
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    state = {"params": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
             "occ_grid": trainer.occ.grid.detach().cpu()}
    CheckpointManager(path, keep=2).save(0, state, config=_config_json(args),
                                         metrics=metrics or {})


def load_state(trainer, path) -> dict:
    from instance_nerf_tpu_torch.models.render import OccupancyGrid
    from instance_nerf_tpu_torch.train.checkpoints import CheckpointManager

    tmpl = {"params": trainer.model.state_dict(), "occ_grid": trainer.occ.grid}
    state, meta = CheckpointManager(path).restore(tmpl, map_location="cpu")
    trainer.model.load_state_dict(state["params"], strict=True)
    trainer.occ = OccupancyGrid(state["occ_grid"].to(trainer.device), trainer.occ.threshold)
    return meta


def host_benchmark(trainer, reps: int = 5, stage: str = "instance") -> dict:
    """Step time on the host clock, for a run on the CPU (the card's figures
    come from ``benchmark_train``); the trainer's state is restored."""
    o, d, rgb, inst, _ = trainer._synthetic_rays(0)
    with trainer._restored():
        trainer.train_step(stage, o, d, rgb, inst)
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(stage, o, d, rgb, inst)
        step_s = (time.perf_counter() - t0) / reps
    return {"step_ms": step_s * 1e3, "rays_per_s": trainer.cfg.n_rays / step_s,
            "clock": "host"}


def main(argv=None):
    args = parse_with_provenance(argv)
    from instance_nerf_tpu_torch.data.nerf_dataset import load_nerf_scene

    trainer = make_trainer(args)
    if args.checkpoint:
        load_state(trainer, args.checkpoint)

    if args.mode in ("train", "train_instance"):
        scene = load_nerf_scene(args.scene, args.transforms, masks_dir=args.masks_dir or None,
                                downscale=args.downscale)
        stage = "rgb" if args.mode == "train" else "instance"
        steps = args.steps
        spc = args.steps_per_call or None
        extra = {}
        if args.k_buckets == "auto" and stage == "rgb":
            from instance_nerf_tpu_torch.models.render import choose_k_buckets

            warm = min(160, steps // 4)
            if warm:
                trainer.train(scene, warm, stage="rgb", log_every=0, steps_per_call=spc)
            ladder = choose_k_buckets(trainer.measure_hits(scene))
            trainer.set_sampling(k_buckets=ladder)
            steps -= warm
            extra["k_buckets_auto"] = ",".join(f"{f}:{k}" for f, k in ladder)
        metrics = trainer.train(scene, steps, stage=stage, log_every=args.log_every,
                                steps_per_call=spc)
        metrics.update(extra)
        print(json.dumps(metrics))
        if args.save_path:
            save_state(trainer, args.save_path, args, metrics)
        return metrics

    elif args.mode == "render":
        from instance_nerf_tpu_torch.data.png import write_png

        scene = load_nerf_scene(args.scene, args.transforms, downscale=args.downscale)
        os.makedirs(args.save_path, exist_ok=True)
        for v in range(scene.num_views):
            out = trainer.render_image(scene.poses[v], scene.intrinsics, scene.hw)
            write_png(os.path.join(args.save_path, f"rgb_{v:03d}.png"),
                      (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
            np.save(os.path.join(args.save_path, f"instance_{v:03d}.npy"), out["instance"])
        out = {"rendered": scene.num_views, "out": args.save_path}
        print(json.dumps(out))
        return out

    elif args.mode == "benchmark":
        if trainer.device.type == "cuda":
            r = trainer.benchmark_train(reps=20, stage="instance")
        else:
            r = host_benchmark(trainer)
        out = {"encoding": args.encoding, "rays_per_s": round(r["rays_per_s"]),
               "step_ms": round(r["step_ms"], 2), "n_rays": trainer.cfg.n_rays,
               "k_occupied": trainer.cfg.k_occupied, "peak_mem_bytes": r.get("peak_mem_bytes"),
               "clock": r.get("clock", "cuda_events")}
        print(json.dumps(out))
        return out

    elif args.mode == "extract_features":
        grid = trainer.extract_rgbsigma(args.resolution)
        out = args.out_features or os.path.join(args.save_path, "features.npz")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(out, rgbsigma=grid.astype(np.float32),
                            resolution=np.asarray(grid.shape[:3]))
        res = {"features": out, "shape": list(grid.shape)}
        print(json.dumps(res))
        return res


if __name__ == "__main__":
    main()
