"""Time the gradient all-reduce of a data-parallel FCOS step at several
bucket sizes, over the ranks of ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m instance_nerf_tpu_torch.parallel.allreduce_bench [--reps 20]

The gradients are the trained parameters' of ``FCOSTrainer(FCOSConfig())``
(VGG-EF, the JAX defaults), filled with ones. For each bucket size,
``all_reduce_sum`` of them (the flatten, the NCCL calls and the copies
back) is timed on the host clock around synchronized calls, the median of
``--reps`` after two warm-ups, the slowest rank's; and once one all-reduce
of a flat buffer of the same size, with its bus bandwidth (2 (n - 1) / n of
the bytes over the time, as NCCL's own tests count it). Rank 0 prints one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from instance_nerf_tpu_torch.parallel.mesh import BUCKET_NUMEL, all_reduce_sum, buckets, make_mesh

BUCKETS = (2 ** 20, 2 ** 22, BUCKET_NUMEL, 2 ** 24, 2 ** 25, 2 ** 27)


def _median_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """The slowest rank's median ms of ``fn``."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    for i in range(warmup + reps):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    t = torch.tensor([float(np.median(times))], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def main(argv=None) -> dict:
    from instance_nerf_tpu_torch.train.fcos_trainer import FCOSConfig, FCOSTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = make_mesh(device=args.device)
    tr = FCOSTrainer(FCOSConfig(), device=args.device, mesh=mesh)
    tr.init_state()
    grads = [torch.ones_like(p) for p in tr.state.tx.params]
    del tr
    numel = sum(g.numel() for g in grads)
    out = {"world": mesh.world, "backend": dist.get_backend(), "tensors": len(grads),
           "gradient_bytes": 4 * numel, "buckets": []}
    for limit in BUCKETS:
        ms = _median_ms(lambda: all_reduce_sum(grads, bucket_numel=limit), mesh.device,
                        args.reps)
        out["buckets"].append({"bucket_numel": limit, "is_default": limit == BUCKET_NUMEL,
                               "calls": len(buckets([g.numel() for g in grads], limit)),
                               "ms": ms})
    flat = torch.ones(numel, device=mesh.device)
    ms = _median_ms(lambda: dist.all_reduce(flat), mesh.device, args.reps)
    n = mesh.world
    out["flat"] = {"ms": ms, "bus_gb_per_s": 2 * (n - 1) / n * 4 * numel / ms / 1e6}
    if mesh.device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(mesh.device)
        smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        out["nvidia_smi"] = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
        out["topology"] = topo.stdout.strip() or topo.stderr.strip()
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
