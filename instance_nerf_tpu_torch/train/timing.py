"""Stage spans and timing on the card, shared by the port's trainers.

``Stages`` opens a ``torch.profiler`` range ``<prefix>.<name>`` around each
stage of an inference path or a training step and, while a profile
collects, CUDA events too.
``benchmark_ms`` and ``profile_ms`` time a zero-argument callable that
runs the path once.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function


class Stages:
    """Named spans of an inference path: call it with a stage name to get a
    context manager."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        # name -> [(start, end) CUDA events], filled while a profile runs
        self.events = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        with record_function(f"{self.prefix}.{name}"):
            if self.events is None:
                yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))


def _timed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def benchmark_ms(run, device, reps=10, warmup=2) -> dict:
    """``run()`` timed with CUDA events: median, mean and min ms over
    ``reps`` warmed runs, the warm-up seconds' host time and peak device
    memory of the timed runs."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        run()
    torch.cuda.synchronize(device)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    times = [_timed_ms(run) for _ in range(reps)]
    return {
        "median_ms": float(np.median(times)),
        "mean_ms": float(np.mean(times)),
        "min_ms": float(np.min(times)),
        "reps": reps,
        "warmup_s": warm_s,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated(device)),
        "device": torch.cuda.get_device_name(device),
    }


def benchmark_steps(step, device, batch: int, reps=18, warmup=3) -> dict:
    """``benchmark_ms`` of ``step()``, one train step returning its metrics,
    with the scenes per second of a ``batch``-scene step and the losses of
    every step run (warm-up first)."""
    seen = []
    out = benchmark_ms(lambda: seen.append(step()), device, reps=reps, warmup=warmup)
    out["scenes_per_s"] = batch / out["median_ms"] * 1e3
    out["losses"] = [{k: float(v) for k, v in m.items()} for m in seen]
    return out


def profile_ms(run, device, stages: Stages, reps=5, warmup=2, top=12,
               watch=("nms_sweep",)) -> dict:
    """Where ``run()``'s time goes, in ms per run: each stage's spans on the
    device (CUDA events, no profiler attached), then ``torch.profiler`` over
    ``reps`` more runs for the device time of the top kernels, the launch
    count and the device's busy share of the unprofiled wall time.
    ``<name>_ms`` sums the device time of the kernels whose names contain
    each ``watch`` entry."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        run()
    torch.cuda.synchronize(device)
    stages.events = {}
    try:
        walls = [_timed_ms(run) for _ in range(reps)]
        # a stage may open several spans per run: sum them within each run
        spans = {k: float(np.median(np.reshape([s.elapsed_time(e) for s, e in v],
                                                (reps, -1)).sum(1)))
                 for k, v in stages.events.items()}
    finally:
        stages.events = None
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize(device)

    def self_dev_ms(e):  # the attribute was cuda_* before torch 2.4
        t = getattr(e, "self_device_time_total", None)
        return (t if t is not None else e.self_cuda_time_total) / 1e3 / reps

    kernels = sorted(((self_dev_ms(e), e.key, e.count // reps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(f"{stages.prefix}.")), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    wall_ms = float(np.median(walls))
    return {
        "wall_ms_median": wall_ms,
        "stages_ms_median": spans,
        "device_kernel_ms_per_run": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_run": sum(k[2] for k in kernels),
        **{f"{w}_ms": sum(ms for ms, n, _ in kernels if w in n) for w in watch},
        "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for ms, n, c in kernels[:top]],
        "device": torch.cuda.get_device_name(device),
    }
