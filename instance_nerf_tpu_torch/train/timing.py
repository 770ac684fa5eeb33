"""Stage spans and timing on the card, shared by the port's trainers.

``Stages`` opens a ``torch.profiler`` range ``<prefix>.<name>`` around each
stage of an inference path or a training step while a profiler collects,
and CUDA events while ``profile_ms`` times the stages; otherwise a span
costs one check of torch's profiler flag. Where the host blocks on the
card (a copy from host memory, ``.cpu()``, ``.item()``, ``float()`` of a
card tensor, a synchronise, one inside an operation's backward) the path
opens a ``wait`` span inside the stage it sits in; ``Stages.upload`` is the
uploads' ``torch.as_tensor``, ``Stages.read_back`` their ``float``, and
``Stages.wait_in_backward`` marks a backward.
``benchmark_ms`` and ``profile_ms`` time a zero-argument callable that
runs the path once; ``benchmark_train_steps`` adds a train step's model
FLOPs and MFU.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from instance_nerf_tpu_torch.utils.hbm import GIB, step_stats


_NO_SPAN = contextlib.nullcontext()


class Stages:
    """Named spans of an inference path or a training step: call it with a
    stage name to get a context manager. ``prefix`` None opens no span
    (``NO_STAGES``, the default of the paths that take one)."""

    def __init__(self, prefix: str | None):
        self.prefix = prefix
        # name -> [(start, end) CUDA events], filled while a profile runs
        self.events = None

    def __call__(self, name: str):
        traced = self.prefix is not None and torch.autograd._profiler_enabled()
        if not traced and self.events is None:
            return _NO_SPAN
        return self._span(name, traced)

    @contextlib.contextmanager
    def _span(self, name: str, traced: bool):
        with record_function(f"{self.prefix}.{name}") if traced else _NO_SPAN:
            if self.events is None:
                yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def upload(self, x, device, dtype=None) -> torch.Tensor:
        """``torch.as_tensor(x, dtype=dtype, device=device)``, inside a
        ``wait`` span where ``x`` is not a tensor on a device of that type
        already: a copy from pageable host memory to the card synchronises
        the stream, so the host waits for every queued kernel."""
        if torch.is_tensor(x) and x.device.type == torch.device(device).type:
            return torch.as_tensor(x, dtype=dtype, device=device)
        with self("wait"):
            return torch.as_tensor(x, dtype=dtype, device=device)

    def read_back(self, values: dict) -> dict:
        """``{name: float(tensor)}`` inside a ``wait`` span: reading a card
        tensor waits for every queued kernel."""
        with self("wait"):
            return {k: float(v) for k, v in values.items()}

    def wait_in_backward(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, with a ``wait`` span around the backward of the operation
        that made it (autograd's node, which runs on the backward's
        thread), for an operation whose backward reads from the card. Hooks
        are set only while a span would open: a tensor without gradient, or
        a step with neither profiler nor ``profile_ms`` running, is left
        as it is."""
        traced = self.prefix is not None and torch.autograd._profiler_enabled()
        node = t.grad_fn
        if node is None or not traced and self.events is None:
            return t
        opened = []

        def enter(grad_outputs):
            span = self._span("wait", traced)
            span.__enter__()
            opened.append(span)

        def leave(grad_inputs, grad_outputs):
            opened.pop().__exit__(None, None, None)

        node.register_prehook(enter)
        node.register_hook(leave)
        return t


NO_STAGES = Stages(None)


def busy_ms(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals (ms in, ms
    out): the time some operation ran, counting overlapping streams
    once."""
    busy, cur = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    return busy


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


def benchmark_train_steps(step, device, batch: int, reps=18, warmup=3) -> dict:
    """``benchmark_steps`` of a train step, then the JAX trainers' model
    keys: one more step runs under the FLOP counter
    (``utils/hbm.py:step_stats``), which gives ``flops_per_step``,
    ``tflops_per_step``, ``achieved_tflops`` and ``mfu`` at the median step
    time; ``peak_hbm_gib`` is the timed steps' peak device memory."""
    out = benchmark_steps(step, device, batch, reps=reps, warmup=warmup)
    out.update(step_stats(step, step_ms=out["median_ms"]))
    out["peak_hbm_gib"] = out["peak_mem_bytes"] / GIB
    return out


def profile_ms(run, device, stages: Stages, reps=5, warmup=2, top=12,
               watch=("nms_sweep",)) -> dict:
    """Where ``run()``'s time goes, in ms per run: each stage's spans on the
    device (CUDA events, no profiler attached), then ``torch.profiler`` over
    ``reps`` more runs for the device time of the top kernels, the launch
    count and the device's busy share of the unprofiled wall time (the
    union of the device's operations, so that streams which overlap count
    once).
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

    own = f"{stages.prefix}."  # the device-side copies of the stage ranges
    kernels = sorted(((self_dev_ms(e), e.key, e.count // reps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(own)), reverse=True)
    device_ms = busy_ms([(e.time_range.start / 1e3, e.time_range.end / 1e3)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith(own)]) / reps
    wall_ms = float(np.median(walls))
    return {
        "wall_ms_median": wall_ms,
        "stages_ms_median": spans,
        "device_kernel_ms_per_run": sum(k[0] for k in kernels),
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_run": sum(k[2] for k in kernels),
        **{f"{w}_ms": sum(ms for ms, n, _ in kernels if w in n) for w in watch},
        "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for ms, n, c in kernels[:top]],
        "device": torch.cuda.get_device_name(device),
    }
