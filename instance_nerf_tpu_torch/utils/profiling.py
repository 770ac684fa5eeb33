"""Profiling and timing harness (PyTorch counterpart of
``instance_nerf_tpu.utils.profiling``): a ``torch.profiler`` trace written
to a directory, the latency of a chained step, and a step timer usable from
any loop.

The JAX module chains each step on the previous one's scalar because its
device calls could not be waited for one by one. Here a chain of calls is
timed on the host clock up to reading its final scalar, which waits for the
device: a ``synchronize`` on the card.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from instance_nerf_tpu_torch import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(logdir): ...`` -> a Chrome trace ``<logdir>/trace.json``
    of the host and, where there is a card, its device activity (viewable in
    Perfetto or ``chrome://tracing``). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _chain_time_ms(f, args, reps: int, warmup: int, device) -> float:
    c = torch.zeros((), device=device)
    for _ in range(warmup):
        c = f(c, *args)
    float(c)
    t0 = time.perf_counter()
    c = torch.zeros((), device=device)
    for _ in range(reps):
        c = f(c, *args)
    float(c)
    return (time.perf_counter() - t0) / reps * 1000.0


def dispatch_overhead_ms(reps: int = 50, device="cuda") -> float:
    """Per-call time of a trivial chained op (``c + 1 - 1``) on ``device``:
    launch overhead, the floor of any chained step."""
    return _chain_time_ms(lambda c: c + 1.0 - 1.0, (), reps, 2, resolve_device(device))


def chained_latency_ms(step, args=(), reps: int = 20, warmup: int = 2,
                       subtract_overhead: bool = True, device="cuda") -> float:
    """Latency of ``step(c, *args) -> c'``, each call taking the previous
    call's 0-d tensor, over ``reps`` calls after ``warmup``; with
    ``subtract_overhead`` less ``dispatch_overhead_ms`` (at least 1 us)."""
    dev = resolve_device(device)
    total = _chain_time_ms(step, args, reps, warmup, dev)
    if subtract_overhead:
        total = max(total - dispatch_overhead_ms(device=dev), 1e-3)
    return total


class StepTimer:
    """Host-clock step timing with the warm-up steps discarded (the
    reference's benchmark-mode semantics). Time work that ends by waiting
    for the device."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        arr = np.asarray(self.times) * 1000
        return {
            "mean_ms": float(arr.mean()) if arr.size else 0.0,
            "std_ms": float(arr.std()) if arr.size else 0.0,
            "n": int(arr.size),
        }
