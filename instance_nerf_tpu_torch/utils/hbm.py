"""Peak device memory and model FLOPs of a step (PyTorch counterpart of
``instance_nerf_tpu.utils.hbm``).

The JAX module asks XLA's compiler for a program's peak HBM before it runs.
PyTorch has no compiled program to ask: ``memory_stats`` runs the call once
and reads the caching allocator's counters (``reset_peak_memory_stats``,
``max_memory_allocated``), so it needs the card and raises without one.
``step_stats`` counts a step's FLOPs with ``utils.flops.count_flops`` and,
given the step's time, its achieved rate and MFU against the H100's peak.
"""
from __future__ import annotations

import torch

from instance_nerf_tpu_torch.utils.flops import count_flops

# NVIDIA H100 SXM5 data sheet: dense BF16 tensor-core peak (without
# sparsity) at the 700 W power limit. MFU is reported against it whatever the
# program's dtype mix, as the JAX module reports against its chip's bf16 peak.
H100_SXM_PEAK_BF16_FLOPS = 989e12

GIB = 1024.0 ** 3


def memory_stats(fn, *args, device=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once on the card and report its device
    memory in bytes: ``arguments`` (allocated when the call starts: its
    inputs and whatever else is live), ``output`` (what the call left
    allocated beyond that; negative where it freed more than it kept),
    ``temp`` (its peak above what it left), ``peak_hbm`` (the allocator's
    peak during the call, ``arguments + output + temp``), and each in GiB."""
    if not torch.cuda.is_available():
        raise RuntimeError("memory_stats reads the card's allocator: no CUDA device is available")
    dev = torch.device("cuda" if device is None else device)
    torch.cuda.synchronize(dev)
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    end = torch.cuda.memory_allocated(dev)
    stats = {"arguments": start, "output": end - start, "temp": peak - end, "peak_hbm": peak}
    stats.update({f"{k}_gib": v / GIB for k, v in list(stats.items())})
    return stats


def step_stats(step, *args, steps_per_call: int = 1, step_ms: float | None = None,
               **kwargs) -> dict:
    """Model FLOPs of ``step(*args, **kwargs)`` (which runs once: a train
    step advances its state) divided by the ``steps_per_call`` steps it
    takes: ``flops_per_step``, ``tflops_per_step`` and, given ``step_ms``,
    ``achieved_tflops`` and ``mfu`` against ``H100_SXM_PEAK_BF16_FLOPS``."""
    flops = count_flops(step, *args, **kwargs) / max(steps_per_call, 1)
    stats = {"flops_per_step": flops, "tflops_per_step": flops / 1e12}
    if step_ms and flops:
        achieved = flops / (step_ms / 1e3)
        stats["achieved_tflops"] = achieved / 1e12
        stats["mfu"] = achieved / H100_SXM_PEAK_BF16_FLOPS
    return stats
