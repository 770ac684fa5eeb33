"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers take.

The reduction reads the profiler's raw events (``kineto_results.events()``),
not ``key_averages``: a window holds about a million of them. From them:

* ``spans``: each named host range (the program's ``Stages`` ranges such as
  ``field.encode``, and the harness's own ``bench.*``), its total seconds on
  the host and how many the trace holds;
* ``kernels``: device time and count by device operation (kernels, copies,
  fills; the device-side copies of host ranges are left out), and
  ``device_ops``, each of them ``(start ns, end ns, name, stream)`` in time
  order;
* ``busy_s``: the union of device activity inside the window, so that
  overlapping streams count once;
* ``idle_gaps``: the device's idle time inside the window, summed by the
  innermost host span open at the middle of each gap (what the host was
  doing while the device waited).
"""
from __future__ import annotations

from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"


def profiler():
    """The host and, where there is a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def reduce_events(events, span_prefixes) -> dict:
    """The reduction above from a list of kineto events. ``span_prefixes``
    names the host ranges that are spans (``("field.", "bench.")``)."""
    spans = defaultdict(lambda: [0.0, 0])
    marks = []  # (start, end, name) of span ranges
    window = None
    host_names = set()
    device = []
    for e in events:
        name = e.name()
        if not _is_device(e):
            host_names.add(name)
            if name.startswith(span_prefixes):
                s, d = e.start_ns(), e.duration_ns()
                spans[name][0] += d * 1e-9
                spans[name][1] += 1
                marks.append((s, s + d, name))
                if name == WINDOW_SPAN:
                    window = (s, s + d)
            continue
        device.append(e)
    kernels = defaultdict(lambda: [0.0, 0])
    intervals, ops = [], []
    for e in device:
        name = e.name()
        if e.is_user_annotation() or name in host_names:
            continue  # a host range's device-side copy
        s, d = e.start_ns(), e.duration_ns()
        kernels[name][0] += d * 1e-9
        kernels[name][1] += 1
        intervals.append((s, s + d))
        ops.append((s, s + d, name, e.device_resource_id()))
    out = {"spans": {k: tuple(v) for k, v in spans.items()},
           "kernels": {k: tuple(v) for k, v in kernels.items()},
           "device_ops": sorted(ops),
           "window_s": None, "busy_s": None, "idle_gaps": []}
    if window is None:
        return out
    w0, w1 = window
    busy, gaps = _union(intervals, w0, w1)
    out["window_s"] = (w1 - w0) * 1e-9
    out["busy_s"] = busy * 1e-9
    out["idle_gaps"] = _label_gaps(gaps, marks)
    return out


def _union(intervals, w0, w1):
    """Length of the union of ``intervals`` clipped to [w0, w1], and the
    gaps between them inside it."""
    busy, gaps, cur = 0, [], w0
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += e - s
        else:
            busy += e - cur
        cur = e
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def _label_gaps(gaps, marks) -> list:
    """Idle seconds by the innermost span open at each gap's middle,
    largest first (``[[name, seconds], ...]``). Spans nest, so the innermost
    open one is the latest started."""
    marks = sorted(marks)
    by = defaultdict(float)
    active, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(marks) and marks[i][0] <= mid:
            active.append(marks[i])
            i += 1
        active = [m for m in active if m[1] > mid]
        name = max(active)[2] if active else "outside spans"
        by[name] += (g1 - g0) * 1e-9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])


def reduce_profile(prof, span_prefixes) -> dict:
    return reduce_events(prof.profiler.kineto_results.events(), span_prefixes)
