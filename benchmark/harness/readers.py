"""What the per-metric readers share. A reader is ``read(run) -> float or
None``; ``run`` is the record of one run that ``run.py:run`` builds. A reader
that finds nothing to read returns None, and the harness leaves its metric
out of the line."""
from __future__ import annotations

from benchmark.counts import peaks
from benchmark.counts.scatter_add import bound_s, field_launch

# the program's span that opens once a training step: the traced run
# counts its steps by it
STEP_SPAN = "adam"


def steps_seen(run):
    if run.trace is None:
        return None
    return run.trace["spans"].get(f"{run.prefix}.{STEP_SPAN}", (0.0, 0))[1] or None


def span_ms_per_step(run, stage: str):
    """The host milliseconds a step of the program's span
    ``<prefix>.<stage>``, normalised by the steps the trace holds."""
    seen = steps_seen(run)
    span = run.trace["spans"].get(f"{run.prefix}.{stage}") if run.trace else None
    if not seen or not span:
        return None
    return span[0] * 1e3 / seen


def launch_time(run, names, preceded_by: str = "Memset"):
    """(device seconds, launches) of the kernels whose names contain any of
    ``names``, each with the operation just before it on its stream where
    that one's name starts with ``preceded_by`` (a wrapper that zeroes its
    output on the stream before its kernel); None where the trace has none."""
    if run.trace is None:
        return None
    last, t, n = {}, 0.0, 0
    for s, e, name, stream in run.trace["device_ops"]:
        if any(x in name for x in names):
            t += (e - s) * 1e-9
            n += 1
            prev = last.get(stream)
            if prev is not None and prev[2].startswith(preceded_by):
                t += (prev[1] - prev[0]) * 1e-9
        last[stream] = (s, e, name)
    return (t, n) if n else None


def rays_per_s(run):
    """Rays trained in the window's calls over the window's seconds on the
    host clock. The window runs whole calls until one ends past
    ``--seconds`` and closes at the end of that call, so every ray counted
    was trained inside it; it holds the ray draws, the occupancy refreshes
    and every host sync the calls make."""
    return run.work / run.window_s if run.work_unit == "rays" else None


def scatter_add_roofline(run, names):
    """Kernel B3's share of its roofline, in %: its least time by the
    frozen byte count (``counts/scatter_add.py``) times its launches, over
    its device time in the traced window. A launch's time is its kernel's
    (matched by ``names``) and that of the memset that zeroes the table just
    before it on the stream (``csrc/scatter_add.cu:scatter_add_launch``):
    the bound counts the table written once."""
    got = launch_time(run, names)
    if got is None:
        return None
    seconds, launches = got
    return 100.0 * launches * bound_s(*field_launch(run.config)) / seconds


def mfu(run):
    """The window's model FLOPs (the frozen JAX rule, ``counts/flops.py``,
    counted over the set-up's first call) over the traced window's seconds
    times the H100's dense bf16 peak, in %; the line carries the card's
    power limit beside it."""
    if run.trace is None or not run.flops_per_call:
        return None
    return 100.0 * run.flops_per_call * run.calls / (run.window_s * peaks.BF16_FLOPS)


def idle_share(run):
    """The share of the traced window in which no operation ran on the
    device, in %: one minus the union of its activity intervals over the
    window."""
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def peak_gib(run):
    """The allocator's peak over the whole run, set-up and window (the
    fullest card's ``max_memory_allocated``; what ``device`` prints as
    ``memory_peak_bytes``), GiB: the card memory a user must have free."""
    return run.peak_bytes / 2 ** 30


def window_peak_gib(run):
    """The allocator's peak over the window (``max_memory_allocated`` after
    a reset at its start), GiB."""
    return run.window_peak_bytes / 2 ** 30
