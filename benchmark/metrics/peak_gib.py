"""``peak_gib.<cells>``: the allocator's peak over the window, GiB."""
from benchmark.harness.readers import window_peak_gib


def read(run):
    return window_peak_gib(run)
