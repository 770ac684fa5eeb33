"""``draw_ms`` and ``draw_ms.<cells>``: host milliseconds a step in the program's
``draw`` span (the host's numpy ray draws), normalised by the steps the trace
holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "draw")
