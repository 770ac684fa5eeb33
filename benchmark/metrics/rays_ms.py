"""``rays_ms`` and ``rays_ms.<cells>``: host milliseconds a step in the program's
``rays`` span, normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "rays")
