"""``encode_ms`` and ``encode_ms.<cells>``: host milliseconds a step in the program's
``encode`` span, normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "encode")
