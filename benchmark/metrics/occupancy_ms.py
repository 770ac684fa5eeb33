"""``occupancy_ms`` and ``occupancy_ms.<cells>``: host milliseconds a step in the
program's ``occupancy`` span (the samples along each ray and their occupancy
lookups), normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "occupancy")
