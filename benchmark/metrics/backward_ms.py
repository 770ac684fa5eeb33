"""``backward_ms`` and ``backward_ms.<cells>``: host milliseconds a step in the program's
``backward`` span, normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "backward")
