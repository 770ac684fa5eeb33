"""``wait_ms`` and ``wait_ms.<cells>``: host milliseconds a step in the program's
``wait`` spans (each place the host blocks on the card: an upload from host
memory, a read back, a synchronise), normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "wait")
