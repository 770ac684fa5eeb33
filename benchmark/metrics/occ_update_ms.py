"""``occ_update_ms`` and ``occ_update_ms.<cells>``: host milliseconds a step in
the program's ``occ_update`` span (the occupancy refresh that ends a call),
normalised by the steps the trace holds."""
from benchmark.harness.readers import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "occ_update")
