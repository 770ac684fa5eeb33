"""``waits_per_step`` and ``waits_per_step.<cells>``: the program's ``wait``
spans the trace holds over the steps it holds: how often a step's host
blocks on the card."""
from benchmark.harness.readers import steps_seen


def read(run):
    seen = steps_seen(run)
    span = run.trace["spans"].get(f"{run.prefix}.wait") if run.trace else None
    if not seen or not span:
        return None
    return span[1] / seen
