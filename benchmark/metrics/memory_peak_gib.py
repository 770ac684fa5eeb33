"""``memory_peak_gib``: the card memory the run held at its peak, set-up and
window, GiB (``harness/readers.py:peak_gib``)."""
from benchmark.harness.readers import peak_gib


def read(run):
    return peak_gib(run)
