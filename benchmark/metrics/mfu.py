"""``mfu.<cells>``: the window's model FLOPs over its seconds times
the H100's dense bf16 peak, in % (``harness/readers.py:mfu``)."""
from benchmark.harness.readers import mfu


def read(run):
    return mfu(run)
