"""``idle_share.<cells>``: the share of the traced window in which
the device ran nothing, in % (``harness/readers.py:idle_share``)."""
from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
