"""``scatter_add_roofline`` and ``scatter_add_roofline.<cells>``: kernel B3's share of its
roofline, in % (``harness/readers.py:scatter_add_roofline``). A kernel
that replaces it is appended to ``NAMES``."""
from benchmark.harness.readers import scatter_add_roofline

NAMES = ["scatter_add_kernel"]


def read(run):
    return scatter_add_roofline(run, NAMES)
