"""``adam_roofline`` and ``adam_roofline.<cells>``: kernel B7's share of its
roofline, in %: its least time by the configuration's byte count
(``counts/adam.py``) times its launches, over its device time in the
traced window. B7 zeroes nothing before it, so no operation before it on
its stream is counted with it. A kernel that replaces it is appended to
``NAMES``; a program without it gives no reading."""
from benchmark.counts.adam import bound_s
from benchmark.harness.readers import launch_time

NAMES = ["field_adam_kernel"]
# an operation name that nothing starts with: only the kernel itself counts
NO_MEMSET = "\0"


def read(run):
    got = launch_time(run, NAMES, preceded_by=NO_MEMSET)
    if got is None:
        return None
    seconds, launches = got
    return 100.0 * launches * bound_s(run.config) / seconds
