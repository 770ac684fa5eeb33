"""``hash_encode_roofline`` and ``hash_encode_roofline.<cells>``: kernel
B8's share of its roofline, in %: a call's least time by the
configuration's byte count (``counts/hash_encode.py``) times the calls its
launches make (its forward and backward launches in the traced window over
its launches a call), over the device time of those launches. B8 zeroes
nothing before it, so no operation before it on its stream is counted with
it. A program without B8 gives no reading."""
from benchmark.counts.hash_encode import bound_s, launches_per_call
from benchmark.harness.readers import launch_time

NAMES = ["hash_encode_kernel", "hash_encode_grad_kernel"]
# an operation name that nothing starts with: only the kernels themselves count
NO_MEMSET = "\0"


def read(run):
    got = launch_time(run, NAMES, preceded_by=NO_MEMSET)
    if got is None:
        return None
    seconds, launches = got
    return 100.0 * launches / launches_per_call(run.config) * bound_s(run.config) / seconds
