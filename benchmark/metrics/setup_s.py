"""``setup_s``: seconds on the host clock from the process's start to the
first timed call: imports, the card, the inputs and weights made from the
seed, the trainer built, its first calls (kernels built or loaded from the
checkout's cache, the FLOP count) run."""


def read(run):
    return run.setup_s
