"""The plain reference of a field configuration's first call (one field
or a fleet: ``plain_field.py``), on the inputs the benchmark made for the
program (``traffic/draws.py``), made again here from the seed."""
from __future__ import annotations

from benchmark.reference import plain_field
from benchmark.traffic import draws


def readings(cfg: dict, traffic: dict, seed: int, device, precision=None, fault=None,
             seen=None) -> dict:
    """The reference's readings of the first call (``plain_field.first_call``)
    and, given the program's own ray batches ``seen``, their ``ray_gap``."""
    inp = draws.make(cfg, traffic, seed, device)
    params = plain_field.init_params(cfg, seed, device, n_scenes=inp.poses.shape[0])
    out = plain_field.first_call(cfg, params, inp.grid, lambda s: draws.batch(inp, s),
                                 traffic["steps_per_call"], inp.cells, inp.cell_jitter,
                                 precision, fault)
    if seen is not None:
        out["ray_gap"] = plain_field.ray_gap(inp.poses, inp.intrinsics, inp.images, inp.hw,
                                             seen)
    return out
