"""Kernel B8's least time (the hash encoding,
``instance_nerf_tpu_torch/csrc/hash_encode.cu``: its forward launch and its
backward's), from the configuration alone.

A call of ``occ_update_every`` training steps encodes each step's points
(B x ``n_rays`` x ``k_occupied``) with the gradient, then the refresh's
points without it: ``occ_res^3`` for one field, in chunks of 2^18 points
(``models/render.py:update_occupancy``); ``occ_res^3 x occ_subsample`` a
scene for a fleet, in chunks of 2^21 points over the fleet
(``train/multiscene.py:OCC_QUERY_POINTS``). Every chunk and every step is
one forward launch, and every step one backward launch.

Bytes at the HBM peak, each counted once with no sector rounding, so the
bound is a lower bound and the share cannot pass 100%: the forward reads a
point (12 bytes) and its 8 corner rows of F floats at each of L levels
and writes its L x F features; the backward reads a step's point and its
features' gradient and writes, at each level, 8 int32 rows and 8 rows of F
floats (``grad * w``).
"""
from __future__ import annotations

from benchmark.counts import peaks

FIELD_CHUNK = 2 ** 18  # models/render.py:update_occupancy's points a chunk
FLEET_CHUNK = 2 ** 21  # train/multiscene.py:OCC_QUERY_POINTS


def forward_bytes(cfg: dict) -> int:
    lf = cfg["n_levels"] * cfg["n_features"]
    return 12 + 4 * lf + 8 * lf * 4


def backward_bytes(cfg: dict) -> int:
    lf = cfg["n_levels"] * cfg["n_features"]
    return 12 + 4 * lf + cfg["n_levels"] * 8 * (4 + 4 * cfg["n_features"])


def step_points(cfg: dict) -> int:
    return cfg.get("n_scenes", 1) * cfg["n_rays"] * cfg["k_occupied"]


def refresh(cfg: dict) -> tuple[int, int]:
    """The refresh's points and its forward launches (chunks)."""
    cells = cfg["occ_res"] ** 3
    if "n_scenes" not in cfg:
        return cells, -(-cells // FIELD_CHUNK)
    b = cfg["n_scenes"]
    m = max(1, int(cells * cfg.get("occ_subsample", 1.0)))
    return b * m, -(-m // max(1, FLEET_CHUNK // b))


def launches_per_call(cfg: dict) -> int:
    """B8's launches in a call: a forward and a backward a step, a forward
    a chunk of the refresh."""
    return 2 * cfg["occ_update_every"] + refresh(cfg)[1]


def bound_s(cfg: dict) -> float:
    """One call's least seconds at the HBM peak."""
    fwd, bwd = forward_bytes(cfg), backward_bytes(cfg)
    steps = cfg["occ_update_every"] * step_points(cfg) * (fwd + bwd)
    return (steps + refresh(cfg)[0] * fwd) / peaks.HBM_BYTES
