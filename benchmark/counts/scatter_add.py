"""Kernel B3's least time (the table-gradient scatter-add,
``instance_nerf_tpu_torch/csrc/scatter_add.cu``): a frozen copy of the
bound of the port's kernel table (``chip_smoke.py:scatter_bound_ms``: each
output written once).

A launch sums N updates of W floats into an (R, W) table: the updates
(4 bytes a float) and their int32 indices are read once and the table is
written once, at the HBM peak; its N x W adds at the f32 peak take far
less. Zeroing the table first is the kernel's choice, not the function's
work.
"""
from __future__ import annotations

from benchmark.counts import peaks


def bound_s(n: int, w: int, rows: int) -> float:
    byte_s = (n * w * 4 + n * 4 + rows * w * 4) / peaks.HBM_BYTES
    return max(byte_s, n * w / peaks.F32_FLOPS)


def field_launch(cfg: dict) -> tuple[int, int, int]:
    """``(N, W, rows)`` of the one launch of a hash field's rgb step: every
    point scatters its 8 corner rows of F floats a level; a fleet's B
    fields' levels share the launch."""
    b = cfg.get("n_scenes", 1)
    points = b * cfg["n_rays"] * cfg["k_occupied"]
    levels = cfg["n_levels"]
    return points * levels * 8, cfg["n_features"], b * levels * cfg["table_size"]
