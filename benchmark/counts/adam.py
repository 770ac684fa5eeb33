"""Kernel B7's least time (the fused Adam over every leaf of a field,
``instance_nerf_tpu_torch/csrc/adam.cu``), from the configuration alone.

A step reads each entry's parameter, gradient and two moments once and
writes the parameter and both moments once: 28 bytes an entry of the B x L
x T x F hash tables, at the HBM peak. Every MLP leaf is counted at 24 bytes
an entry, as if it had no gradient (the instance head has none in the rgb
stage; the others have one), so the bound is a lower bound and the share
cannot pass 100%. The MLP widths are the port's ``InstanceNGP``: a sigma
MLP of one hidden layer to 1 + 15 geometry features, a colour MLP of two
hidden layers from the geometry features and 9 degree-2 spherical
harmonics, an instance MLP of one hidden layer from the geometry features;
a fleet stacks B of each.
"""
from __future__ import annotations

from benchmark.counts import peaks

GEO_FEAT = 15  # InstanceNGP's geo_feat_dim
SH = 9  # degree-2 spherical harmonics of the view direction


def _dense(i: int, o: int) -> int:
    return i * o + o


def table_entries(cfg: dict) -> int:
    return cfg.get("n_scenes", 1) * cfg["n_levels"] * cfg["table_size"] * cfg["n_features"]


def mlp_entries(cfg: dict) -> int:
    h = cfg["hidden"]
    one = (_dense(cfg["n_levels"] * cfg["n_features"], h) + _dense(h, 1 + GEO_FEAT)
           + _dense(GEO_FEAT + SH, h) + _dense(h, h) + _dense(h, 3)
           + _dense(GEO_FEAT, h) + _dense(h, cfg["num_instances"]))
    return cfg.get("n_scenes", 1) * one


def bound_s(cfg: dict) -> float:
    """One step's least seconds at the HBM peak."""
    return (28 * table_entries(cfg) + 24 * mlp_entries(cfg)) / peaks.HBM_BYTES
