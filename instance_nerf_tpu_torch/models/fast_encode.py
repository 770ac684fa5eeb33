"""Fast field encoding: dense base grid + brick-hash levels (PyTorch
counterpart of ``instance_nerf_tpu.models.fast_encode``).

* **Dense base grid**: trilinear interpolation of a dense ``(R, R, R, F)``
  grid. The JAX package evaluates it as factorized tent-weight einsums with
  the x contraction in bf16 (grid and x weights rounded to bf16, f32
  accumulation); the port gathers the 8 corners and applies the same
  roundings in the same order, which is the same sum without the
  ``(N, R, R, F)`` intermediate.
* **Brick-hash levels**: each level hashes the CELL and stores its 2^3
  corner features packed in ONE table row, so one gathered row per
  (point, level). Level origins are staggered by (l + 1) / (L + 1) of a
  cell. With ``pallas_grad`` the table gradient is kernel B3
  (``kernels/scatter_cuda.py``), trailing = 1.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from instance_nerf_tpu_torch.models.hashgrid import (
    NGPHeads,
    _level_flat,
    corner_weights,
    gather_rows,
    hash_cells,
    scene_major_features,
    scene_major_points,
)
from instance_nerf_tpu_torch.train.timing import NO_STAGES


def dense_trilinear(grid: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``(R, R, R, F)`` at ``xyz`` in [0, 1]^3 ->
    ``(..., F)``, with the x weights and the grid rounded to bf16 as in the
    JAX package's MXU contraction. The grid's gradient is rounded to bf16
    once, after accumulation, as the JAX cast's VJP does. A fleet's ``(B, R,
    R, R, F)`` grids take ``(B, ..., 3)``, scene b read from grid b."""
    r, f = grid.shape[-2], grid.shape[-1]
    lead = xyz.shape[:-1]
    p = torch.clamp(xyz.reshape(-1, 3), 0.0, 1.0) * (r - 1)  # (N, 3)
    i0 = torch.floor(p).to(torch.int64).clamp(0, r - 1)
    i1 = (i0 + 1).clamp(max=r - 1)
    # the two nonzero tent weights max(0, 1 - |i - p|) per axis
    w0 = torch.clamp(1.0 - torch.abs(i0.to(p.dtype) - p), min=0.0)
    w1 = torch.where(i1 > i0, torch.clamp(1.0 - torch.abs(i1.to(p.dtype) - p), min=0.0),
                     torch.zeros_like(p))
    g16 = grid.to(torch.bfloat16).to(torch.float32).reshape(-1, f)
    bx = [w.to(torch.bfloat16).to(torch.float32)[:, 0:1] for w in (w0, w1)]
    if grid.dim() == 5:  # a fleet: scene b's rows start at b * R^3
        b = grid.shape[0]
        scene = (torch.arange(b, device=p.device) * r).repeat_interleave(p.shape[0] // b)
        i0 = torch.cat([i0[:, :1] + scene[:, None], i0[:, 1:]], dim=1)
        i1 = torch.cat([i1[:, :1] + scene[:, None], i1[:, 1:]], dim=1)
    ix = (i0[:, 0], i1[:, 0])
    iy = (i0[:, 1], i1[:, 1])
    iz = (i0[:, 2], i1[:, 2])
    wy = (w0[:, 1:2], w1[:, 1:2])
    wz = (w0[:, 2:3], w1[:, 2:3])
    out = None
    for c in range(2):  # z
        v = None
        for b in range(2):  # y
            rows = [(ix[a] * r + iy[b]) * r + iz[c] for a in range(2)]
            u = bx[0] * g16.index_select(0, rows[0]) + bx[1] * g16.index_select(0, rows[1])
            v = wy[b] * u if v is None else v + wy[b] * u
        out = wz[c] * v if out is None else out + wz[c] * v
    return out.reshape(*lead, f)


def brick_encode(table: torch.Tensor, xyz: torch.Tensor, resolutions,
                 pallas_grad: bool = False, pallas_replicas: int = 1,
                 table_cast: torch.dtype | None = None, stage=NO_STAGES) -> torch.Tensor:
    """Brick-hash encoding ``(L, T, 8, F)`` table -> ``(..., L * F)``: ONE
    gathered row per (point, level). Dense levels (res^3 <= T) index
    directly; finer levels hash the cell with the NGP primes. The flat
    index layout is ``(N, L)`` (trailing = 1); a fleet's ``(B, L, T, 8, F)``
    tables take ``(B, ..., 3)`` and lay out ``(N, B, L)``, B * L levels of
    one kernel launch. ``table_cast``: the rows are read in this dtype (a
    bf16 table); the f32 table stays the master. ``stage``
    (``train/timing.py:Stages``) uploads the host constants."""
    L, T, C, F = table.shape[-4:]
    lead = xyz.shape[:-1]
    x, b = scene_major_points(table, 4, xyz)
    n = x.shape[0]
    res_np = np.asarray(resolutions, np.int64)
    resf = stage.upload(res_np, x.device, x.dtype)
    offs = (np.arange(L, dtype=np.float64) + 1.0) / (L + 1.0)
    offs_t = stage.upload(offs / np.maximum(res_np, 1), x.device, x.dtype)
    p = (torch.clamp(x, 0.0, 1.0)[:, None, :] + offs_t[None, :, None]) * (
        resf[None, :, None] - 1.0)  # (N, L, 3)
    cell = torch.floor(p)
    frac = p - cell
    c = torch.minimum(cell.to(torch.int64), stage.upload(res_np - 1, x.device).view(1, L, 1))
    flat = _level_flat(hash_cells(c, res_np, T, stage).reshape(-1, b * L), b * L, T)
    rows = gather_rows(table.reshape(b * L * T, C * F), flat, b * L, 1, pallas_grad,
                       pallas_replicas, table_cast)  # (N * L, C * F)
    w = corner_weights(frac.reshape(-1, 3), stage)  # (N * L, 8)
    feats = (rows.view(n * L, C, F) * w[..., None]).sum(1)
    return scene_major_features(feats.reshape(n, L * F), b, lead)


def pe_encode(xyz: torch.Tensor, n_freqs: int = 4, stage=NO_STAGES) -> torch.Tensor:
    """Low-frequency positional encoding -> (..., 6 * n_freqs)."""
    freqs = stage.upload((2.0 ** np.arange(n_freqs)) * np.pi, xyz.device, xyz.dtype)
    ang = xyz[..., None, :] * freqs[:, None]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(*xyz.shape[:-1], 6 * n_freqs)


def brick_resolutions(n_levels: int = 6, base_res: int = 32,
                      max_res: int = 1024) -> np.ndarray:
    if n_levels == 1:
        return np.array([base_res])
    b = np.exp((np.log(max_res) - np.log(base_res)) / (n_levels - 1))
    return np.round(base_res * b ** np.arange(n_levels)).astype(np.int64)


def is_instance_param(name: str) -> bool:
    """A parameter of the instance head: a module named ``inst_*`` on its
    path (``inst_0.weight``)."""
    return any(part.startswith("inst_") for part in name.split("."))


def mask_to_instance_head(tree: dict) -> dict:
    """Zero every entry of a ``{name: tensor}`` grad/update dict outside the
    instance head: the instance stage trains the instance MLP against a
    FROZEN NeRF."""
    return {k: (v if is_instance_param(k) else torch.zeros_like(v)) for k, v in tree.items()}


class InstanceNGPFast(NGPHeads):
    """Instance-field NeRF with the fast encoding: dense base grid +
    brick-hash levels + positional encoding. Same heads as ``InstanceNGP``.
    ``table_dtype="bfloat16"`` reads the brick table in bf16 (the f32 table
    and its Adam state stay the master; any other value reads f32, as in the
    JAX package). ``n_scenes``: a fleet, as for ``InstanceNGP``."""

    def __init__(self, n_levels: int = 6, table_size: int = 2 ** 17, n_features: int = 2,
                 base_res: int = 32, max_res: int = 1024, dense_res: int = 16,
                 dense_features: int = 8, pe_freqs: int = 4, geo_feat_dim: int = 15,
                 hidden: int = 64, num_instances: int = 33, dtype=None,
                 pallas_grad: bool = False, pallas_replicas: int = 1,
                 table_dtype: str | None = None, n_scenes: int | None = None):
        super().__init__()
        self.table_cast = torch.bfloat16 if table_dtype == "bfloat16" else None
        self.pallas_grad = pallas_grad
        self.pallas_replicas = pallas_replicas
        self.pe_freqs = pe_freqs
        self.resolutions = brick_resolutions(n_levels, base_res, max_res)
        self.n_scenes = n_scenes
        self.brick_table = nn.Parameter(
            torch.zeros(self._stacked((n_levels, table_size, 8, n_features)),
                        dtype=torch.float32))
        self.dense_grid = nn.Parameter(
            torch.zeros(self._stacked((dense_res,) * 3 + (dense_features,)),
                        dtype=torch.float32))
        in_dim = dense_features + n_levels * n_features + 6 * pe_freqs
        self._make_heads(in_dim, geo_feat_dim, hidden, num_instances, dtype, n_scenes)

    def encode(self, xyz, stage=NO_STAGES):
        return torch.cat([
            dense_trilinear(self.dense_grid, xyz),
            brick_encode(self.brick_table, xyz, self.resolutions,
                         pallas_grad=self.pallas_grad,
                         pallas_replicas=self.pallas_replicas, table_cast=self.table_cast,
                         stage=stage),
            pe_encode(xyz, self.pe_freqs, stage),
        ], dim=-1)

