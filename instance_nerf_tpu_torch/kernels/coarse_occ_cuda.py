"""Coarse-occupancy lookup: CUDA kernel B5 and its plain PyTorch version.

``coarse_occ_lookup`` replaces ``kernels/coarse_occ_pallas.py:coarse_occ_lookup``
of the JAX package: the occupancy of each sample's cell in a coarse
``(R, R, R)`` grid, which ``models/render.py:coarse_occupancy_mxu`` computes
for the renderer. Like the JAX kernel it has no caller in the package; the
renderer keeps its own lookup. The kernel is ``csrc/coarse_occ.cu`` (four
points per thread with 16-byte accesses, any N and any base offset). The
kernel takes a few microseconds, so the launch path does no more than it
must: no copy of a contiguous input, a bool grid passed through as bytes,
the typed C function cached, the stream handle taken raw.

A wrapper takes a CUDA tensor to the kernel and a CPU tensor to the plain
version; a CUDA tensor never falls back. ``coarse_occ_lookup.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from instance_nerf_tpu_torch.kernels import build


def _check(cells: torch.Tensor, grid: torch.Tensor) -> None:
    if cells.dtype != torch.int32 or cells.dim() != 2 or cells.shape[1] != 3:
        raise ValueError(f"cells must be (N, 3) int32, got {tuple(cells.shape)} {cells.dtype}")
    if grid.dim() != 3 or not grid.shape[0] == grid.shape[1] == grid.shape[2]:
        raise ValueError(f"grid must be (R, R, R), got {tuple(grid.shape)}")
    if cells.device != grid.device:
        raise ValueError("cells and grid are on different devices")


def coarse_occ_lookup_plain(cells: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``(grid != 0)[x, y, z]`` as f32 for each ``(N, 3)`` cell, 0 for a cell
    outside the grid."""
    _check(cells, grid)
    r = grid.shape[0]
    inside = ((cells >= 0) & (cells < r)).all(-1)
    c = cells.long().clamp(0, r - 1)
    return ((grid != 0)[c[:, 0], c[:, 1], c[:, 2]] & inside).float()


def coarse_occ_lookup(cells: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``(N, 3)`` int32 coarse cell ids and an ``(R, R, R)`` {0, 1} occupancy
    grid -> ``(N,)`` f32 occupancy. A CUDA tensor launches kernel B5 (and
    counts one launch); a CPU tensor runs ``coarse_occ_lookup_plain``."""
    _check(cells, grid)
    dev = cells.device
    if dev.type == "cpu":
        return coarse_occ_lookup_plain(cells, grid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = cells.shape[0]
    out = cells.new_empty((n,), dtype=torch.float32)
    if n == 0:
        return out
    if not cells.is_contiguous():
        cells = cells.contiguous()
    # a bool grid is already one 0/1 byte per cell; anything else is converted
    if grid.dtype != torch.bool:
        grid = grid != 0
    if not grid.is_contiguous():
        grid = grid.contiguous()
    err = build.call_on_stream(_launch_fn(), dev.index, cells.data_ptr(), grid.data_ptr(),
                               grid.shape[0], n, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"coarse_occ launch failed: CUDA error {err}")
    coarse_occ_lookup.launches += 1
    return out


coarse_occ_lookup.launches = 0


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """``csrc/coarse_occ.cu``'s launch function, typed (built on first use)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.typed("coarse_occ", "coarse_occ_launch", [p, p, i, i, p, p])
