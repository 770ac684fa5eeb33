"""Table-gradient scatter-add: CUDA kernel B3, the backward of B4, and their
plain PyTorch versions (the JAX package keeps both in
``kernels/scatter_pallas.py``).

* B3 ``scatter_add`` replaces ``scatter_pallas.py:scatter_add_pallas`` /
  ``scatter_add_padded``: ``zeros((T, W)).at[clip(idx, 0, T - 1)].add(upd)``
  for any N (no padding contract).
* B4 ``gather_rows_kernel_grad`` replaces
  ``scatter_pallas.py:gather_rows_pallas_grad``: a row gather whose table
  gradient is the same kernel, in ONE launch for all levels where the TPU
  makes one call per level (indices rebased and clamped per level inside the
  kernel).

Both run ``csrc/scatter_add.cu``: one thread per (update, column) with an
f32 atomic add into the table (see the source for the design). Summation
order is free, so the kernel equals its plain version to float rounding.

A wrapper takes a CUDA tensor to the kernel and a CPU tensor to the plain
version; a CUDA tensor never falls back to the plain version. Each launch
of the kernel, from either entry, adds one to ``scatter_add.launches``.
"""
from __future__ import annotations

import ctypes

import torch


def _check(indices: torch.Tensor, updates: torch.Tensor) -> None:
    if indices.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"indices must be int32 or int64, got {indices.dtype}")
    if updates.dtype != torch.float32:
        raise TypeError(f"updates must be float32, got {updates.dtype}")
    if indices.dim() != 1 or updates.dim() != 2 or updates.shape[0] != indices.shape[0]:
        raise ValueError(f"indices must be (N,) and updates (N, W), got "
                         f"{tuple(indices.shape)} and {tuple(updates.shape)}")
    if indices.device != updates.device:
        raise ValueError("indices and updates are on different devices")


def _level_rows(indices: torch.Tensor, n_levels: int, trailing: int,
                rows_per_level: int) -> torch.Tensor:
    """Each index clamped into its own level's ``[l * T, (l + 1) * T)``; the
    level of entry u is ``(u // trailing) % n_levels``."""
    idx = indices.long()
    if n_levels == 1:
        return idx.clamp(0, rows_per_level - 1)
    pos = torch.arange(idx.shape[0], device=idx.device)
    base = (pos // trailing) % n_levels * rows_per_level
    return (idx - base).clamp(0, rows_per_level - 1) + base


def scatter_add_plain(indices: torch.Tensor, updates: torch.Tensor, table_rows: int,
                      replicas: int = 1) -> torch.Tensor:
    """``zeros((T, W)).index_add_(0, indices.clamp(0, T - 1), updates)``.
    ``replicas`` changes only the kernel's summation order, so it is
    accepted and ignored here."""
    return level_scatter_add_plain(indices, updates, 1, 1, table_rows)


def _launch(indices, updates, n_levels, trailing, rows_per_level, replicas):
    """Kernel B3 over ``(N,)`` indices and ``(N, W)`` updates into a zeroed
    ``(n_levels * rows_per_level, W)`` table (see ``csrc/scatter_add.cu``)."""
    if not indices.is_cuda:
        raise ValueError(f"unsupported device {indices.device}")
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    n, w = updates.shape
    if n * w >= 2 ** 31:
        raise ValueError(f"N * W = {n * w} exceeds the kernel's 2^31 element limit")
    idx = indices.to(torch.int32).contiguous()
    upd = updates.contiguous()
    rows = n_levels * rows_per_level
    out = torch.zeros((replicas * rows, w), dtype=torch.float32, device=upd.device)
    if n == 0 or w == 0:
        return out[:rows]
    lib = _lib()
    with torch.cuda.device(upd.device):
        stream = torch.cuda.current_stream(upd.device).cuda_stream
        err = lib.scatter_add_launch(idx.data_ptr(), upd.data_ptr(), n, w, n_levels,
                                     trailing, rows_per_level, replicas,
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter_add launch failed: CUDA error {err}")
    scatter_add.launches += 1
    if replicas > 1:
        out = out.view(replicas, rows, w).sum(0)
    return out


def scatter_add(indices: torch.Tensor, updates: torch.Tensor, table_rows: int,
                replicas: int = 1) -> torch.Tensor:
    """Sum-scatter ``(N, W)`` f32 ``updates`` into a zero ``(table_rows, W)``
    table at ``indices`` clamped to ``[0, table_rows)``. A CUDA tensor
    launches kernel B3 (``replicas`` disjoint accumulator copies, summed at
    the end, spread the atomics of one row); a CPU tensor runs
    ``scatter_add_plain``."""
    _check(indices, updates)
    if updates.device.type == "cpu":
        return scatter_add_plain(indices, updates, table_rows, replicas)
    return _launch(indices, updates, 1, 1, table_rows, replicas)


scatter_add.launches = 0


def level_scatter_add_plain(flat_idx: torch.Tensor, d_rows: torch.Tensor, n_levels: int,
                            trailing: int, rows_per_level: int) -> torch.Tensor:
    """The plain table gradient of a multi-level gather: each level's
    indices rebased into ``[0, T)``, clamped, and index-added into its own
    slab of the ``(L * T, W)`` table."""
    _check(flat_idx, d_rows)
    out = torch.zeros((n_levels * rows_per_level, d_rows.shape[1]), dtype=torch.float32,
                      device=d_rows.device)
    return out.index_add_(0, _level_rows(flat_idx, n_levels, trailing, rows_per_level),
                          d_rows)


class _GatherRowsKernelGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table2d, flat_idx, n_levels, trailing, replicas):
        ctx.save_for_backward(flat_idx)
        ctx.layout = (table2d.shape[0] // n_levels, n_levels, trailing, replicas)
        return table2d.index_select(0, flat_idx)

    @staticmethod
    def backward(ctx, d_rows):
        (flat_idx,) = ctx.saved_tensors
        rows_per_level, n_levels, trailing, replicas = ctx.layout
        d_rows = d_rows.float().contiguous()
        if d_rows.device.type == "cpu":
            d_table = level_scatter_add_plain(flat_idx, d_rows, n_levels, trailing,
                                              rows_per_level)
        else:
            d_table = _launch(flat_idx, d_rows, n_levels, trailing, rows_per_level,
                              replicas)
        return d_table, None, None, None, None


def gather_rows_kernel_grad(table2d: torch.Tensor, flat_idx: torch.Tensor,
                            n_levels: int, trailing: int = 1,
                            replicas: int = 1) -> torch.Tensor:
    """``table2d.index_select(0, flat_idx)`` whose TABLE gradient is kernel
    B3, one launch for all levels (on a CPU tensor, its plain version).

    ``table2d`` is the flattened ``(L * T, W)`` f32 multi-level table;
    ``flat_idx.reshape(-1, n_levels, trailing)`` must split the levels:
    ``brick_encode`` flattens ``(N, L)`` (trailing = 1), ``hash_encode``
    ``(N, L, 8)`` corner-minor (trailing = 8). No gradient flows to the
    indices."""
    if table2d.dtype != torch.float32:
        raise TypeError(f"table2d must be float32, got {table2d.dtype}")
    if table2d.shape[0] % n_levels or flat_idx.shape[0] % (n_levels * trailing):
        raise ValueError(f"{table2d.shape[0]} rows / {flat_idx.shape[0]} indices do not "
                         f"split into {n_levels} levels x trailing {trailing}")
    return _GatherRowsKernelGrad.apply(table2d, flat_idx, n_levels, trailing, replicas)


def _lib() -> ctypes.CDLL:
    """The library of ``csrc/scatter_add.cu`` with its launch function typed."""
    from instance_nerf_tpu_torch.kernels import build

    lib = build.load("scatter_add")
    fn = lib.scatter_add_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
