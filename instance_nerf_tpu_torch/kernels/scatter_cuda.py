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

Both run ``csrc/scatter_add.cu``: vector atomics of whole rows, runs of
equal rows summed in registers first, level by level through L2, split
over the card by ``scatter_plan`` on the host (see the source). Summation
order is free, so the kernel equals its plain version to float rounding.

A wrapper takes a CUDA tensor to the kernel and a CPU tensor to the plain
version; a CUDA tensor never falls back to the plain version. Each launch
of the kernel, from either entry, adds one to ``scatter_add.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from instance_nerf_tpu_torch.kernels import build

# the kernel's constants (csrc/scatter_add.cu: kRun, kMaxLanes, kThreads)
RUN = 8
MAX_LANES = 8
THREADS = 256
# at most this many runs of RUN points per thread; at least half the blocks
# an SM holds at once (2048 threads) per level, so that the blocks in
# flight work on a level or two and its table rows stay in L2
MAX_PASSES = 16
THREADS_PER_SM = 2048


class ScatterPlan(NamedTuple):
    """How one launch of B3 splits its work: ``lanes`` threads per update
    (each a share of its row's 16-byte vectors) and the runs of ``RUN``
    points each thread takes (``passes``)."""
    lanes: int
    passes: int


def scatter_plan(n: int, w: int, n_levels: int, trailing: int, n_sm: int = 132) -> ScatterPlan:
    """The split of ``n`` updates of ``w`` floats, laid out ``(points,
    n_levels, trailing)``, over ``n_sm`` SMs. The kernel gives a row of c
    vectors up to ``MAX_LANES`` threads (c's largest power-of-two factor);
    the plan assumes 16-byte vectors where W allows, as the kernel does
    for 16-byte aligned tensors."""
    points = -(-n // (n_levels * trailing))
    vec = 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1
    lanes = 1
    while lanes < MAX_LANES and (w // vec) % (2 * lanes) == 0 and 2 * lanes * trailing <= THREADS:
        lanes *= 2
    per_pass = THREADS // (lanes * trailing) * RUN  # points a block's threads take per pass
    blocks_per_level = n_sm * (THREADS_PER_SM // THREADS) // 2
    passes = max(1, min(MAX_PASSES, points // (per_pass * blocks_per_level)))
    return ScatterPlan(lanes, passes)


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


class _LaunchArgs(ctypes.Structure):
    """``csrc/scatter_add.cu``'s ``LaunchArgs``: the host call converts one
    pointer instead of eleven arguments."""
    _fields_ = [("idx", ctypes.c_void_p), ("upd", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("n", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in ("w", "n_levels", "trailing", "rows_per_level", "replicas",
                                    "passes")]


@functools.lru_cache(maxsize=256)
def _launch_template(n, w, n_levels, trailing, rows_per_level, replicas, device) -> bytes:
    """The bytes of a launch's arguments but for the pointers and the
    stream, planned by ``scatter_plan`` for the card ``device``. Each launch
    copies them into a struct of its own, so that launches from several
    host threads never share one."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    plan = scatter_plan(n, w, n_levels, trailing, n_sm)
    return bytes(_LaunchArgs(n=n, w=w, n_levels=n_levels, trailing=trailing,
                             rows_per_level=rows_per_level, replicas=replicas,
                             passes=plan.passes))


def _call(args, stream):
    args.stream = stream
    return _launch_fn()(args)


def _launch(indices, updates, n_levels, trailing, rows_per_level, replicas):
    """Kernel B3 over ``(N,)`` indices and ``(N, W)`` updates into a zeroed
    ``(n_levels * rows_per_level, W)`` table (see ``csrc/scatter_add.cu``)."""
    if not indices.is_cuda:
        raise ValueError(f"unsupported device {indices.device}")
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if trailing > THREADS:
        raise ValueError(f"trailing = {trailing} exceeds {THREADS}")
    n, w = updates.shape
    if n * w >= 2 ** 31:
        raise ValueError(f"N * W = {n * w} exceeds the kernel's 2^31 element limit")
    # the host work of a launch is kept to what it must do: at probe sizes
    # it takes longer than the kernel
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int32)
    if not indices.is_contiguous():
        indices = indices.contiguous()
    if not updates.is_contiguous():
        updates = updates.contiguous()
    rows = n_levels * rows_per_level
    if n == 0 or w == 0:
        return updates.new_zeros((rows, w))
    out = updates.new_empty((replicas * rows, w))  # zeroed by the launch
    index = updates.get_device()
    args = _LaunchArgs.from_buffer_copy(
        _launch_template(n, w, n_levels, trailing, rows_per_level, replicas, index))
    args.idx, args.upd, args.out = indices.data_ptr(), updates.data_ptr(), out.data_ptr()
    err = build.call_on_stream(_call, index, args)
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


def level_scatter_add(flat_idx: torch.Tensor, d_rows: torch.Tensor, n_levels: int,
                      trailing: int, rows_per_level: int, replicas: int = 1) -> torch.Tensor:
    """The table gradient of a multi-level gather (``level_scatter_add_plain``'s
    sum): kernel B3 for CUDA tensors, one launch for all levels; the plain
    version for CPU ones."""
    if d_rows.device.type == "cpu":
        return level_scatter_add_plain(flat_idx, d_rows, n_levels, trailing, rows_per_level)
    return _launch(flat_idx, d_rows, n_levels, trailing, rows_per_level, replicas)


class _GatherRowsKernelGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table2d, flat_idx, n_levels, trailing, replicas, rows_dtype):
        ctx.save_for_backward(flat_idx)
        ctx.layout = (table2d.shape[0] // n_levels, n_levels, trailing, replicas)
        rows = table2d.index_select(0, flat_idx)
        return rows if rows_dtype is None else rows.to(rows_dtype)

    @staticmethod
    def backward(ctx, d_rows):
        (flat_idx,) = ctx.saved_tensors
        rows_per_level, n_levels, trailing, replicas = ctx.layout
        d_table = level_scatter_add(flat_idx, d_rows.float().contiguous(), n_levels, trailing,
                                    rows_per_level, replicas)
        return d_table, None, None, None, None, None


def gather_rows_kernel_grad(table2d: torch.Tensor, flat_idx: torch.Tensor,
                            n_levels: int, trailing: int = 1, replicas: int = 1,
                            rows_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table2d.index_select(0, flat_idx)`` whose TABLE gradient is kernel
    B3, one launch for all levels (on a CPU tensor, its plain version).

    ``table2d`` is the flattened ``(L * T, W)`` f32 multi-level table;
    ``flat_idx.reshape(-1, n_levels, trailing)`` must split the levels:
    ``brick_encode`` flattens ``(N, L)`` (trailing = 1), ``hash_encode``
    ``(N, L, 8)`` corner-minor (trailing = 8); a fleet's ``(N, B, L)`` is
    ``B * L`` levels. ``rows_dtype`` casts the gathered rows (a bf16 table
    read): their gradient arrives in that dtype and the kernel's f32 sum
    goes to the f32 table as it is, as the JAX package's custom VJP hands
    the Pallas scatter's f32 sum to its f32 master table. No gradient flows
    to the indices."""
    if table2d.dtype != torch.float32:
        raise TypeError(f"table2d must be float32, got {table2d.dtype}")
    if table2d.shape[0] % n_levels or flat_idx.shape[0] % (n_levels * trailing):
        raise ValueError(f"{table2d.shape[0]} rows / {flat_idx.shape[0]} indices do not "
                         f"split into {n_levels} levels x trailing {trailing}")
    return _GatherRowsKernelGrad.apply(table2d, flat_idx, n_levels, trailing, replicas,
                                       rows_dtype)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """``csrc/scatter_add.cu``'s launch function, typed (built on first use)."""
    return build.typed("scatter_add", "scatter_add_launch", [ctypes.POINTER(_LaunchArgs)])

