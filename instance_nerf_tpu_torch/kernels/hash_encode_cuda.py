"""The multiresolution hash encoding on the card: CUDA kernel B8
(``csrc/hash_encode.cu``), and the plain arithmetic its rows and weights
are held to.

``hash_encode`` computes what ``models/hashgrid.py:hash_encode_plain``
does, the features of every point at every level, in ONE launch that reads
each corner's row and writes each feature once, with no index tensor in
between; a fleet's ``(B, L, T, F)`` tables and ``(B, ..., 3)`` points are
read and written in that layout. B8 replaces no TPU kernel (the JAX
package's encoding is plain jnp that XLA fuses); it exists because the
plain chain's int64 index passes move about twenty times the bytes the
encoding needs (see the source).

Its gradient (``_HashEncode``, an autograd Function that saves only the
points) is a second launch of the same source that recomputes each
(point, scene, level, corner)'s flat row and weight and writes the rows
and ``grad * w`` in the ``(N, B, L, 8)`` layout of kernel B3; the table
gradient is then B3 (``pallas_grad``) or ``index_add_`` (else), as the
plain chain's ``gather_rows`` backward makes it. No gradient flows to the
points.

``corner_rows_plain`` is the kernel's index and weight arithmetic in
numpy: the CPU tests hold it to the plain chain, and the card tests hold
the kernel's backward to it. ``launches`` and ``grad_launches`` count the
launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from instance_nerf_tpu_torch.kernels import build, scatter_cuda

# the kernel's limits (csrc/hash_encode.cu: kMaxLevels, kMaxFeatures)
MAX_LEVELS = 32
MAX_FEATURES = 8
# the NGP hash's primes (models/hashgrid.py:HASH_PRIMES)
PRIMES = (1, 2654435761, 805459861)

launches = 0
grad_launches = 0


class _Args(ctypes.Structure):
    """``csrc/hash_encode.cu``'s ``EncodeArgs``."""
    _fields_ = [(f, ctypes.c_void_p) for f in ("xyz", "table", "out", "grad", "rows", "d_rows",
                                               "stream")] + [
        ("scene_points", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in ("n_scenes", "n_levels", "n_features", "table_size")] + [
        ("mask", ctypes.c_uint32), ("res", ctypes.c_int * MAX_LEVELS),
        ("scale", ctypes.c_float * MAX_LEVELS), ("dense", ctypes.c_int * MAX_LEVELS)]


def level_constants(resolutions, table_size: int):
    """Each level's resolution, its scale ``res - 1`` in f32 (the plain
    chain's ``float32(res) - 1.0``), whether it is dense (``res^3 <= T``),
    and the mask that replaces ``% T`` where T is a power of two (else 0)."""
    res = np.asarray(resolutions, np.int64)
    scale = res.astype(np.float32) - np.float32(1.0)
    dense = res ** 3 <= table_size
    mask = table_size - 1 if table_size & (table_size - 1) == 0 else 0
    return res, scale, dense, mask


def corner_rows_plain(xyz, resolutions, table_size: int, n_scenes: int = 1):
    """The kernel's arithmetic in numpy: for points ``xyz (B * N, 3)`` f32
    in the caller's layout (scene after scene), each (point, scene, level,
    corner)'s flat row of the ``(B * L * T, F)`` table (int32) and its
    trilinear weight (f32), both ``(N, B, L, 8)``, corner ``4 dx + 2 dy +
    dz``. Every operation rounds as the plain chain's does: ``x * (res -
    1)``, ``floor``, ``frac``, ``1 - frac`` and ``(w0 * w1) * w2`` in f32,
    the hash in uint32 (the chain's int64 products masked to 32 bits)."""
    xyz = np.asarray(xyz, np.float32).reshape(n_scenes, -1, 3).transpose(1, 0, 2)
    res, scale, dense, mask = level_constants(resolutions, table_size)
    p = xyz[:, :, None, :] * scale[:, None]  # (N, B, L, 3)
    p0 = np.floor(p)
    frac = p - p0
    top = (res - 1)[:, None]
    i = p0.astype(np.int64)
    offs = np.array([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    c = np.minimum(i[..., None, :] + offs, top[:, None, :])  # (N, B, L, 8, 3)
    c = np.where(dense[:, None, None], np.maximum(c, 0), c)
    u = (c & 0xFFFFFFFF).astype(np.uint32)
    r = res.astype(np.uint32)[:, None]
    with np.errstate(over="ignore"):
        idx_dense = (u[..., 0] * r + u[..., 1]) * r + u[..., 2]
        h = (u[..., 0] * np.uint32(PRIMES[0])) ^ (u[..., 1] * np.uint32(PRIMES[1])) ^ (
            u[..., 2] * np.uint32(PRIMES[2]))
    idx_hash = h & np.uint32(mask) if mask else h % np.uint32(table_size)
    row = np.where(dense[:, None], idx_dense, idx_hash).astype(np.int64)
    level = np.arange(n_scenes)[:, None] * len(res) + np.arange(len(res))  # (B, L)
    flat = (row + level[..., None] * table_size).astype(np.int32)
    w1 = np.stack([np.float32(1) - frac, frac], -2)  # (N, B, L, 2, 3)
    pick = offs[None, None, None]
    wx, wy, wz = (np.take_along_axis(w1[..., k], pick[..., k], -1) for k in range(3))
    return flat, (wx * wy) * wz


def check(table: torch.Tensor, xyz: torch.Tensor, n_levels: int) -> None:
    """Refuse what B8 does not take: a table other than a contiguous,
    16-byte aligned f32 ``(L, T, F)`` or ``(B, L, T, F)``, points other than
    f32 ``(..., 3)`` (``(B, ..., 3)`` for a fleet) on its device, L or F
    beyond the kernel's limits, more than 2^31 rows."""
    if table.dtype != torch.float32 or xyz.dtype != torch.float32:
        raise TypeError(f"hash_encode: table and points must be float32, got {table.dtype} "
                        f"and {xyz.dtype}")
    if table.dim() not in (3, 4) or xyz.dim() < 1 or xyz.shape[-1] != 3:
        raise ValueError(f"hash_encode: table (L, T, F) or (B, L, T, F) and points (..., 3), "
                         f"got {tuple(table.shape)} and {tuple(xyz.shape)}")
    if table.device != xyz.device:
        raise ValueError(f"hash_encode: table on {table.device}, points on {xyz.device}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("hash_encode: the table must be contiguous and 16-byte aligned")
    b = table.shape[0] if table.dim() == 4 else 1
    if table.dim() == 4 and (xyz.dim() < 2 or xyz.shape[0] != b):
        raise ValueError(f"hash_encode: a fleet of {b} tables takes (B, ..., 3) points, got "
                         f"{tuple(xyz.shape)}")
    L, T, F = table.shape[-3:]
    if L != n_levels or not 0 < L <= MAX_LEVELS or not 0 < F <= MAX_FEATURES:
        raise ValueError(f"hash_encode: {L} levels ({n_levels} resolutions, at most "
                         f"{MAX_LEVELS}) of {F} features (at most {MAX_FEATURES})")
    if b * L * T >= 2 ** 31:
        raise ValueError(f"hash_encode: {b * L * T} rows exceed the kernel's 2^31")


@functools.lru_cache(maxsize=64)
def _template(resolutions: tuple, table_size: int, n_scenes: int, n_features: int) -> bytes:
    """A launch's arguments but for the pointers, the points and the stream."""
    res, scale, dense, mask = level_constants(resolutions, table_size)
    a = _Args(n_scenes=n_scenes, n_levels=len(res), n_features=n_features,
              table_size=table_size, mask=mask)
    a.res[:len(res)] = [int(r) for r in res]
    a.scale[:len(res)] = [float(s) for s in scale]
    a.dense[:len(res)] = [int(d) for d in dense]
    return bytes(a)


def _args(shape, xyz, resolutions) -> _Args:
    """The arguments of a launch over a table of ``shape`` and ``xyz``."""
    L, T, F = shape[-3:]
    b = shape[0] if len(shape) == 4 else 1
    a = _Args.from_buffer_copy(_template(tuple(int(r) for r in resolutions), T, b, F))
    a.xyz = xyz.data_ptr()
    a.scene_points = xyz.numel() // 3 // b
    return a


def _run(fn, a: _Args, device: torch.device, what: str) -> None:
    err = build.call_on_stream(_call, device.index, fn, a)
    if err != 0:
        raise RuntimeError(f"hash_encode {what} launch failed: CUDA error {err}")


def _call(fn, a, stream):
    a.stream = stream
    return fn(ctypes.byref(a))


def _forward(table, xyz, resolutions) -> torch.Tensor:
    global launches
    L, _, F = table.shape[-3:]
    out = torch.empty((*xyz.shape[:-1], L * F), dtype=torch.float32, device=xyz.device)
    a = _args(table.shape, xyz, resolutions)
    a.table, a.out = table.data_ptr(), out.data_ptr()
    _run(_launch_fn("hash_encode_launch"), a, xyz.device, "forward")
    launches += 1
    return out


def corner_grads(shape, xyz, grad, resolutions):
    """The backward's launch for a table of ``shape``: the flat rows ``(N *
    B * L * 8,)`` int32 and ``grad * w`` ``(N * B * L * 8, F)`` f32 in B3's
    ``(N, B, L, 8)`` layout, from the contiguous points and the features'
    contiguous f32 gradient ``grad (..., L * F)``."""
    global grad_launches
    L, _, F = shape[-3:]
    n = xyz.numel() // 3 * L * 8
    rows = torch.empty((n,), dtype=torch.int32, device=xyz.device)
    d_rows = torch.empty((n, F), dtype=torch.float32, device=xyz.device)
    a = _args(shape, xyz, resolutions)
    a.grad, a.rows, a.d_rows = grad.data_ptr(), rows.data_ptr(), d_rows.data_ptr()
    _run(_launch_fn("hash_encode_grad_launch"), a, xyz.device, "backward")
    grad_launches += 1
    return rows, d_rows


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, xyz, resolutions, pallas_grad):
        ctx.save_for_backward(xyz)
        ctx.shape, ctx.resolutions, ctx.pallas_grad = table.shape, resolutions, pallas_grad
        return _forward(table, xyz, resolutions)

    @staticmethod
    def backward(ctx, grad):
        (xyz,) = ctx.saved_tensors
        L, T, F = ctx.shape[-3:]
        levels = ctx.shape.numel() // (T * F)  # B * L
        rows, d_rows = corner_grads(ctx.shape, xyz, grad.float().contiguous(), ctx.resolutions)
        if ctx.pallas_grad:
            d_table = scatter_cuda.level_scatter_add(rows, d_rows, levels, 8, T)
        else:  # index_select's own backward
            d_table = torch.zeros((levels * T, F), dtype=torch.float32,
                                  device=xyz.device).index_add_(0, rows, d_rows)
        return d_table.view(ctx.shape), None, None, None


def hash_encode(table: torch.Tensor, xyz: torch.Tensor, resolutions,
                pallas_grad: bool = False) -> torch.Tensor:
    """``models/hashgrid.py:hash_encode`` on the card: ``(L, T, F)`` table
    and ``(..., 3)`` points in [0, 1] (a fleet's ``(B, L, T, F)`` and
    ``(B, ..., 3)``) -> ``(..., L * F)`` features, kernel B8. With a
    gradient to take, the table's flows through B8's backward and B3
    (``pallas_grad``) or ``index_add_``. Points that require a gradient,
    and anything ``check`` refuses, raise: no fallback."""
    if xyz.device.type != "cuda":
        raise ValueError(f"hash_encode: kernel B8 runs on a CUDA device, not {xyz.device}")
    check(table, xyz, len(resolutions))
    if xyz.requires_grad:
        raise ValueError("hash_encode: kernel B8 gives no gradient to the points")
    xyz = xyz.contiguous()
    if torch.is_grad_enabled() and table.requires_grad:
        return _HashEncode.apply(table, xyz, resolutions, pallas_grad)
    return _forward(table, xyz, resolutions)


@functools.lru_cache(maxsize=None)
def _launch_fn(name: str):
    """``csrc/hash_encode.cu``'s launch function ``name``, typed (built on
    first use)."""
    return build.typed("hash_encode", name, [ctypes.POINTER(_Args)])
