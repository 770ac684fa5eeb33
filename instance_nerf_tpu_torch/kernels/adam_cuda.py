"""Adam over every leaf of a field: CUDA kernel B7 and its plain PyTorch
version.

``adam_update_plain`` is the optax-style Adam step of the field trainers
(``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-15)`` under the JAX trainer's
rules, see ``train/ngp_trainer.py:adam_update``, which decides the frozen
leaves and the count): 14 tensor operations a leaf. ``adam_step`` does the
same, with the same arguments, for CUDA leaves in ONE launch of
``csrc/adam.cu`` for every leaf of the model: each entry's p, g, mu and nu
read once and p, mu and nu written once, in place. B7 replaces no TPU
kernel (XLA fuses optax's update on the TPU); it exists because the plain
version's passes move 4.6 times the bytes the update needs.

Each leaf takes one of three modes: ``GRADIENT`` (the full update),
``NO_GRADIENT`` (no gradient flowed: the moments decay and the stale
momentum still moves p) and ``FROZEN`` (the instance stage's frozen NeRF:
the moments decay and p is left alone). The kernel rounds every operation
as the plain version's CUDA kernels do, so on the card the two give the
same p, mu and nu bit for bit.

The leaf table is a kernel parameter: the leaves' pointers, entry counts,
modes and the first of each leaf's ``CHUNK``-entry chunks among all
leaves' chunks (``chunk_plan``). Everything but the gradients' pointers
and the step's scalars is cached by the leaves' addresses (the parameters
and moments are updated in place, so their addresses hold from step to
step). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from instance_nerf_tpu_torch.kernels import build

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-15
GRADIENT, NO_GRADIENT, FROZEN = 0, 1, 2

# the kernel's constants (csrc/adam.cu: kThreads, kBlocksPerSm, kChunk,
# kMaxLeaves)
THREADS = 256
BLOCKS_PER_SM = 4
CHUNK = 1 << 14
MAX_LEAVES = 64

launches = 0


def bias_corrections(count: int) -> tuple[float, float]:
    """optax's bias corrections ``1 - b^count``, in f32."""
    c = np.float32(count)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** c),
            float(np.float32(1) - np.float32(ADAM_B2) ** c))


@torch.no_grad()
def adam_update_plain(params, grads, mus, nus, frozen, count: int, lr: float) -> None:
    """``adam_step`` in PyTorch operations, on any device: one Adam step
    with the step count ``count`` (already advanced) over the leaves
    ``params[i]`` with gradient ``grads[i]`` (or None) and moments
    ``mus[i]``, ``nus[i]``, in place; ``frozen[i]`` masks the update of p
    (its gradient is not read)."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    bc1, bc2 = bias_corrections(count)
    for p, g, mu, nu, fz in zip(params, grads, mus, nus, frozen):
        mu.mul_(b1)
        nu.mul_(b2)
        if fz:
            continue
        if g is not None:
            mu.add_(g * (1 - b1))
            nu.add_(g * g * (1 - b2))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p.add_(upd.mul_(-lr))


class _Hyper(ctypes.Structure):
    """``csrc/adam.cu``'s ``Hyper``: the step's scalars in f32."""
    _fields_ = [(f, ctypes.c_float) for f in ("b1", "b2", "c1", "c2", "ibc1", "ibc2", "eps",
                                              "neg_lr")]


class _Leaf(ctypes.Structure):
    """``csrc/adam.cu``'s ``Leaf``."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("mu", ctypes.c_void_p),
                ("nu", ctypes.c_void_p), ("n", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in ("chunk0", "mode", "g_rows", "g_cols")]


class _Table(ctypes.Structure):
    """``csrc/adam.cu``'s ``Table``: the launch's one argument but the grid
    and the stream."""
    _fields_ = [("leaves", _Leaf * MAX_LEAVES), ("n_leaves", ctypes.c_int),
                ("n_chunks", ctypes.c_int), ("h", _Hyper)]


def chunk_plan(sizes) -> tuple[list[int], int]:
    """Each leaf's first chunk among the chunks of all leaves laid end to
    end (``CHUNK`` entries a chunk, a leaf's last chunk holding the rest),
    and the chunks in all."""
    chunk0, total = [], 0
    for n in sizes:
        chunk0.append(total)
        total += -(-n // CHUNK)
    return chunk0, total


def hyper(count: int, lr: float) -> _Hyper:
    """The step's scalars as the plain version's CUDA kernels see them: a
    Python float operand cast to f32, and a division by a host scalar a
    multiplication by its f32 reciprocal."""
    f32 = np.float32
    bc1, bc2 = bias_corrections(count)
    return _Hyper(b1=f32(ADAM_B1), b2=f32(ADAM_B2), c1=f32(1 - ADAM_B1), c2=f32(1 - ADAM_B2),
                  ibc1=f32(1) / f32(bc1), ibc2=f32(1) / f32(bc2), eps=f32(ADAM_EPS),
                  neg_lr=f32(-lr))


def _check_leaf(t: torch.Tensor, p: torch.Tensor, dev: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"adam_step: leaves must be float32, got {t.dtype}")
    if t.shape != p.shape:
        raise ValueError(f"adam_step: shapes {tuple(t.shape)} and {tuple(p.shape)} differ")
    if t.device != dev:
        raise ValueError(f"adam_step: leaves on {dev} and {t.device}")


def grad_layout(p: torch.Tensor, g: torch.Tensor, dev: torch.device) -> tuple[int, int]:
    """``(0, 0)`` for a gradient laid out as its parameter; ``(rows, cols)``
    of the parameter's last two dims for one transposed in them (autograd's
    gradient of a fleet's stacked weight: ``baddbmm`` takes
    ``w.transpose(1, 2)``). Any other layout, dtype, shape or device
    raises."""
    _check_leaf(g, p, dev)
    if g.is_contiguous():
        return 0, 0
    if g.dim() >= 2:
        # contiguous once its last two dims are swapped (strides of size-1
        # dims do not count), read from the strides: a transposed view would
        # be one more operator for the profiler to record each step
        shape, stride = list(g.shape), list(g.stride())
        shape[-2:], stride[-2:] = shape[:-3:-1], stride[:-3:-1]
        expect = 1
        for n, st in zip(reversed(shape), reversed(stride)):
            if n != 1 and st != expect:
                break
            expect *= n
        else:
            return p.shape[-2], p.shape[-1]
    raise ValueError("adam_step: a gradient must be contiguous or transposed in its last two "
                     "dims")


@functools.lru_cache(maxsize=None)
def _grid_blocks(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * BLOCKS_PER_SM


def table_template(static: tuple, grid_blocks: int) -> tuple[bytes, int, tuple]:
    """A launch's table but for the gradients' pointers and the scalars, from
    ``static``: ``(p, mu, nu, n, mode)`` of each leaf, pointers as integers;
    leaves of no entries are left out. Returns the table's bytes, the grid
    (at most ``grid_blocks`` blocks) and each table slot's leaf index and
    mode."""
    kept = [(i, leaf) for i, leaf in enumerate(static) if leaf[3] > 0]
    chunk0, total = chunk_plan([leaf[3] for _, leaf in kept])
    t = _Table(n_leaves=len(kept), n_chunks=total)
    for slot, ((_, (p, mu, nu, n, mode)), c0) in enumerate(zip(kept, chunk0)):
        t.leaves[slot] = _Leaf(p=p, g=None, mu=mu, nu=nu, n=n, chunk0=c0, mode=mode)
    return bytes(t), max(1, min(total, grid_blocks)), tuple((i, leaf[4]) for i, leaf in kept)


# table_template's results by (static, device index), built when a leaf set
# is first seen (its leaves checked then)
_tables: dict = {}


def _table(params, mus, nus, modes, dev: torch.device):
    static = tuple((p.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(), m)
                   for p, mu, nu, m in zip(params, mus, nus, modes))
    key = (static, dev.index)
    got = _tables.get(key)
    if got is None:
        for p, mu, nu in zip(params, mus, nus):
            for t in (p, mu, nu):
                _check_leaf(t, p, dev)
                if not t.is_contiguous():
                    raise ValueError("adam_step: parameters and moments must be contiguous")
        if dev.type != "cuda":
            raise ValueError(f"adam_step: leaves must be on a CUDA device, got {dev}")
        if len(_tables) >= 64:
            _tables.clear()
        got = _tables[key] = table_template(static, _grid_blocks(dev.index))
    return got


def adam_step(params, grads, mus, nus, frozen, count: int, lr: float) -> None:
    """One Adam step with the step count ``count`` (already advanced) over
    the leaves ``params[i]`` with gradient ``grads[i]`` (or None) and
    moments ``mus[i]``, ``nus[i]``, in place; ``frozen[i]`` masks the
    update of p (its gradient is not read). Kernel B7, one launch on the
    current stream for up to ``MAX_LEAVES`` leaves. Every leaf must be f32,
    of its parameter's shape and on one CUDA device, and contiguous, but
    for a gradient transposed in its last two dims (``grad_layout``);
    anything else raises."""
    global launches
    if len(params) > MAX_LEAVES:
        raise ValueError(f"adam_step: {len(params)} leaves, at most {MAX_LEAVES} a launch")
    dev = params[0].device
    modes = [FROZEN if f else NO_GRADIENT if g is None else GRADIENT
             for g, f in zip(grads, frozen)]
    layouts = [grad_layout(p, g, dev) if m == GRADIENT else None
               for p, g, m in zip(params, grads, modes)]
    raw, grid, slots = _table(params, mus, nus, modes, dev)
    table = _Table.from_buffer_copy(raw)
    for slot, (leaf, mode) in enumerate(slots):
        if mode == GRADIENT:
            t = table.leaves[slot]
            t.g = grads[leaf].data_ptr()
            t.g_rows, t.g_cols = layouts[leaf]
    table.h = hyper(count, lr)
    err = build.call_on_stream(_launch_fn(), dev.index, ctypes.byref(table), grid)
    if err != 0:
        raise RuntimeError(f"adam launch failed: CUDA error {err}")
    launches += 1


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """``csrc/adam.cu``'s launch function, typed (built on first use)."""
    return build.typed("adam", "field_adam_launch",
                       [ctypes.POINTER(_Table), ctypes.c_int, ctypes.c_void_p])
