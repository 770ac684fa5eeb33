"""The device mesh as a ``torch.distributed`` process group (PyTorch
counterpart of ``instance_nerf_tpu.parallel.mesh``).

The JAX package lays its devices out ``(dcn, data, sp)`` and lets GSPMD
insert the collectives. Here each rank is one process bound to one card;
rank ``r`` takes the place of the JAX mesh's device ``r`` (the same
row-major order), and the collectives are written out: a forward sum of
the loss normalizers (``Shard.sum``) and a bucketed SUM of the gradients
(``all_reduce_sum``). The ranks come from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from an explicit
``init_method``; the backend is NCCL on the card and gloo on the CPU, and
gloo on CUDA tensors only when the caller names it.

With one process and no process group every function here is the
identity, so the one-card paths are unchanged.
"""
from __future__ import annotations

import atexit
import logging
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from instance_nerf_tpu_torch.parallel.spatial import split_size

log = logging.getLogger(__name__)

# elements (f32) of one all-reduce bucket
BUCKET_NUMEL = 2 ** 23


def data_axis_size(batch_size: int, n_devices: int) -> int:
    """Largest divisor of ``batch_size`` that fits in ``n_devices`` (the data
    axis must divide the scene batch), with the JAX package's warning when
    it leaves devices out."""
    for n in range(min(batch_size, n_devices), 0, -1):
        if batch_size % n == 0:
            if n < n_devices:
                log.warning(
                    "data_axis_size: batch %d only divides onto %d of %d "
                    "devices — pick a batch size divisible by the device "
                    "count for full data parallelism",
                    batch_size, n, n_devices,
                )
            return n
    return 1


def mesh_coords(n_dcn: int, n_data: int, n_spatial: int) -> list:
    """``(dcn, data, sp)`` of each used rank, in the JAX mesh's device order
    (``devices[:used].reshape(n_dcn, n_data, n_spatial)``)."""
    shape = (n_dcn, n_data, n_spatial)
    return [tuple(int(c) for c in np.unravel_index(r, shape))
            for r in range(int(np.prod(shape)))]


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def under_launcher() -> bool:
    """A process group exists, or ``torchrun``'s environment names one."""
    return distributed() or "WORLD_SIZE" in os.environ


def launched_world() -> int:
    """The number of ranks of the process group, or that ``torchrun``'s
    environment names."""
    return dist.get_world_size() if distributed() else int(os.environ.get("WORLD_SIZE", 1))


def is_main() -> bool:
    return not distributed() or dist.get_rank() == 0


def barrier() -> None:
    if distributed():
        dist.barrier()


class Mesh:
    """``n_dcn x n_data x n_spatial`` ranks of ``world``; ranks past the
    layout are idle (the JAX mesh's unused devices). ``data_group`` holds
    the ranks of this rank's ``sp`` coordinate, ``sp_group`` those of its
    ``(dcn, data)`` coordinates (None on an idle rank, or without a process
    group). ``halo`` counts the bytes and exchanges of this rank's halos on
    the ``sp`` axis (``parallel/spatial.py``)."""

    def __init__(self, n_dcn: int, n_data: int, n_spatial: int, rank: int = 0,
                 world: int = 1, device=None):
        self.n_dcn, self.n_data, self.n_spatial = n_dcn, n_data, n_spatial
        self.rank, self.world = rank, world
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.coords = mesh_coords(n_dcn, n_data, n_spatial)
        self.used = len(self.coords)
        self.active = rank < self.used
        self.coord = self.coords[rank] if self.active else None
        self.data_group = self.sp_group = None
        self.halo = {"bytes": 0, "exchanges": 0}
        if distributed() and world > 1:
            # every rank creates every group, in the same order
            for sp in range(n_spatial):
                g = dist.new_group([r for r, c in enumerate(self.coords) if c[2] == sp])
                if self.active and self.coord[2] == sp:
                    self.data_group = g
            for a in range(n_dcn):
                for b in range(n_data):
                    g = dist.new_group([r for r, c in enumerate(self.coords)
                                        if c[:2] == (a, b)])
                    if self.active and self.coord[:2] == (a, b):
                        self.sp_group = g
            if self.sp_group is not None and n_spatial > 1:
                # NCCL's point-to-point calls (the spatial axis's halos) need
                # a collective on their group first
                dist.all_reduce(torch.zeros(1, device=self.device), group=self.sp_group)

    @property
    def data_size(self) -> int:
        return self.n_dcn * self.n_data

    @property
    def data_index(self) -> int:
        """This rank's position along ``dcn x data`` (0 on an idle rank)."""
        return self.coord[0] * self.n_data + self.coord[1] if self.active else 0

    @property
    def sp_index(self) -> int:
        return self.coord[2] if self.active else 0

    def shard(self, n: int) -> "Shard":
        """This rank's share of a global batch of ``n`` scenes: its
        contiguous block along ``dcn x data``. An idle rank gets row 0 with
        weight 0: it runs the step on it and adds zeros to every sum."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} does not divide over {self.data_size} data ranks")
        per = n // self.data_size
        if not self.active:
            return Shard(n, 0, 1, 0.0)
        lo = self.data_index * per
        return Shard(n, lo, lo + per, 1.0)

    def __repr__(self):
        return (f"Mesh(dcn={self.n_dcn}, data={self.n_data}, sp={self.n_spatial}, "
                f"rank={self.rank}/{self.world}, device={self.device})")


def make_mesh(n_data: int | None = None, n_spatial: int = 1, n_dcn: int = 1,
              backend: str | None = None, device="cuda", init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> Mesh:
    """The ``(dcn, data, sp)`` mesh over the launched ranks. Joins (or
    starts) the process group: from ``init_method`` with ``rank`` and
    ``world_size``, else from ``torchrun``'s environment; one process
    without either is a mesh of one. ``device="cuda"`` binds
    ``cuda:LOCAL_RANK``. Raises, as the JAX mesh does, when the layout
    needs more ranks than there are."""
    dev_type = torch.device(device).type
    if not distributed() and (init_method is not None or "WORLD_SIZE" in os.environ):
        backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
        if init_method is None:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
        atexit.register(_leave)
    r, world = (dist.get_rank(), dist.get_world_size()) if distributed() else (0, 1)
    if dev_type == "cuda":
        # more ranks than cards share them (gloo, named by the caller)
        local = int(os.environ.get("LOCAL_RANK", r)) % max(1, torch.cuda.device_count())
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if n_data is None:
        n_data = world // (n_spatial * n_dcn)
    used = n_dcn * n_data * n_spatial
    if used > world:
        raise ValueError(f"make_mesh: dcn={n_dcn} x data={n_data} x sp={n_spatial} needs "
                         f"{used} devices, have {world}")
    if used < world:
        log.warning("make_mesh: using %d of %d devices (dcn=%d x data=%d x sp=%d)",
                    used, world, n_dcn, n_data, n_spatial)
    return Mesh(n_dcn, n_data, n_spatial, r, world, dev)


def _leave() -> None:
    if distributed():
        dist.destroy_process_group()


def launched_mesh(batch_size: int, device="cuda", n_spatial: int = 1) -> Mesh | None:
    """The detector trainers' mesh under ``torchrun`` (None outside it), as
    the JAX trainers build theirs: ``min(n_spatial, world)`` spatial ranks
    and the data axis over ``data_axis_size(batch_size, world // sp)``."""
    if not under_launcher():
        return None
    world = launched_world()
    n_sp = min(n_spatial, world)
    return make_mesh(n_data=data_axis_size(batch_size, max(1, world // n_sp)),
                     n_spatial=n_sp, device=device)


def batch_shard(mesh: Mesh | None, n: int) -> Shard | None:
    """``mesh.shard(n)`` under a process group, else None (one process)."""
    return mesh.shard(n) if mesh is not None and distributed() else None


def local_rows(mesh: Mesh, tree):
    """The rank's part of a host batch, as the JAX ``shard_batch`` places it:
    an array whose leading dimension the data size divides gives its
    contiguous block along ``dcn x data`` (a 5-D voxel grid its block of W
    over ``sp`` too, which raises ``ValueError`` where ``sp`` does not divide
    W, as JAX's ``device_put`` on ``grid_sharding`` does); everything else is
    replicated. An idle rank gets empty blocks."""
    n = mesh.data_size

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if not hasattr(x, "shape") or len(x.shape) == 0 or x.shape[0] % n:
            return x
        per = x.shape[0] // n
        lo = mesh.data_index * per if mesh.active else 0
        x = x[lo:lo + per] if mesh.active else x[:0]
        if len(x.shape) >= 5 and mesh.n_spatial > 1:
            w = split_size(x.shape[1], mesh.n_spatial)
            x = x[:, mesh.sp_index * w:(mesh.sp_index + 1) * w]
        return x

    return take(tree)


def forward_sum(x: torch.Tensor, group=None, weight: float = 1.0) -> torch.Tensor:
    """The f32 sum over the ranks of ``group`` of ``x`` (this rank's times
    ``weight``), without gradient: the global count or total a loss divides
    its rank's partial numerator by. ``x`` itself without a process group."""
    x = x.detach().to(torch.float32)
    if not distributed():
        return x
    buf = x * weight
    dist.all_reduce(buf, group=group)
    return buf


class Shard(NamedTuple):
    """Rows ``[lo, hi)`` of a global batch of ``n``, and this rank's weight
    in the sums over ranks (0 on an idle rank, which runs on row 0)."""

    n: int
    lo: int
    hi: int
    weight: float = 1.0

    def take(self, x):
        return x[self.lo:self.hi]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return forward_sum(x, weight=self.weight)

    def rand(self, shape, generator=None, device=None) -> torch.Tensor:
        """This rank's rows of uniforms drawn for the whole batch:
        ``(hi - lo, *shape)`` of ``(n, *shape)`` from ``generator``."""
        return torch.rand((self.n, *shape), generator=generator, device=device)[self.lo:self.hi]


def buckets(numels, limit: int = BUCKET_NUMEL) -> list:
    """``all_reduce_sum``'s buckets of tensors of ``numels`` elements: runs
    of consecutive indices whose sizes add to at most ``limit`` (a larger
    tensor is a bucket of its own). One NCCL call a bucket."""
    out, size = [], 0
    for i, n in enumerate(numels):
        if not out or size + n > limit:
            out.append([])
            size = 0
        out[-1].append(i)
        size += n
    return out


def all_reduce_sum(tensors, group=None, bucket_numel: int = BUCKET_NUMEL) -> list:
    """The SUM over ranks of each tensor, through flat f32 buffers of at most
    ``bucket_numel`` elements (``buckets``); the results keep each tensor's
    shape and dtype. Without a process group the tensors come back as they
    are."""
    tensors = list(tensors)
    if not distributed():
        return tensors
    out = [None] * len(tensors)
    for bucket in buckets([t.numel() for t in tensors], bucket_numel):
        buf = torch.cat([tensors[i].detach().reshape(-1).to(torch.float32) for i in bucket])
        dist.all_reduce(buf, group=group)
        ofs = 0
        for i in bucket:
            t = tensors[i]
            out[i] = buf[ofs:ofs + t.numel()].view(t.shape).to(t.dtype)
            ofs += t.numel()
    return out
