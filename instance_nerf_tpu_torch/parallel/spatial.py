"""The mesh's spatial axis: the voxel W axis of every tensor of a detector's
forward split over the ``sp`` ranks of a ``parallel/mesh.py`` mesh.

The JAX package puts its grids on ``grid_sharding`` and lets GSPMD insert
the halo exchanges and the cross-device statistics. Here they are written
out:

- ``WLayout``: a global W of ``size`` rows over ``parts`` ranks in GSPMD's
  blocks, ``ceil(size / parts)`` rows a rank and what is left on the last
  ones, which may be none (``size = 5`` over 4 ranks: 2, 2, 1, 0). Every
  tensor of the forward is in the block layout of its own global W: a
  strided layer's output in that of ``ceil(W / stride)`` rows, whichever
  input rows its rows need. No level is gathered onto every rank: a rank
  with no rows runs every layer on empty tensors and takes part in every
  exchange, so each rank's backward meets the same exchanges in the same
  order.
- ``exchange``: the differentiable fetch of global rows ``[a, b)`` (several
  ranges, possibly outside ``[0, W)``, where they read ``fill``) from the
  ranks that own them. Its backward sends each fetched row's gradient back
  to its owner, which adds it to its own. Under NCCL the rows go through
  ``batch_isend_irecv``; gloo's point-to-point calls take host tensors
  only, so there the rows of a CUDA tensor are staged through the host.
- ``sum_over``: the differentiable SUM over the ``sp`` group (a
  normalisation's statistics); its backward SUMs the gradient the same way.
- ``max_over`` and ``gather_over``: a MAX over the ``sp`` group and the
  ranks' blocks concatenated in rank order, without gradient (the anchor
  RPN's targets: each gt's best anchor and the sampler's labels over the
  whole scene). Under gloo a CUDA tensor goes through the host, as the
  halos do; a rank outside the layout's group raises.
- ``window_rows``: the input rows each rank's output rows of a SAME window
  op (conv, pool) need, pads taken from the global size.

The layers (``models/layers.py``, ``models/swin.py``) take a ``layout`` and
use these; without one they are the one-card code, unchanged. FCOS's loss
needs no exchange: each rank's locations carry their global coordinates
(``models/fcos.py:compute_locations``) and its partial numerators divide
by normalisers summed over the world, so the ranks' losses and gradients
add up to the global batch's. The anchor RPN's targets are not local (a
gt's low-quality matches and the balanced sampler range over the whole
scene's anchors), so ``models/rpn.py:rpn_loss`` takes them over the group
with ``max_over`` and ``gather_over``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from instance_nerf_tpu_torch.train.timing import NO_STAGES


def same_pads(size: int, kernel: int, stride: int):
    """flax ``padding="SAME"``: ``(lo, hi)`` with ``total = max((out - 1) *
    stride + kernel - size, 0)``, ``lo = total // 2``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def blocks(size: int, parts: int) -> list:
    """GSPMD's blocks of ``size`` rows over ``parts``: ``[(lo, hi)]`` a part,
    ``ceil(size / parts)`` rows each, the last ones short or empty."""
    per = -(-size // parts)
    return [(min(q * per, size), min((q + 1) * per, size)) for q in range(parts)]


class WLayout(NamedTuple):
    """A global W of ``size`` rows in ``blocks(size, parts)``; this rank holds
    block ``index``. ``ranks`` are the global ranks of the ``sp`` group by
    index, ``group`` the group itself; ``stage(name)`` opens the span
    ``halo`` around each exchange; ``stats`` (a dict, or None) counts the
    ``bytes`` this rank's exchanges send, forward and backward, and the
    ``exchanges`` that move any."""

    size: int
    parts: int
    index: int
    group: object = None
    ranks: tuple = ()
    stage: object = NO_STAGES
    stats: dict | None = None

    @property
    def owned(self) -> list:
        return blocks(self.size, self.parts)

    @property
    def lo(self) -> int:
        return self.owned[self.index][0]

    @property
    def hi(self) -> int:
        return self.owned[self.index][1]

    def resized(self, size: int) -> "WLayout":
        return self._replace(size=int(size))

    def strided(self, stride: int) -> "WLayout":
        """The layout of a SAME window op's output: ``ceil(size / stride)``."""
        return self.resized(-(-self.size // stride))

    def take(self, x: torch.Tensor, dim: int = 1):
        """This rank's rows of a whole tensor (W at ``dim``)."""
        return x.narrow(dim, self.lo, self.hi - self.lo)


def window_rows(layout: WLayout, kernel: int, stride: int):
    """A SAME window op along W: (the output's layout, each rank's input
    rows ``((a, b),)`` for its output rows, or ``()`` for none). Rows
    outside ``[0, size)`` are the op's padding."""
    out = layout.strided(stride)
    pad = same_pads(layout.size, kernel, stride)[0]
    want = tuple(((lo * stride - pad, (hi - 1) * stride - pad + kernel),) if hi > lo else ()
                 for lo, hi in out.owned)
    return out, want


def wrapped(a: int, b: int, n: int) -> tuple:
    """Rows ``[a, b)`` of a cyclic axis of ``n`` (``b - a <= n``) as plain
    ranges of ``[0, n)``."""
    if b <= a:
        return ()
    a0 = a % n
    b0 = a0 + (b - a)
    return ((a0, b0),) if b0 <= n else ((a0, n), (0, b0 - n))


def _plan(owned: Sequence, want: Sequence, size: int, me: int):
    """What an exchange moves: ``pieces`` (this rank's output in order:
    ``(q, lo, hi)`` global rows owned by rank ``q``, or ``(None, lo, hi)``
    rows outside ``[0, size)``) and ``sends`` (``q -> [(lo, hi)]`` of this
    rank's rows that rank ``q`` takes, in its order)."""
    def split(a, b):
        out = []
        if a < min(b, 0):
            out.append((None, a, min(b, 0)))
        for q, (lo, hi) in enumerate(owned):
            s, e = max(a, lo, 0), min(b, hi, size)
            if e > s:
                out.append((q, s, e))
        if b > max(a, size):
            out.append((None, max(a, size), b))
        return out

    pieces = [p for a, b in want[me] for p in split(a, b)]
    sends = {}
    for q, ranges in enumerate(want):
        if q != me:
            rows = [(s, e) for a, b in ranges for r, s, e in split(a, b) if r == me]
            if rows:
                sends[q] = rows
    return pieces, sends


def _via_host(x: torch.Tensor, layout: WLayout) -> bool:
    """A CUDA tensor goes through the host on a gloo group."""
    return x.is_cuda and dist.get_backend(layout.group) == "gloo"


def _p2p(layout: WLayout, sends: dict, recv_shapes: dict, like: torch.Tensor) -> dict:
    """Send ``sends[q]`` to rank ``q`` and receive ``recv_shapes[q]`` from
    it, all at once; returns the received tensors on ``like``'s device."""
    stage_host = _via_host(like, layout)
    stats = layout.stats if layout.stats is not None else {}
    ops, out = [], {}
    for q, t in sends.items():
        t = t.contiguous()
        if stage_host:
            t = t.cpu()
        stats["bytes"] = stats.get("bytes", 0) + t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, layout.ranks[q], layout.group))
    for q, shape in recv_shapes.items():
        out[q] = torch.empty(shape, dtype=like.dtype,
                             device="cpu" if stage_host else like.device)
        ops.append(dist.P2POp(dist.irecv, out[q], layout.ranks[q], layout.group))
    if ops:
        stats["exchanges"] = stats.get("exchanges", 0) + 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {q: t.to(like.device) for q, t in out.items()}


def _rows(x, lo, n):
    return x.narrow(1, lo, n)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, owned, want, size, fill):
        me = layout.index
        pieces, sends = _plan(owned, want, size, me)
        base = owned[me][0]
        ctx.layout, ctx.pieces, ctx.sends, ctx.base = layout, pieces, sends, base
        ctx.x_shape = x.shape
        with layout.stage("halo"):
            recv_rows = {}
            for q, lo, hi in pieces:
                if q is not None and q != me:
                    recv_rows[q] = recv_rows.get(q, 0) + hi - lo
            got = _p2p(layout,
                       {q: torch.cat([_rows(x, s - base, e - s) for s, e in rows], 1)
                        for q, rows in sends.items()},
                       {q: (x.shape[0], n, *x.shape[2:]) for q, n in recv_rows.items()}, x)
            parts, used = [], {q: 0 for q in got}
            for q, lo, hi in pieces:
                if q is None:
                    parts.append(x.new_full((x.shape[0], hi - lo, *x.shape[2:]), fill))
                elif q == me:
                    parts.append(_rows(x, lo - base, hi - lo))
                else:
                    parts.append(_rows(got[q], used[q], hi - lo))
                    used[q] += hi - lo
            if not parts:
                return x.new_empty((x.shape[0], 0, *x.shape[2:]))
            return torch.cat(parts, 1) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, grad):
        layout, pieces, sends, base = ctx.layout, ctx.pieces, ctx.sends, ctx.base
        me = layout.index
        grad_x = grad.new_zeros(ctx.x_shape)
        with layout.stage("halo"):
            back, ofs = {}, 0
            for q, lo, hi in pieces:
                g = _rows(grad, ofs, hi - lo)
                if q == me:
                    _rows(grad_x, lo - base, hi - lo).add_(g)
                elif q is not None:
                    back.setdefault(q, []).append(g)
                ofs += hi - lo
            got = _p2p(layout, {q: torch.cat(v, 1) for q, v in back.items()},
                       {q: (grad.shape[0], sum(e - s for s, e in rows), *grad.shape[2:])
                        for q, rows in sends.items()}, grad)
            for q, rows in sends.items():
                ofs = 0
                for s, e in rows:
                    _rows(grad_x, s - base, e - s).add_(_rows(got[q], ofs, e - s))
                    ofs += e - s
        return grad_x, None, None, None, None, None


def exchange(x: torch.Tensor, layout: WLayout, want: Sequence, fill: float = 0.0,
             owned: Sequence | None = None, size: int | None = None) -> torch.Tensor:
    """This rank's rows ``want[layout.index]`` (``[(a, b)]`` global rows,
    concatenated in order along dim 1) of a tensor whose rows ``owned[q]``
    (default: ``layout``'s blocks) lie on rank ``q``; rows outside ``[0,
    size)`` (default ``layout.size``) are ``fill``. ``want`` holds every
    rank's ranges: each rank sends what the others take. Differentiable:
    the backward returns each row's gradient to its owner."""
    owned = tuple(layout.owned if owned is None else owned)
    size = layout.size if size is None else size
    return _Exchange.apply(x, layout, owned, tuple(tuple(w) for w in want), size, fill)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        out = x.clone().contiguous()
        dist.all_reduce(out, group=layout.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone().contiguous()
        dist.all_reduce(grad, group=ctx.layout.group)
        return grad, None


def sum_over(x: torch.Tensor, layout: WLayout) -> torch.Tensor:
    """The SUM of ``x`` over the ``sp`` group, differentiable (the gradient
    summed over the group too)."""
    return _SumOver.apply(x, layout)


def _member(layout: WLayout) -> None:
    """Raise unless this process is rank ``layout.index`` of the layout's
    group: a collective over ``sp`` has no route around the group."""
    if not dist.is_initialized() or layout.group is None:
        raise RuntimeError("a collective over the sp ranks needs the layout's process group")
    if layout.ranks and layout.ranks[layout.index] != dist.get_rank():
        raise RuntimeError(f"rank {dist.get_rank()} is not rank {layout.index} of the sp "
                           f"group {layout.ranks}")


@torch.no_grad()
def max_over(x: torch.Tensor, layout: WLayout) -> torch.Tensor:
    """The elementwise MAX of ``x`` over the ``sp`` group (no gradient)."""
    _member(layout)
    out = (x.cpu() if _via_host(x, layout) else x).clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=layout.group)
    return out.to(x.device)


@torch.no_grad()
def gather_over(x: torch.Tensor, layout: WLayout, dim: int,
                sizes: Sequence[int]) -> torch.Tensor:
    """The ``sp`` ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient). Rank ``q``'s block is ``sizes[q]`` long along ``dim``: the
    blocks may differ in length, or be empty."""
    _member(layout)
    t = (x.cpu() if _via_host(x, layout) else x).movedim(dim, 0).contiguous()
    sizes = [int(s) for s in sizes]
    if sizes[layout.index] != t.shape[0]:
        raise ValueError(f"block of {t.shape[0]} rows, sizes say {sizes[layout.index]}")
    top = max(sizes)
    if t.shape[0] < top:
        t = torch.cat([t, t.new_zeros((top - t.shape[0], *t.shape[1:]))])
    got = [torch.empty_like(t) for _ in sizes]
    dist.all_gather(got, t, group=layout.group)
    out = torch.cat([g[:s] for g, s in zip(got, sizes)])
    return out.movedim(0, dim).to(x.device)


def empty_rows(shape, like: torch.Tensor, *connect) -> torch.Tensor:
    """A tensor of ``shape`` with no rows (a layer's output on a rank that
    owns none of its rows), in ``like``'s dtype, joined to the autograd
    graph of ``connect`` so that the backward reaches the exchanges before
    it on every rank."""
    out = like.new_zeros(shape)
    for t in connect:
        if t is not None:
            out = out + t.reshape(-1)[:0].sum().to(out.dtype)
    return out


def grid_layout(mesh, size: int, stage=None) -> WLayout | None:
    """The layout of a W-split grid of ``size`` rows on ``mesh``'s ``sp``
    axis, counting its exchanges in ``mesh.halo``; None without a process
    group, for ``sp = 1`` or on an idle rank (the one-card code). Raises
    where ``sp`` does not divide ``size`` (``split_size``)."""
    if (mesh is None or mesh.n_spatial == 1 or not mesh.active or mesh.sp_group is None
            or not dist.is_initialized()):
        return None
    split_size(size, mesh.n_spatial)
    ranks = tuple(r for r, c in enumerate(mesh.coords) if c[:2] == mesh.coord[:2])
    return WLayout(int(size), mesh.n_spatial, mesh.sp_index, mesh.sp_group, ranks,
                   stage or NO_STAGES, mesh.halo)


def split_size(size: int, parts: int) -> int:
    """Rows a rank takes of a host grid of W ``size`` over ``parts``, which
    must divide it (as JAX's ``device_put`` on ``grid_sharding`` requires)."""
    if size % parts:
        raise ValueError(f"a grid of W {size} does not divide over {parts} spatial ranks")
    return size // parts

