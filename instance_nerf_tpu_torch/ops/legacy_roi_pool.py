"""Legacy ROIPool, the two-stage classification path's RoI extractor
(PyTorch counterpart of ``instance_nerf_tpu.ops.legacy_roi_pool``).

The reference's semantics, kept verbatim:

* ``enlarge_roi_*``: extents scaled by ``1 + enlarge_scale`` about the center.
* rotated rois: a lattice of feature-voxel-spaced points in the roi's rotated
  frame, each sampled with the reference's 8-corner weighting (weight
  ``1 - |dx| |dy| |dz|`` against each floor / ceil corner, the eight weighted
  corners summed and divided by 8, times an in-bounds mask). It is not
  trilinear interpolation, and it is discontinuous at integer coordinates
  (there floor equals ceil and the sum is the corner itself).
* AABB rois: the integer crop ``[floor(lo / s), floor(hi / s)]``, whose
  lattice points are integers, so the weighting is the identity.
* ``pooling``: adaptive max-pool with kernel ``ceil(grid / out)`` and zero
  padding; ``interpolation``: trilinear resize to the output size with
  ``align_corners=True``.

The JAX package's semantics for its static shapes: a roi's lattice is masked
beyond its ``ceil(extent / stride)`` grid, which is clamped to
``G = max_grid`` cells, and an AABB crop reaching past the feature extent
samples zeros where the reference would truncate it (both documented
deviations of the JAX package).

Memory: the JAX function samples every roi at every level, ``(P, G^3, C)``
a level, then selects by ``level_ids``. Here each roi is sampled at its own
level only (the same output), in chunks of ``chunk`` rois (default
``roi_chunk``: about 2 GiB of sampling intermediates a chunk at ``G``), and
on the lattice cut to the level's largest roi grid ``G_l <= G``: the points
past a roi's grid are masked to zero and read by neither pool (the one
interpolation corner that can fall there has weight 0), so the cut changes
no value. Each roi's result depends on that roi alone, so the chunking
changes no bit.

``cos`` / ``sin`` of the rotation are taken in f64 and rounded to the rois'
dtype: CPU and card lanes then agree, and the lattice positions round as
the f32 math of the JAX package does up to those two roundings.
"""
from __future__ import annotations

from typing import Sequence

import torch

# bytes of sampling intermediates a lattice point holds per channel: the f32
# accumulator and product, the gathered corner (up to f32) and the pool's
# masked copy
_BYTES_PER_POINT_CHANNEL = 16
# and per point whatever the channels' count: positions, corners, indices
_BYTES_PER_POINT = 96


def roi_chunk(max_grid: int, channels: int, budget: int = 2 << 30) -> int:
    """Rois a chunk of ``legacy_roi_pool`` samples at once so that its
    intermediates stay under ``budget`` bytes."""
    per_roi = max_grid ** 3 * (channels * _BYTES_PER_POINT_CHANNEL + _BYTES_PER_POINT)
    return max(1, budget // per_roi)


def enlarge_roi_obb(rois: torch.Tensor, enlarge_scale: float) -> torch.Tensor:
    """``(..., 7)`` ``[cx, cy, cz, w, h, d, theta]``: extents times
    ``1 + enlarge_scale``."""
    return torch.cat([rois[..., :3], rois[..., 3:6] * (1.0 + enlarge_scale), rois[..., 6:]],
                     dim=-1)


def enlarge_roi_aabb(rois: torch.Tensor, enlarge_scale: float) -> torch.Tensor:
    """``(..., 6)`` corner-form AABBs enlarged about their centers."""
    extent = (rois[..., 3:] - rois[..., :3]) / 2 * (1.0 + enlarge_scale)
    offset = (rois[..., 3:] + rois[..., :3]) / 2
    return torch.cat([offset - extent, offset + extent], dim=-1)


def eight_corner_sample(feat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The reference's 8-corner weighted sampling.

    ``feat`` ``(W, L, H, C)`` one level, channels-last; ``pts`` ``(..., 3)``
    in feature-voxel coordinates. Returns ``(..., C)`` in the promoted dtype
    of the two; points out of bounds give exactly 0."""
    w, l, h, c = feat.shape
    size = torch.tensor([w, l, h], dtype=pts.dtype, device=pts.device) - 1.0
    in_bounds = torch.all((pts >= 0) & (pts <= size), dim=-1)
    flat = feat.reshape(-1, c)
    fns = (torch.floor(pts), torch.ceil(pts))
    acc = None
    for a in range(2):
        for b in range(2):
            for d in range(2):
                corner = torch.stack([fns[a][..., 0], fns[b][..., 1], fns[d][..., 2]], dim=-1)
                cc = torch.minimum(corner.clamp_min(0.0), size).to(torch.int32)
                idx = (cc[..., 0] * l + cc[..., 1]) * h + cc[..., 2]
                vals = flat[idx.reshape(-1).long()].reshape(*idx.shape, c)
                # weight 1 - |dx| |dy| |dz| against the UNCLIPPED corner
                scale = (torch.abs(pts[..., 0] - corner[..., 0])
                         * torch.abs(pts[..., 1] - corner[..., 1])
                         * torch.abs(pts[..., 2] - corner[..., 2]))
                term = vals * (1.0 - scale)[..., None]
                acc = term if acc is None else acc.add_(term)
                del vals, term
    acc = acc / 8.0
    return acc * in_bounds[..., None].to(acc.dtype)


def _adaptive_maxpool_masked(grid_feats: torch.Tensor, grid_size: torch.Tensor,
                             output_size: Sequence[int]) -> torch.Tensor:
    """The reference's adaptive max-pool (kernel ``ceil(gs / out)``, zero
    padding) on the static lattice: lattice cell ``j`` goes to output cell
    ``j // kernel`` where ``j < gs``.

    ``grid_feats`` ``(n, G, G, G, C)``; ``grid_size`` ``(n, 3)`` int;
    returns ``(n, o0, o1, o2, C)``."""
    n, g = grid_feats.shape[:2]
    dev = grid_feats.device
    out = torch.tensor(list(output_size), device=dev)
    kernel = torch.ceil(grid_size / out).to(torch.int32).clamp_min(1)  # (n, 3)
    j = torch.arange(g, device=dev)
    res = grid_feats
    for ax, o in enumerate(output_size):
        dim = 1 + ax
        k = kernel[:, ax, None]  # (n, 1)
        gs = grid_size[:, ax, None]
        cell = j[None, :] // k  # (n, G)
        valid = j[None, :] < gs
        view = [n] + [1] * (res.dim() - 1)
        view[dim] = g
        picked = []
        for i in range(o):
            sel = ((cell == i) & valid).reshape(view)
            picked.append(torch.where(sel, res, -torch.inf).amax(dim=dim))
        picked = torch.stack(picked, dim=dim)
        # a cell wholly past gs saw only padding zeros in the reference; a
        # cell partly past it has a zero in its max
        cells = torch.arange(o, device=dev)[None, :]
        partial = cells * k < gs  # (n, o)
        pad_zero = (cells + 1) * k > gs
        view[dim] = o
        res = torch.where(partial.reshape(view),
                          torch.where(pad_zero.reshape(view), picked.clamp_min(0.0), picked),
                          torch.zeros((), dtype=picked.dtype, device=dev))
    return res


def _trilinear_resize_ac(grid_feats: torch.Tensor, grid_size: torch.Tensor,
                         output_size: Sequence[int]) -> torch.Tensor:
    """``F.interpolate(mode='trilinear', align_corners=True)`` of each roi's
    valid ``grid_size`` sub-grid to ``output_size``: ``(n, G, G, G, C)`` ->
    ``(n, o0, o1, o2, C)``."""
    n, g = grid_feats.shape[:2]
    c = grid_feats.shape[-1]
    dev, dt = grid_feats.device, grid_feats.dtype
    coords = []
    for ax, o in enumerate(output_size):
        if o == 1:
            coords.append(torch.zeros((n, 1), dtype=dt, device=dev))
        else:
            m = grid_size[:, ax, None].to(dt)
            coords.append(torch.arange(o, dtype=dt, device=dev)[None, :] * (m - 1) / (o - 1))
    o0, o1, o2 = output_size
    pts = torch.stack(torch.broadcast_tensors(coords[0][:, :, None, None],
                                              coords[1][:, None, :, None],
                                              coords[2][:, None, None, :]), dim=-1)
    lo = torch.floor(pts)
    frac = pts - lo
    lo = lo.to(torch.int32).clamp(0, g - 1)
    hi = (lo + 1).clamp(0, g - 1)
    flat = grid_feats.reshape(n, g ** 3, c)

    def take(ix, iy, iz):
        idx = ((ix * g + iy) * g + iz).reshape(n, -1).long()
        return torch.gather(flat, 1, idx[..., None].expand(n, idx.shape[1], c)).reshape(
            n, o0, o1, o2, c)

    out = None
    for a, wa in ((lo[..., 0], 1 - frac[..., 0]), (hi[..., 0], frac[..., 0])):
        for b, wb in ((lo[..., 1], 1 - frac[..., 1]), (hi[..., 1], frac[..., 1])):
            for d, wd in ((lo[..., 2], 1 - frac[..., 2]), (hi[..., 2], frac[..., 2])):
                term = take(a, b, d) * (wa * wb * wd)[..., None]
                out = term if out is None else out + term
    return out


def legacy_roi_pool(
    level_feats: Sequence[torch.Tensor],  # per level (W_l, L_l, H_l, C), channels-last
    rois: torch.Tensor,  # (P, 7) OBB [center, extent, theta] or (P, 6) corner AABB
    level_ids: torch.Tensor,  # (P,) int
    spatial_scale: Sequence[int],  # per level voxel stride, e.g. (4, 8, 16, 32)
    output_size: tuple = (1, 1, 1),
    enlarge_scale: float = 0.2,
    extracting_type: str = "pooling",
    rotated: bool = True,
    max_grid: int = 32,
    chunk: int | None = None,
) -> torch.Tensor:
    """Fixed-shape legacy ROIPool -> ``(P, o0, o1, o2, C)``, each roi sampled
    at its level ``level_ids`` (clipped to the levels given)."""
    if extracting_type not in ("pooling", "interpolation"):
        raise NameError("Unknown feature_extracting_type")
    output_size = tuple(int(o) for o in output_size)
    p, g, dev = rois.shape[0], max_grid, rois.device
    c = level_feats[0].shape[-1]
    if chunk is None:
        chunk = roi_chunk(g, c)
    if rotated:
        er = enlarge_roi_obb(rois, enlarge_scale)
        ctr, ext, theta = er[:, :3], er[:, 3:6], er[:, 6]
    else:
        er = enlarge_roi_aabb(rois, enlarge_scale)
        theta = torch.zeros((p,), dtype=rois.dtype, device=dev)
    cth = torch.cos(theta.double()).to(rois.dtype)
    sth = torch.sin(theta.double()).to(rois.dtype)
    sel = level_ids.clamp(0, len(level_feats) - 1)
    out = torch.zeros((p, *output_size, c),
                      dtype=torch.promote_types(level_feats[0].dtype, rois.dtype), device=dev)
    pool = _adaptive_maxpool_masked if extracting_type == "pooling" else _trilinear_resize_ac
    for lvl, (feat, scale) in enumerate(zip(level_feats, spatial_scale)):
        feat = feat.contiguous()  # flattened once a level, not once a chunk
        idx = torch.nonzero(sel == lvl).flatten()
        if idx.numel() == 0:
            continue
        if rotated:
            gs = torch.ceil(ext[idx] / scale).to(torch.int32)
            origin = ctr[idx] / scale  # positions centered on the roi
        else:
            lo_i = torch.floor(er[idx, :3] / scale)
            hi_i = torch.floor(er[idx, 3:] / scale)
            gs = (hi_i - lo_i + 1).to(torch.int32)
            origin = lo_i
        gs = gs.clamp_min(1).clamp(1, g)
        gl = int(gs.max())  # the level's lattice: every roi's grid fits in it
        ar = torch.arange(gl, dtype=rois.dtype, device=dev)
        lat = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
        for s in range(0, idx.shape[0], chunk):
            part = slice(s, s + chunk)
            gs_c = gs[part]
            if rotated:
                # pos = R (lattice - (gs - 1) / 2) + center / scale
                pos = lat[None] - (gs_c.to(lat.dtype)[:, None, :] - 1.0) / 2.0
                ct, st = cth[idx[part], None], sth[idx[part], None]
                rx = ct * pos[..., 0] - st * pos[..., 1]
                ry = st * pos[..., 0] + ct * pos[..., 1]
                pos = torch.stack([rx, ry, pos[..., 2]], dim=-1) + origin[part, None, :]
            else:
                pos = lat[None] + origin[part, None, :]
            vals = eight_corner_sample(feat, pos)  # (n, G^3, C)
            inside = torch.all(lat[None] < gs_c.to(lat.dtype)[:, None, :], dim=-1)
            vals = vals * inside[..., None].to(vals.dtype)
            out[idx[part]] = pool(vals.reshape(-1, gl, gl, gl, c), gs_c, output_size)
            del pos, vals, inside
    return out
