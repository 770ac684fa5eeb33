"""Volumetric rendering: rays, occupancy, fixed-K compaction, compositing
(PyTorch counterpart of ``instance_nerf_tpu.models.render``).

Occupancy skipping follows the JAX package: a fixed number of samples per
ray, the occupancy of each looked up in a dense grid, and with
``k_occupied`` only the first K occupied samples of each ray (depth order
kept) go through the field. Compositing is a ``cumprod`` over the sample
axis; instance logits composite through detached weights.

Random draws: JAX's threefry streams cannot be reproduced, so
``sample_points`` and ``update_occupancy`` take a ``torch.Generator`` or
the uniform draws themselves (``jitter``), which the parity tests take
from JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from instance_nerf_tpu_torch.models.hashgrid import density_activation
from instance_nerf_tpu_torch.ops.nms import no_stage


def camera_rays(c2w: torch.Tensor, intrinsics, hw, pixel_idx=None):
    """Rays ``(origins (R, 3), unit dirs (R, 3))`` for pixels of a pinhole
    camera; ``c2w`` (4, 4) or (3, 4) camera-to-world (OpenGL: -z forward),
    ``intrinsics`` (fx, fy, cx, cy), ``pixel_idx`` optional flat pixel ids."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    h, w = hw
    if pixel_idx is None:
        pixel_idx = torch.arange(h * w, device=c2w.device)
    py = (pixel_idx // w).to(torch.float32) + 0.5
    px = (pixel_idx % w).to(torch.float32) + 0.5
    dirs = torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], dim=-1)
    d = dirs @ c2w[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand(d.shape), d


def ray_aabb(o, d, lo=0.0, hi=1.0, eps=1e-9):
    """Near/far of rays against the cube [lo, hi]^3; misses get near > far."""
    small = torch.where(d < 0, torch.full_like(d, -eps), torch.full_like(d, eps))
    inv = 1.0 / torch.where(torch.abs(d) < eps, small, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


class OccupancyGrid(NamedTuple):
    """Dense density cache over the unit cube (torch-ngp's bitfield)."""

    grid: torch.Tensor  # (G, G, G) float density EMA
    threshold: float

    @property
    def res(self):
        return self.grid.shape[0]

    def occupied(self, xyz):
        """(..., 3) in [0, 1] -> (...,) {0, 1}: ONE flat gather from the
        raveled grid at the truncated, clipped cell."""
        g = self.res
        grid = torch.as_tensor(self.grid, device=xyz.device)  # numpy after a load
        idx = torch.clamp((xyz * g).to(torch.int32), 0, g - 1).to(torch.int64)
        fi = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
        vals = grid.reshape(-1)[fi]
        return (vals > self.threshold).to(xyz.dtype)


def init_occupancy(res: int = 128, threshold: float = 0.01, device="cpu") -> OccupancyGrid:
    # start fully occupied so early training sees everything
    return OccupancyGrid(torch.full((res, res, res), 1e3, device=device), threshold)


def coarse_grid(occ: OccupancyGrid, coarse_res: int) -> torch.Tensor:
    """The occupancy max-pooled to ``coarse_res``^3 (a coarse cell is
    occupied if ANY fine cell under it is), as bool."""
    g = occ.res
    f = g // coarse_res
    grid = torch.as_tensor(occ.grid)
    pooled = grid.reshape(coarse_res, f, coarse_res, f, coarse_res, f).amax(dim=(1, 3, 5))
    return pooled > occ.threshold


def coarse_cells(xyz: torch.Tensor, coarse_res: int) -> torch.Tensor:
    """``(N, 3)`` int32 coarse cell of each point of ``xyz (..., 3)``."""
    p = torch.clamp(xyz.reshape(-1, 3) * coarse_res, 0, coarse_res - 1)
    return p.to(torch.int32)


def coarse_occupancy_mxu(occ: OccupancyGrid, xyz, coarse_res: int = 32):
    """Conservative two-stage occupancy: the max-pooled coarse grid looked
    up at each point's coarse cell -> (...,) {0, 1}. The JAX package
    evaluates the lookup as one-hot einsums on the MXU (no gathers); the
    values are 0 and 1, so the direct lookup here is the same function.
    Kernel B5 (``kernels/coarse_occ_cuda.py``) computes the lookup too; like
    the JAX package, the renderer does not route through it."""
    coarse = coarse_grid(occ, coarse_res).to(xyz.device)
    ci = coarse_cells(xyz, coarse_res).to(torch.int64)
    vals = coarse[ci[:, 0], ci[:, 1], ci[:, 2]]
    return vals.to(xyz.dtype).reshape(xyz.shape[:-1])


def occupancy_cells(res: int, device) -> torch.Tensor:
    """``(res^3, 3)`` integer cell ids in C order."""
    ax = torch.arange(res, device=device)
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)


def update_occupancy(occ: OccupancyGrid, sigma_fn, generator=None, jitter=None,
                     decay: float = 0.95, chunk: int = 2 ** 18) -> OccupancyGrid:
    """EMA-decay + re-sample density at jittered cell centers
    (torch-ngp's update_extra_state schedule). ``jitter`` is the
    ``(G^3, 3)`` uniform draw, else drawn from ``generator``."""
    g = occ.res
    grid = torch.as_tensor(occ.grid)
    cells = occupancy_cells(g, grid.device)
    if jitter is None:
        jitter = torch.rand(cells.shape, generator=generator, device=grid.device)
    xyz = (cells.to(torch.float32) + jitter) / g
    sig = torch.cat([sigma_fn(xyz[i:i + chunk]) for i in range(0, xyz.shape[0], chunk)])
    return OccupancyGrid(torch.maximum(grid * decay, sig.reshape(g, g, g).float()),
                         occ.threshold)


class RenderOut(NamedTuple):
    rgb: torch.Tensor  # (R, 3)
    depth: torch.Tensor  # (R,)
    acc: torch.Tensor  # (R,) accumulated opacity
    instance_logits: torch.Tensor  # (R, I) composited logits
    weights: torch.Tensor  # (R, S)


def bin_edges(n_samples: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, S + 1)`` in f32, bit for bit: ``iota / S``,
    which XLA computes as ``iota * f32(1 / S)``, and the endpoint 1."""
    recip = float(np.float32(1.0) / np.float32(n_samples))
    u = torch.arange(n_samples, dtype=torch.float32, device=device) * recip
    return torch.cat([u, torch.ones(1, device=device)])


def sample_points(o, d, n_samples: int, near, far, stratified: bool = True,
                  per_ray_jitter: bool = False, generator=None, jitter=None):
    """Stratified fixed-count samples in [near, far] -> (xyz (R, S, 3),
    t (R, S), dt (R, S)). ``per_ray_jitter``: ONE uniform offset per ray for
    all its bins. ``jitter`` ((R, S) or (R, 1) uniforms) overrides the draw
    from ``generator``."""
    r = o.shape[0]
    u = bin_edges(n_samples, o.device)
    lo_u, hi_u = u[:-1], u[1:]
    if stratified:
        if jitter is None:
            shape = (r, 1) if per_ray_jitter else (r, n_samples)
            jitter = torch.rand(shape, generator=generator, device=o.device)
    else:
        jitter = 0.5
    tt = lo_u[None] + (hi_u - lo_u)[None] * jitter  # (R, S) in [0, 1]
    span = torch.clamp(far - near, min=1e-6)[:, None]
    t = near[:, None] + tt * span
    dt = span / n_samples
    xyz = o[:, None, :] + t[..., None] * d[:, None, :]
    return xyz, t, dt.expand(t.shape)


def composite(sigma_raw, rgb, inst_logits, t, dt, occ_mask=None, valid=None) -> RenderOut:
    """Alpha compositing; instance logits composite like color, through
    DETACHED weights, with the residual transmittance credited to the
    background class (index 0) as +10."""
    sigma = density_activation(sigma_raw)
    if occ_mask is not None:
        sigma = sigma * occ_mask
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alpha * trans  # (R, S)
    if valid is not None:
        weights = weights * valid[:, None]
    out_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t, dim=-1)
    acc = torch.sum(weights, dim=-1)
    if inst_logits is not None:
        w_sg = weights.detach()
        out_inst = torch.sum(w_sg[..., None] * inst_logits, dim=-2)
        bg = torch.zeros(out_inst.shape[-1], device=out_inst.device)
        bg[0] = 10.0
        residual = 1.0 - torch.sum(w_sg, dim=-1, keepdim=True)
        out_inst = out_inst + torch.clamp(residual, min=0.0) * bg
    else:
        out_inst = torch.zeros((*acc.shape, 0), device=acc.device)
    return RenderOut(out_rgb, depth, acc, out_inst, weights)


def _compact_inputs(origins, dirs, t, dt, occ_all, occ, k: int, use_fine_mask: bool):
    """Fixed-K occupancy compaction: the first K occupied samples of each
    ray, depth order kept, then unoccupied ones. The sort keys
    ``(occupied ? 0 : S) + sample id`` are unique, so the top-k is exact and
    its low bits are the sample ids. Returns (xyz_k, vd, t_k, dt_k, keep_f,
    s_idx)."""
    s = occ_all.shape[-1]
    iota = torch.arange(s, device=occ_all.device)[None]
    sort_key = torch.where(occ_all > 0, 0, s) + iota
    vals = -torch.topk(-sort_key, k, dim=1).values  # (R, K) ascending
    keep = vals < s
    s_idx = torch.where(keep, vals, vals - s)
    t_k = torch.gather(t, 1, s_idx)
    xyz_k = torch.clamp(origins[:, None, :] + t_k[..., None] * dirs[:, None, :], 0.0, 1.0)
    dt_k = dt[:, :1].expand(t_k.shape)
    keep_f = keep.to(t.dtype)
    if use_fine_mask:
        # fine-grid mask on just the K compacted samples
        keep_f = keep_f * occ.occupied(xyz_k)
    vd = dirs[:, None, :].expand(xyz_k.shape)
    return xyz_k, vd, t_k, dt_k, keep_f, s_idx


def _compact_render(model_apply, origins, dirs, t, dt, occ_all, occ, k: int,
                    with_instance, valid, use_fine_mask: bool, stage=no_stage) -> RenderOut:
    """Fixed-K compaction + field query + composite."""
    with stage("compact"):
        xyz_k, vd, t_k, dt_k, keep_f, _ = _compact_inputs(
            origins, dirs, t, dt, occ_all, occ, k, use_fine_mask)
    sigma_raw, rgb, logits = model_apply(xyz_k, vd)
    with stage("composite_loss"):
        return composite(sigma_raw, rgb, logits if with_instance else None,
                         t_k, dt_k, keep_f, valid.to(t.dtype))


def render_rays(model_apply, origins, dirs, n_samples: int = 128,
                occ: OccupancyGrid | None = None, stratified: bool = True,
                with_instance: bool = True, k_occupied: int | None = None,
                occ_coarse_res: int | None = None, k_buckets: tuple | None = None,
                ray_jitter: bool = False, generator=None, jitter=None,
                stage=no_stage) -> RenderOut:
    """Full render: AABB clip -> stratified samples -> occupancy -> (fixed-K
    compaction) -> field query -> composite. ``model_apply(xyz, viewdir)``
    returns (sigma_raw, rgb, instance_logits or None).

    ``k_occupied``: of the ``n_samples`` candidates only the first K
    occupied per ray are queried. ``occ_coarse_res``: the candidates are
    selected on the max-pooled coarse grid and the fine grid masks the K
    compacted samples. ``stage(name)`` opens the ``occupancy``, ``compact``
    and ``composite_loss`` spans."""
    if k_buckets and occ is not None:
        raise NotImplementedError(
            "adaptive-K routing (k_buckets) comes with slice 6 (ROADMAP queue A)")
    with stage("occupancy"):
        near, far = ray_aabb(origins, dirs)
        valid = far > near
        far = torch.maximum(far, near + 1e-4)
        xyz, t, dt = sample_points(origins, dirs, n_samples, near, far, stratified,
                                   per_ray_jitter=ray_jitter, generator=generator,
                                   jitter=jitter)
        xyz_c = torch.clamp(xyz, 0.0, 1.0)
        use_coarse = (occ_coarse_res is not None and occ is not None
                      and occ_coarse_res < occ.res)
        compact = k_occupied is not None and occ is not None and k_occupied < n_samples
        if compact:
            if use_coarse:
                occ_all = coarse_occupancy_mxu(occ, xyz_c, occ_coarse_res)
            else:
                occ_all = occ.occupied(xyz_c)  # (R, S)
    if compact:
        return _compact_render(model_apply, origins, dirs, t, dt, occ_all, occ,
                               k_occupied, with_instance, valid, use_coarse, stage)
    vd = dirs[:, None, :].expand(xyz.shape)
    sigma_raw, rgb, logits = model_apply(xyz_c, vd)
    with stage("composite_loss"):
        occ_mask = occ.occupied(xyz_c) if occ is not None else None
        return composite(sigma_raw, rgb, logits if with_instance else None,
                         t, dt, occ_mask, valid.to(xyz.dtype))
