"""Volumetric rendering: rays, occupancy, fixed-K compaction, compositing
(PyTorch counterpart of ``instance_nerf_tpu.models.render``).

Occupancy skipping follows the JAX package: a fixed number of samples per
ray, the occupancy of each looked up in a dense grid, and with
``k_occupied`` only the first K occupied samples of each ray (depth order
kept) go through the field. Compositing is a ``cumprod`` over the sample
axis; instance logits composite through detached weights. On the card it is
kernel B9 (``kernels/composite_cuda.py``), one launch each way.

Random draws: JAX's threefry streams cannot be reproduced, so
``sample_points`` and ``update_occupancy`` take a ``torch.Generator`` or
the uniform draws themselves (``jitter``), which the parity tests take
from JAX.

A fleet of scenes renders in one call: rays ``(B, R, 3)``, an occupancy
grid ``(B, G, G, G)`` and a field that takes ``(B, ..., 3)`` points. Every
function below keeps the leading scene axis; the JAX package gets the same
from ``vmap``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from instance_nerf_tpu_torch.kernels import composite_cuda
from instance_nerf_tpu_torch.models.hashgrid import density_activation
from instance_nerf_tpu_torch.train.timing import NO_STAGES


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

    grid: torch.Tensor  # (G, G, G) float density EMA, or a fleet's (B, G, G, G)
    threshold: float

    @property
    def res(self):
        return self.grid.shape[-1]

    def occupied(self, xyz):
        """(..., 3) in [0, 1] -> (...,) {0, 1}: ONE flat gather from the
        raveled grid at the truncated, clipped cell. A fleet's grid takes
        ``xyz (B, ..., 3)``, scene b looked up in grid b."""
        g = self.res
        grid = torch.as_tensor(self.grid, device=xyz.device)  # numpy after a load
        idx = torch.clamp((xyz * g).to(torch.int32), 0, g - 1).to(torch.int64)
        fi = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
        vals = grid.reshape(-1)[_scene_offset(fi, grid.shape[:-3], g ** 3)]
        return (vals > self.threshold).to(xyz.dtype)


def _scene_offset(flat: torch.Tensor, scenes, size: int) -> torch.Tensor:
    """Flat cell ids ``(B, ...)`` of per-scene grids of ``size`` cells ->
    ids into the B grids raveled together; unchanged for one grid."""
    if not scenes:
        return flat
    b = scenes[0]
    off = torch.arange(b, device=flat.device) * size
    return flat + off.view(b, *([1] * (flat.dim() - 1)))


def init_occupancy(res: int = 128, threshold: float = 0.01, device="cpu") -> OccupancyGrid:
    # start fully occupied so early training sees everything
    return OccupancyGrid(torch.full((res, res, res), 1e3, device=device), threshold)


def coarse_grid(occ: OccupancyGrid, coarse_res: int) -> torch.Tensor:
    """The occupancy max-pooled to ``coarse_res``^3 (a coarse cell is
    occupied if ANY fine cell under it is), as bool."""
    g = occ.res
    f = g // coarse_res
    grid = torch.as_tensor(occ.grid)
    lead = grid.shape[:-3]
    pooled = grid.reshape(*lead, coarse_res, f, coarse_res, f, coarse_res, f).amax(
        dim=(-5, -3, -1))
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
    fi = ((ci[:, 0] * coarse_res + ci[:, 1]) * coarse_res + ci[:, 2]).view(xyz.shape[:-1])
    vals = coarse.reshape(-1)[_scene_offset(fi, coarse.shape[:-3], coarse_res ** 3)]
    return vals.to(xyz.dtype)


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


def choose_k_buckets(hits, ks=(2, 4, 8), quant: int = 16):
    """The ``k_buckets`` ladder from a measured per-ray hit histogram
    (``hits`` (R,), the statistic ``render_rays`` routes by): bucket i takes
    the share of rays with ``hits <= ks[i]`` not yet covered, rounded DOWN
    to a multiple of 1/``quant`` (borderline rays go to a bigger K, and at
    most ``quant^(len(ks)-1)`` ladders exist); the last K takes the rest.
    Returns ``((frac, k), ...)`` for ``NGPConfig.k_buckets``."""
    h = np.asarray(hits, np.float64).reshape(-1)
    if h.size == 0:
        raise ValueError("choose_k_buckets needs a non-empty hits sample")
    fracs, acc = [], 0.0
    for k in ks[:-1]:
        f = max(float((h <= k).mean()) - acc, 0.0)
        f = np.floor(f * quant) / quant
        fracs.append(f)
        acc += f
    fracs.append(round(1.0 - acc, 6))
    return tuple((float(f), int(k)) for f, k in zip(fracs, ks) if f > 0)


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
    """Stratified fixed-count samples in [near, far] -> (xyz (..., R, S, 3),
    t (..., R, S), dt (..., R, S)). ``per_ray_jitter``: ONE uniform offset
    per ray for all its bins. ``jitter`` ((..., R, S) or (..., R, 1)
    uniforms) overrides the draw from ``generator``."""
    rays = o.shape[:-1]
    u = bin_edges(n_samples, o.device)
    lo_u, hi_u = u[:-1], u[1:]
    if stratified:
        if jitter is None:
            shape = (*rays, 1) if per_ray_jitter else (*rays, n_samples)
            jitter = torch.rand(shape, generator=generator, device=o.device)
    else:
        jitter = 0.5
    tt = lo_u + (hi_u - lo_u) * jitter  # (..., R, S) in [0, 1]
    span = torch.clamp(far - near, min=1e-6)[..., None]
    t = near[..., None] + tt * span
    dt = span / n_samples
    xyz = o[..., None, :] + t[..., None] * d[..., None, :]
    return xyz, t, dt.expand(t.shape)


def composite(sigma_raw, rgb, inst_logits, t, dt, occ_mask=None, valid=None,
              stage=NO_STAGES) -> RenderOut:
    """Alpha compositing; instance logits composite like color, through
    DETACHED weights, with the residual transmittance credited to the
    background class (index 0) as +10. CPU tensors run ``composite_plain``;
    any other device kernel B9 (``kernels/composite_cuda.py:composite``),
    which raises off CUDA and on inputs it does not take, and reads nothing
    back to the host (``stage`` opens no wait)."""
    if sigma_raw.device.type == "cpu":
        return composite_plain(sigma_raw, rgb, inst_logits, t, dt, occ_mask, valid, stage)
    return RenderOut(*composite_cuda.composite(sigma_raw, rgb, inst_logits, t, dt, occ_mask,
                                               valid))


def composite_plain(sigma_raw, rgb, inst_logits, t, dt, occ_mask=None, valid=None,
                    stage=NO_STAGES) -> RenderOut:
    """``composite`` as a chain of PyTorch operations (the CPU's path). The
    backward of ``cumprod`` reads whether any factor is 0 back to the host:
    ``stage`` opens a ``wait`` span around it."""
    sigma = density_activation(sigma_raw)
    if occ_mask is not None:
        sigma = sigma * occ_mask
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = stage.wait_in_backward(torch.cumprod(1.0 - alpha + 1e-10, dim=-1))
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans  # (..., R, S)
    if valid is not None:
        weights = weights * valid[..., None]
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
    s_idx, keep = _first_occupied(occ_all, k)
    t_k = torch.gather(t, -1, s_idx)
    xyz_k = torch.clamp(origins[..., None, :] + t_k[..., None] * dirs[..., None, :], 0.0, 1.0)
    dt_k = dt[..., :1].expand(t_k.shape)
    keep_f = keep.to(t.dtype)
    if use_fine_mask:
        # fine-grid mask on just the K compacted samples
        keep_f = keep_f * occ.occupied(xyz_k)
    vd = dirs[..., None, :].expand(xyz_k.shape)
    return xyz_k, vd, t_k, dt_k, keep_f, s_idx


def _first_occupied(occ_all, k: int):
    """Sample ids ``(..., R, K)`` of the first K occupied samples of each
    ray in depth order, then unoccupied ones, and whether each is
    occupied."""
    s = occ_all.shape[-1]
    iota = torch.arange(s, device=occ_all.device)
    sort_key = torch.where(occ_all > 0, 0, s) + iota
    vals = -torch.topk(-sort_key, k, dim=-1).values  # (..., R, K) ascending
    keep = vals < s
    return torch.where(keep, vals, vals - s), keep


def _compact_render(model_apply, origins, dirs, t, dt, occ_all, occ, k: int,
                    with_instance, valid, use_fine_mask: bool, stage=NO_STAGES,
                    pad_k: int = 0) -> RenderOut:
    """Fixed-K compaction + field query + composite; the weights are
    zero-padded to ``pad_k`` columns so that buckets of different K
    concatenate."""
    with stage("compact"):
        xyz_k, vd, t_k, dt_k, keep_f, _ = _compact_inputs(
            origins, dirs, t, dt, occ_all, occ, k, use_fine_mask)
    sigma_raw, rgb, logits = model_apply(xyz_k, vd)
    with stage("composite_loss"):
        return _pad_weights(composite(sigma_raw, rgb, logits if with_instance else None,
                                      t_k, dt_k, keep_f, valid.to(t.dtype), stage), pad_k)


def _pad_weights(out: RenderOut, pad_k: int) -> RenderOut:
    k = out.weights.shape[-1]
    if pad_k <= k:
        return out
    return out._replace(weights=torch.nn.functional.pad(out.weights, (0, pad_k - k)))


def _rows(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The rays ``sel (..., n)`` of ``x (..., R, *rest)`` along its ray axis."""
    idx = sel.reshape(*sel.shape, *([1] * (x.dim() - sel.dim())))
    return torch.take_along_dim(x, idx, dim=sel.dim() - 1)


def bucket_sizes(r: int, k_buckets) -> list:
    """``(rays, K)`` of each bucket of ``r`` rays: ``int(r * frac)`` for all
    but the last, which takes the rest."""
    sizes, acc = [], 0
    for frac, k in k_buckets[:-1]:
        n = int(r * frac)
        sizes.append((n, int(k)))
        acc += n
    sizes.append((r - acc, int(k_buckets[-1][1])))
    return sizes


def _check_buckets(k_buckets, n_samples: int) -> None:
    frac_sum = sum(f for f, _ in k_buckets)
    if frac_sum > 1.0 + 1e-6:
        raise ValueError(f"k_buckets fractions sum to {frac_sum:.4f} > 1: {k_buckets}")
    bad_k = [k for _, k in k_buckets if int(k) > n_samples]
    if bad_k:
        raise ValueError(f"k_buckets K values {bad_k} exceed n_samples={n_samples}: "
                         f"{k_buckets}")


def local_route(k_buckets):
    """The routing of ``k_buckets`` over the rays at hand: ``route(hits (...,
    R)) -> (order, [(rays, K), ...])``, the rays sorted (stably) by hits
    and cut into the buckets' shares."""

    def route(hits):
        order = torch.argsort(hits, dim=-1, stable=True)  # ascending hit count
        return order, bucket_sizes(hits.shape[-1], k_buckets)

    return route


def _bucket_render(model_apply, origins, dirs, t, dt, occ_all, occ, valid, k_buckets,
                   fuse: bool, with_instance, use_coarse: bool, stage,
                   route=None) -> RenderOut:
    """Adaptive-K routing: the rays sorted (stably) by occupancy hits, the
    emptiest share compacted with the smallest K (``route``, by default
    ``local_route``). Fused: ONE top-K at Kmax in ray order, each bucket
    slicing its first K columns, and one field query over all buckets'
    points; unfused: one compaction and query per bucket. The buckets'
    outputs are put back in the caller's ray order."""
    lead = origins.shape[:-2]
    with stage("compact"):
        hits = occ_all.sum(dim=-1)
        # invalid rays have arbitrary occupancy: they go to the cheapest
        # bucket (``valid`` zeroes their weights anyway)
        hits = torch.where(valid, hits, -1.0)
        order, sizes = (route or local_route(k_buckets))(hits)
        pad_k = max(int(k) for _, k in k_buckets)
        sels, start = [], 0
        for n, _ in sizes:
            sels.append(order[..., start:start + n])
            start += n
    outs = []
    if fuse:
        with stage("compact"):
            s_idx, keep = _first_occupied(occ_all, pad_k)
            t_all = torch.gather(t, -1, s_idx)  # (..., R, Kmax)
            keep_all = keep.to(t.dtype)
            dt0 = dt[..., :1]  # dt is the constant span / S of each ray
            pre, pts, vds = [], [], []
            for (n, k), sel in zip(sizes, sels):
                t_k = _rows(t_all, sel)[..., :k]
                keep_f = _rows(keep_all, sel)[..., :k]
                o_s, d_s = _rows(origins, sel), _rows(dirs, sel)
                xyz_k = torch.clamp(o_s[..., None, :] + t_k[..., None] * d_s[..., None, :],
                                    0.0, 1.0)
                if use_coarse:
                    keep_f = keep_f * occ.occupied(xyz_k)
                pre.append((n, k, t_k, _rows(dt0, sel).expand(t_k.shape), keep_f,
                            _rows(valid, sel)))
                pts.append(xyz_k.reshape(*lead, n * k, 3))
                vds.append(d_s[..., None, :].expand(xyz_k.shape).reshape(*lead, n * k, 3))
        sig, rgb, logits = model_apply(torch.cat(pts, dim=-2), torch.cat(vds, dim=-2))
        with stage("composite_loss"):
            ofs = 0
            for n, k, t_k, dt_k, keep_f, v in pre:
                m = slice(ofs, ofs + n * k)
                ofs += n * k
                out = composite(sig[..., m].reshape(*lead, n, k),
                                rgb[..., m, :].reshape(*lead, n, k, 3),
                                (logits[..., m, :].reshape(*lead, n, k, -1)
                                 if with_instance else None),
                                t_k, dt_k, keep_f, v.to(t.dtype), stage)
                outs.append(_pad_weights(out, pad_k))
    else:
        for (n, k), sel in zip(sizes, sels):
            outs.append(_compact_render(
                model_apply, _rows(origins, sel), _rows(dirs, sel), _rows(t, sel),
                _rows(dt, sel), _rows(occ_all, sel), occ, k, with_instance,
                _rows(valid, sel), use_coarse, stage, pad_k))
    with stage("composite_loss"):
        inv = torch.argsort(order, dim=-1)  # back to the caller's ray order
        return RenderOut(*(_rows(torch.cat([getattr(o, f) for o in outs], dim=len(lead)),
                                 inv) for f in RenderOut._fields))


class Candidates(NamedTuple):
    """A ray batch's candidate samples (``candidates``)."""

    xyz: torch.Tensor  # (..., R, S, 3), clamped to the cube
    t: torch.Tensor  # (..., R, S)
    dt: torch.Tensor  # (..., R, S)
    valid: torch.Tensor  # (..., R): the ray meets the cube
    occupied: torch.Tensor | None  # (..., R, S) occupancy of each candidate
    coarse: bool  # ``occupied`` read on the max-pooled coarse grid


def candidates(origins, dirs, n_samples: int, occ: OccupancyGrid | None,
               stratified: bool = True, occ_coarse_res: int | None = None,
               ray_jitter: bool = False, generator=None, jitter=None,
               occupancy: bool = True) -> Candidates:
    """``render_rays``' candidates: AABB clip -> ``n_samples`` samples a ray
    (stratified from ``generator``, or the ``jitter`` draws) -> clamp to
    the cube, and with ``occupancy`` each candidate's occupancy, on the
    max-pooled coarse grid where ``occ_coarse_res`` is below the grid's
    resolution, else on the grid itself."""
    near, far = ray_aabb(origins, dirs)
    valid = far > near
    far = torch.maximum(far, near + 1e-4)
    xyz, t, dt = sample_points(origins, dirs, n_samples, near, far, stratified,
                               per_ray_jitter=ray_jitter, generator=generator, jitter=jitter)
    xyz = torch.clamp(xyz, 0.0, 1.0)
    coarse = occ_coarse_res is not None and occ is not None and occ_coarse_res < occ.res
    occupied = None
    if occupancy:
        occupied = coarse_occupancy_mxu(occ, xyz, occ_coarse_res) if coarse else occ.occupied(xyz)
    return Candidates(xyz, t, dt, valid, occupied, coarse)


def render_rays(model_apply, origins, dirs, n_samples: int = 128,
                occ: OccupancyGrid | None = None, stratified: bool = True,
                with_instance: bool = True, k_occupied: int | None = None,
                occ_coarse_res: int | None = None, k_buckets: tuple | None = None,
                fuse_buckets: bool = True, ray_jitter: bool = False, generator=None,
                jitter=None, stage=NO_STAGES, route=None) -> RenderOut:
    """Full render: AABB clip -> stratified samples -> occupancy -> (fixed-K
    compaction) -> field query -> composite. ``model_apply(xyz, viewdir)``
    returns (sigma_raw, rgb, instance_logits or None).

    ``k_occupied``: of the ``n_samples`` candidates only the first K
    occupied per ray are queried. ``occ_coarse_res``: the candidates are
    selected on the max-pooled coarse grid and the fine grid masks the K
    compacted samples. ``k_buckets`` ``((frac, K), ...)``: adaptive-K
    routing (overrides ``k_occupied``), fused into one field query with
    ``fuse_buckets``; ``route`` replaces the routing over the rays at hand
    (``local_route``; a scene's rays split over ranks route globally,
    ``train/multiscene.py``). ``stage(name)`` opens the ``occupancy``,
    ``compact`` and ``composite_loss`` spans.

    Rays may carry a leading scene axis (``origins (B, R, 3)``, a fleet's
    occupancy grid and field): each scene is routed and compacted on its
    own."""
    buckets = bool(k_buckets) and occ is not None
    if buckets:
        # up front: a bad ladder would otherwise fail far from the string
        # that produced it
        _check_buckets(k_buckets, n_samples)
    compact = buckets or (k_occupied is not None and occ is not None
                          and k_occupied < n_samples)
    with stage("occupancy"):
        c = candidates(origins, dirs, n_samples, occ, stratified, occ_coarse_res, ray_jitter,
                       generator, jitter, occupancy=compact)
    if buckets:
        return _bucket_render(model_apply, origins, dirs, c.t, c.dt, c.occupied, occ, c.valid,
                              k_buckets, fuse_buckets, with_instance, c.coarse, stage, route)
    if compact:
        return _compact_render(model_apply, origins, dirs, c.t, c.dt, c.occupied, occ,
                               k_occupied, with_instance, c.valid, c.coarse, stage)
    vd = dirs[..., None, :].expand(c.xyz.shape)
    sigma_raw, rgb, logits = model_apply(c.xyz, vd)
    with stage("composite_loss"):
        occ_mask = occ.occupied(c.xyz) if occ is not None else None
        return composite(sigma_raw, rgb, logits if with_instance else None,
                         c.t, c.dt, occ_mask, c.valid.to(c.xyz.dtype), stage)
