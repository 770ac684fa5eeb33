"""Plain PyTorch reference of the instance field's rgb training step, one
field or a fleet of B fields (a leading scene axis on every tensor).

It follows the published method (instant-ngp's multiresolution hash grid,
Mueller et al. 2022; the fleet of the JAX package this port was made from)
and the port's numerics where the method leaves a choice: the same hash, corner order, trilinear weights, bf16 roundings,
compositing, loss and optax-order Adam. It imports torch and numpy only,
never the program: every input (weights, scenes, rays, random draws) is
made again here from the seed, as the benchmark made it for the program.

``precision`` selects the matmul precision of the MLPs: ``None`` is what
the configuration states (f32 with TF32 off, or bf16); ``"tf32"`` rounds
the f32 operands of the forward and backward matmuls to TF32, ``"fp8"``
the bf16 ones to e4m3 (forward) and e5m2 (gradients) with per-tensor
scales: the controls, one precision below.
"""
from __future__ import annotations

import math

import numpy as np
import torch

HASH_PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
CORNERS = [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-15
GEO_FEAT_DIM = 15
# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in
TRUNC_STD = 0.87962566103423978


# -- the configuration's parameters ------------------------------------------

def encoding_dim(cfg: dict) -> int:
    if cfg["encoding"] != "hash":
        raise ValueError(f"no plain reference of the {cfg['encoding']!r} encoding")
    return cfg["n_levels"] * cfg["n_features"]


def layer_dims(cfg: dict) -> dict:
    """``{layer: (in, out)}`` of the sigma, color and instance MLPs."""
    h = cfg["hidden"]
    return {"sigma_0": (encoding_dim(cfg), h), "sigma_1": (h, 1 + GEO_FEAT_DIM),
            "color_0": (GEO_FEAT_DIM + 9, h), "color_1": (h, h), "color_2": (h, 3),
            "inst_0": (GEO_FEAT_DIM, h), "inst_1": (h, cfg["num_instances"])}


def param_shapes(cfg: dict, n_scenes: int | None = None) -> dict:
    """``{name: shape}`` of the field's parameters, named as the program's
    modules name them; a fleet's carry a leading axis of ``n_scenes``."""
    lead = () if n_scenes is None else (n_scenes,)
    shapes = {"hash_table": (cfg["n_levels"], cfg["table_size"], cfg["n_features"])}
    for name, (i, o) in layer_dims(cfg).items():
        shapes[f"{name}.weight"] = (o, i)
        shapes[f"{name}.bias"] = (o,)
    return {k: lead + v for k, v in shapes.items()}


def _trunc_normal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` standard normals truncated to [-2, 2], by the inverse CDF."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    return (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-2.0, 2.0)


@torch.no_grad()
def init_params(cfg: dict, seed: int, device, n_scenes: int | None = None) -> dict:
    """The field's initial parameters from ``seed``, drawn on ``device`` in
    two calls: tables uniform(-1e-4, 1e-4), ``Dense`` weights lecun-normal
    (truncated at two standard deviations), biases zero (flax's rules)."""
    shapes = param_shapes(cfg, n_scenes)
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = [k for k in shapes if not k.endswith((".weight", ".bias"))]
    weights = [k for k in shapes if k.endswith(".weight")]
    out = {}
    flat = torch.rand(sum(math.prod(shapes[k]) for k in tables), generator=gen,
                      device=device) * 2e-4 - 1e-4
    for k, part in zip(tables, flat.split([math.prod(shapes[k]) for k in tables])):
        out[k] = part.view(shapes[k])
    flat = _trunc_normal(sum(math.prod(shapes[k]) for k in weights), gen, device)
    for k, part in zip(weights, flat.split([math.prod(shapes[k]) for k in weights])):
        out[k] = part.view(shapes[k]) * (math.sqrt(1.0 / shapes[k][-1]) / TRUNC_STD)
    for k in shapes:
        if k.endswith(".bias"):
            out[k] = torch.zeros(shapes[k], device=device)
    return {k: out[k] for k in shapes}


# -- precision ---------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits (to nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & -8192
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = top / x.abs().amax().float().clamp(min=1e-30)
    return ((x.float() * s).to(dtype).float() / s).to(x.dtype)


def round_e4m3(x):
    """``x`` through e4m3 with a per-tensor scale (its largest magnitude to
    448), back in its own dtype: fp8 training's forward operands."""
    return _round_fp8(x, torch.float8_e4m3fn, 448.0)


def round_e5m2(x):
    """The same through e5m2 (largest magnitude to 57344): fp8 training's
    gradients."""
    return _round_fp8(x, torch.float8_e5m2, 57344.0)


# the lower precision's rounding of a matmul's operands, forward and backward
LOWER = {"tf32": (round_tf32, round_tf32), "fp8": (round_e4m3, round_e5m2)}


class _Operand(torch.autograd.Function):
    """A matmul operand rounded in the forward; its gradient passes as is."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x.detach())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    """A matmul's output as is; the gradient reaching it rounded, as the
    backward's matmuls take it as their operand."""

    @staticmethod
    def forward(ctx, y, fn):
        ctx.fn = fn
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def dense(x, w, b, dtype, precision=None):
    """Scene b's rows ``x (B, N, in)`` through its ``w (B, out, in)`` and
    ``b (B, out)``, cast to ``dtype`` (None keeps f32) as flax's ``Dense``.
    ``precision`` rounds the operands of the forward and backward matmuls
    (``LOWER``)."""
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    if precision is None:
        return torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
    fwd, bwd = LOWER[precision]
    y = torch.baddbmm(b[:, None, :], _Operand.apply(x, fwd), _Operand.apply(w, fwd).transpose(1, 2))
    return _Output.apply(y, bwd)


# -- encodings ---------------------------------------------------------------

def grid_resolutions(n_levels, base_res, max_res):
    if n_levels == 1:
        return np.array([base_res])
    g = np.exp((np.log(max_res) - np.log(base_res)) / (n_levels - 1))
    return np.round(base_res * g ** np.arange(n_levels)).astype(np.int64)


def cell_rows(c, res: np.ndarray, table_size: int):
    """Table row of each integer cell ``c (..., L, [8,] 3)``: the dense index
    where ``res^3 <= T``, else the spatial hash ``mod 2^32 % T``."""
    extra = c.dim() - 2
    shape = (len(res),) + (1,) * (extra - 1)
    r = torch.as_tensor(res, device=c.device).view(shape)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    dense_idx = (cx * r + cy) * r + cz
    p = HASH_PRIMES
    hashed = ((cx * p[0] & U32) ^ (cy * p[1] & U32) ^ (cz * p[2] & U32)) % table_size
    is_dense = torch.as_tensor(res ** 3 <= table_size, device=c.device).view(shape)
    return torch.where(is_dense, dense_idx, hashed)


def trilinear(frac):
    """Weights ``(M, 8)`` of the 8 corners from ``frac (M, 3)``."""
    corners = torch.as_tensor(CORNERS, device=frac.device).bool()
    w = torch.where(corners[None], frac[:, None, :], 1.0 - frac[:, None, :])
    return w[..., 0] * w[..., 1] * w[..., 2]


def hash_encode(table, xyz, cfg):
    """``table (B, L, T, F)``, ``xyz (B, N, 3)`` -> ``(B, N, L * F)``."""
    b, n = xyz.shape[:2]
    L, T, F = table.shape[1:]
    res = grid_resolutions(L, cfg["base_res"], cfg["max_res"])
    x = xyz.reshape(-1, 3)
    p = x[:, None, :] * (torch.as_tensor(res, dtype=x.dtype, device=x.device)[None, :, None] - 1.0)
    p0 = torch.floor(p)
    frac = p - p0
    c = p0.long()[:, :, None, :] + torch.as_tensor(CORNERS, device=x.device)[None, None]
    c = torch.minimum(c, torch.as_tensor(res - 1, device=x.device).view(1, L, 1, 1))
    rows = cell_rows(c, res, T)  # (B * N, L, 8)
    scene = torch.arange(b, device=x.device).repeat_interleave(n)[:, None, None]
    level = torch.arange(L, device=x.device)[None, :, None]
    g = table[scene, level, rows]  # (B * N, L, 8, F)
    w = trilinear(frac.reshape(-1, 3)).view(b * n, L, 8)
    return (g * w[..., None]).sum(2).reshape(b, n, L * F)


def encode(params, xyz, cfg):
    return hash_encode(params["hash_table"], xyz, cfg)


def sh_deg2(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), 0.4886025119029199 * y,
        0.4886025119029199 * z, 0.4886025119029199 * x, 1.0925484305920792 * x * y,
        1.0925484305920792 * y * z, 0.31539156525252005 * (3 * z * z - 1),
        1.0925484305920792 * x * z, 0.5462742152960396 * (x * x - y * y)], dim=-1)


def field(params, xyz, vd, cfg, precision=None):
    """``xyz``, ``vd (B, N, 3)`` -> (sigma_raw (B, N), rgb (B, N, 3))."""
    dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else None

    def lin(name, x):
        return dense(x, params[f"{name}.weight"], params[f"{name}.bias"], dt, precision)

    h = torch.relu(lin("sigma_0", encode(params, xyz, cfg)))
    h = lin("sigma_1", h)
    sigma_raw, geo = h[..., 0], h[..., 1:]
    h = torch.cat([geo, sh_deg2(vd).to(geo.dtype)], dim=-1)
    h = torch.relu(lin("color_0", h))
    h = torch.relu(lin("color_1", h))
    return sigma_raw, torch.sigmoid(lin("color_2", h))


# -- rendering ---------------------------------------------------------------

def ray_aabb(o, d, eps=1e-9):
    small = torch.where(d < 0, torch.full_like(d, -eps), torch.full_like(d, eps))
    inv = 1.0 / torch.where(torch.abs(d) < eps, small, d)
    t0, t1 = (0.0 - o) * inv, (1.0 - o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


def bin_edges(n, device):
    """``linspace(0, 1, n + 1)`` in f32 as XLA computes it: iota * f32(1 / n)."""
    recip = float(np.float32(1.0) / np.float32(n))
    return torch.cat([torch.arange(n, dtype=torch.float32, device=device) * recip,
                      torch.ones(1, device=device)])


def sample_points(o, d, n, near, far, jitter):
    """Stratified samples in [near, far]; ``jitter`` uniforms ``(..., R, n)``
    or ``(..., R, 1)``, or 0.5 for bin centers."""
    u = bin_edges(n, o.device)
    tt = u[:-1] + (u[1:] - u[:-1]) * jitter
    span = torch.clamp(far - near, min=1e-6)[..., None]
    t = near[..., None] + tt * span
    dt = span / n
    return o[..., None, :] + t[..., None] * d[..., None, :], t, dt.expand(t.shape)


def density(sigma_raw):
    return torch.exp(torch.clamp(sigma_raw, -15.0, 15.0))


def composite(sigma_raw, rgb, t, dt, mask, valid):
    sigma = density(sigma_raw) * mask
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans * valid[..., None]
    return torch.sum(weights[..., None] * rgb, dim=-2), weights


def occupied(grid, xyz):
    """``grid (B, G, G, G)`` looked up at ``xyz (B, ..., 3)`` -> {0, 1}."""
    b, g = grid.shape[0], grid.shape[-1]
    idx = torch.clamp((xyz * g).to(torch.int32), 0, g - 1).long()
    cell = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    scene = torch.arange(b, device=xyz.device).view(b, *([1] * (cell.dim() - 1)))
    return grid.reshape(b, -1)[scene, cell]


def render_rgb(params, cfg, grid, threshold, o, d, jitter, precision=None):
    """The rgb of rays ``o``, ``d (B, R, 3)`` through the field: stratified
    candidates, their occupancy (on the coarse grid where the configuration
    has one), the first K occupied of each ray in depth order, and with a
    coarse grid the fine mask on those K."""
    n, k = cfg["n_samples"], cfg["k_occupied"]
    near, far = ray_aabb(o, d)
    valid = (far > near).to(o.dtype)
    far = torch.maximum(far, near + 1e-4)
    xyz, t, dt = sample_points(o, d, n, near, far, jitter)
    xyz = torch.clamp(xyz, 0.0, 1.0)
    fine = (grid > threshold).to(o.dtype)
    coarse_res = cfg.get("occ_coarse_res")
    if coarse_res and coarse_res < grid.shape[-1]:
        b, g = grid.shape[0], grid.shape[-1]
        f = g // coarse_res
        coarse = grid.reshape(b, coarse_res, f, coarse_res, f, coarse_res, f).amax(
            dim=(-5, -3, -1)) > threshold
        ci = torch.clamp(xyz * coarse_res, 0, coarse_res - 1).to(torch.int32).long()
        cell = (ci[..., 0] * coarse_res + ci[..., 1]) * coarse_res + ci[..., 2]
        scene = torch.arange(b, device=o.device).view(b, 1, 1)
        occ_all = coarse.reshape(b, -1)[scene, cell].to(o.dtype)
    else:
        coarse_res = None
        occ_all = occupied(fine, xyz)
    key = torch.where(occ_all > 0, 0, n) + torch.arange(n, device=o.device)
    first = -torch.topk(-key, k, dim=-1).values
    keep = first < n
    s_idx = torch.where(keep, first, first - n)
    t_k = torch.gather(t, -1, s_idx)
    xyz_k = torch.clamp(o[..., None, :] + t_k[..., None] * d[..., None, :], 0.0, 1.0)
    mask = keep.to(o.dtype)
    if coarse_res:
        mask = mask * occupied(fine, xyz_k)
    vd = d[..., None, :].expand(xyz_k.shape)
    b, r = o.shape[:2]
    sigma_raw, rgb = field(params, xyz_k.reshape(b, r * k, 3), vd.reshape(b, r * k, 3),
                           cfg, precision)
    out, _ = composite(sigma_raw.reshape(b, r, k), rgb.reshape(b, r, k, 3), t_k,
                       dt[..., :1].expand(t_k.shape), mask, valid)
    return out


def rgb_losses(rgb, target):
    """Each scene's rgb MSE ``(B,)``: its squared error over its element count."""
    return ((rgb - target) ** 2).sum(dim=(-2, -1)) / float(target.shape[-2] * target.shape[-1])


@torch.no_grad()
def adam(params, grads, st, lr):
    """optax's Adam (b1 0.9, b2 0.99, eps 1e-15), rgb stage: every parameter
    steps; one without a gradient sees zeros."""
    st["count"] += 1
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(st["count"]))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(st["count"]))
    for k, p in params.items():
        mu, nu, g = st["mu"][k], st["nu"][k], grads.get(k)
        mu.mul_(ADAM_B1)
        nu.mul_(ADAM_B2)
        if g is not None:
            mu.add_(g * (1 - ADAM_B1))
            nu.add_(g * g * (1 - ADAM_B2))
        p.add_(((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)).mul_(-lr))


def leaf_norms(tensors: dict) -> dict:
    """``{name: [norm of each scene's slice]}``, in f64."""
    return {k: torch.linalg.vector_norm(v.detach().double().reshape(v.shape[0], -1),
                                        dim=1).cpu().tolist() for k, v in tensors.items()}




# -- the first call ----------------------------------------------------------

def rays(poses, intrinsics, hw, v, pix):
    """Rays of view ids and flat pixel ids ``(B, R)``: scene b's camera
    ``poses (B, V, 4, 4)`` and ``intrinsics (B, 4)`` (fx, fy, cx, cy), unit
    directions through the pixels' centres -> (o, d), each ``(B, R, 3)``."""
    h, w = hw
    bidx = torch.arange(v.shape[0], device=v.device)[:, None]
    c2w = poses[bidx, v]
    fx, fy, cx, cy = (intrinsics[:, i, None] for i in range(4))
    py = (pix // w).to(torch.float32) + 0.5
    px = (pix % w).to(torch.float32) + 0.5
    dirs = torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], dim=-1)
    d = torch.einsum("brij,brj->bri", c2w[..., :3, :3], dirs)
    return c2w[..., :3, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)


def sigma_raw(params, xyz, cfg, precision=None):
    """The sigma MLP's first output at ``xyz (B, N, 3)``, in the MLPs' dtype."""
    dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else None

    def lin(name, x):
        return dense(x, params[f"{name}.weight"], params[f"{name}.bias"], dt, precision)

    return lin("sigma_1", torch.relu(lin("sigma_0", encode(params, xyz, cfg))))[..., 0]


# points a refresh queries at once, over all scenes
REFRESH_CHUNK = 2 ** 21


@torch.no_grad()
def refresh(params, cfg, grid, cells, jitter, precision=None):
    """The occupancy refresh: the grid ``(B, G, G, G)`` decayed by 0.95, then
    the density at each re-sampled cell's jittered point (``jitter (B, M,
    3)``; ``cells (B, M)``, or None for every cell in C order) max-ed in."""
    b, g = grid.shape[0], grid.shape[-1]
    if cells is None:
        cells = torch.arange(g ** 3, device=grid.device).expand(b, -1)
    coords = torch.stack([cells // (g * g), (cells // g) % g, cells % g], dim=-1)
    xyz = (coords.to(torch.float32) + jitter) / g
    step = max(1, REFRESH_CHUNK // b)
    sig = torch.cat([density(sigma_raw(params, xyz[:, i:i + step], cfg, precision)).float()
                     for i in range(0, xyz.shape[1], step)], dim=1)
    flat = grid.reshape(b, -1) * 0.95
    return flat.scatter_reduce_(1, cells, sig, "amax").reshape(grid.shape)


def first_call(cfg: dict, params: dict, grid, batch, steps: int, cells, cell_jitter,
               precision=None, fault=None) -> dict:
    """The readings of the window's first call (``harness/compare.py``): its
    ``steps`` rgb steps from ``params`` (scene-stacked) and the occupancy
    ``grid (B, G, G, G)``, with ``batch(step) -> (o, d, target rgb,
    jitter)``, each ``(B, R, ...)``, then the refresh that ends it. The
    first three steps give the loss, the first gradient and the change;
    the refresh gives the grid. ``fault="half_batch"`` leaves out the second
    half of each scene's rays (the loss then the mean over the rest)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    initial = {k: v.detach().clone() for k, v in params.items()}
    st = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
          "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    names = list(params)
    losses, grad, change = [], None, None
    for step in range(steps):
        o, d, target, jitter = batch(step)
        if fault == "half_batch":
            half = o.shape[1] // 2
            o, d, target, jitter = o[:, :half], d[:, :half], target[:, :half], jitter[:, :half]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        rgb = render_rgb(params, cfg, grid, cfg["occ_threshold"], o, d, jitter, precision)
        per_scene = rgb_losses(rgb, target)
        grads = torch.autograd.grad(per_scene.sum(), [params[k] for k in names],
                                    allow_unused=True)
        if step < 3:
            losses.append(float(per_scene.detach().double().mean()))
        adam(params, dict(zip(names, grads)), st, cfg["lr"])
        if step == 0:
            grad = leaf_norms({k: v / (1 - ADAM_B1) for k, v in st["mu"].items()})
        if step == 2:
            change = leaf_norms({k: params[k].detach() - initial[k] for k in names})
            initial = None
    grid = refresh(params, cfg, grid, cells, cell_jitter, precision)
    return {"loss": losses, "grad": grad, "change": change,
            "grid": grid.reshape(grid.shape[0], -1).cpu()}


@torch.no_grad()
def ray_gap(poses, intrinsics, images, hw, seen) -> float:
    """The program's own ray batches judged by what they say: for each ray
    ``(o, d, target rgb)`` of ``seen`` (each ``(B, R, 3)``), the view whose
    camera centre is nearest ``o`` and the pixel that ``d`` passes through
    in it, then the largest gap of ``o``, ``d`` and the target to the ray and
    target of that view and pixel (``images (B, V, H * W, 3)``)."""
    h, w = hw
    worst = 0.0
    for o, d, rgb in seen:
        o, d, rgb = (x.to(poses.device, torch.float32) for x in (o, d, rgb))
        bidx = torch.arange(o.shape[0], device=o.device)[:, None]
        centres = poses[:, :, :3, 3]  # (B, V, 3)
        v = ((o[:, :, None, :] - centres[:, None]) ** 2).sum(-1).argmin(-1)
        dc = torch.einsum("brji,brj->bri", poses[bidx, v, :3, :3], d)  # in the camera's frame
        fx, fy, cx, cy = (intrinsics[:, i, None] for i in range(4))
        px = dc[..., 0] / -dc[..., 2] * fx + cx
        py = -(dc[..., 1] / -dc[..., 2]) * fy + cy
        col = torch.nan_to_num(torch.floor(px), nan=-1.0).clamp(0, w - 1).long()
        row = torch.nan_to_num(torch.floor(py), nan=-1.0).clamp(0, h - 1).long()
        pix = row * w + col
        o_r, d_r = rays(poses, intrinsics, hw, v, pix)
        gaps = torch.stack([(o - o_r).abs().amax(), (d - d_r).abs().amax(),
                            (rgb - images[bidx, v, pix]).abs().amax()])
        worst = max(worst, float(torch.nan_to_num(gaps, nan=float("inf")).max()))
    return worst
