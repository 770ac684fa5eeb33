"""Multiresolution hash-grid NGP with an instance-logit head (PyTorch
counterpart of ``instance_nerf_tpu.models.hashgrid``).

``hash_encode`` runs on the card as kernel B8
(``kernels/hash_encode_cuda.py``): one launch computes every point's
features at every level, and its backward hands the table gradient to the
hand-written scatter-add (kernel B3) with ``pallas_grad``, else to
``index_add_``. The name ``pallas_grad`` is kept from the JAX config.

On the CPU it runs ``hash_encode_plain``, which fuses all L levels x 8
corners into ONE flat gather from the ``(L * T, F)`` table, as the JAX
package does, with its table gradient through B3's plain version
(``kernels/scatter_cuda.py:gather_rows_kernel_grad``) or torch's own
``index_select`` backward. Its hash is the uint32 wraparound multiply, XOR,
``% T`` of the JAX package, computed in int64 with each product masked to
32 bits. ``brick_encode`` (``models/fast_encode.py``) shares its helpers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from instance_nerf_tpu_torch.kernels import hash_encode_cuda
from instance_nerf_tpu_torch.kernels.scatter_cuda import gather_rows_kernel_grad
from instance_nerf_tpu_torch.train.timing import NO_STAGES

# spatial hash primes (Instant-NGP eq. 4 convention)
HASH_PRIMES = np.array([1, 2654435761, 805459861], dtype=np.uint32)

CORNER_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
    dtype=np.uint32,
)  # (8, 3)

_U32 = 0xFFFFFFFF


def hash_cells(c: torch.Tensor, res: np.ndarray, table_size: int,
               stage=NO_STAGES) -> torch.Tensor:
    """Row of each integer cell ``c (..., L, [8,] 3)`` int64 in its level:
    dense index where ``res^3 <= T`` (decided on the host), else the NGP
    hash ``(x * p0) ^ (y * p1) ^ (z * p2) mod 2^32 % T``. ``stage``
    (``train/timing.py:Stages``) uploads the host constants."""
    res_np = np.asarray(res, np.int64)
    extra = c.dim() - 2  # the level axis sits just before the corner/coord axes
    shape = (len(res_np),) + (1,) * (extra - 1)
    r = stage.upload(res_np, c.device).view(shape)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    idx_dense = (cx * r + cy) * r + cz
    p = [int(v) for v in HASH_PRIMES]
    h = (cx * p[0] & _U32) ^ (cy * p[1] & _U32) ^ (cz * p[2] & _U32)
    idx_hash = h % table_size
    dense = stage.upload(res_np ** 3 <= table_size, c.device).view(shape)
    return torch.where(dense, idx_dense, idx_hash)


def _level_flat(idx: torch.Tensor, n_levels: int, table_size: int) -> torch.Tensor:
    """``(N, L, ...)`` per-level rows -> flat int32 rows of the ``(L * T, .)``
    table."""
    shape = (1, n_levels) + (1,) * (idx.dim() - 2)
    off = (torch.arange(n_levels, device=idx.device) * table_size).view(shape)
    return (idx + off).to(torch.int32).reshape(-1)


def corner_weights(frac: torch.Tensor, stage=NO_STAGES) -> torch.Tensor:
    """Trilinear weights ``(M, 8)`` of the corner offsets from ``frac (M, 3)``."""
    corners = stage.upload(CORNER_OFFSETS.astype(bool), frac.device)
    w = torch.where(corners[None], frac[:, None, :], 1.0 - frac[:, None, :])
    return w[..., 0] * w[..., 1] * w[..., 2]


def gather_rows(table2d, flat, n_levels, trailing, pallas_grad, replicas=1, rows_dtype=None):
    """The rows ``flat`` of the f32 ``table2d``, read as ``rows_dtype`` (None:
    f32). With ``pallas_grad`` the table gradient is kernel B3 and reaches
    the table in f32; else it is torch's ``index_select`` backward, in
    ``rows_dtype`` (XLA's scatter in the table's dtype), then cast."""
    if pallas_grad:
        return gather_rows_kernel_grad(table2d, flat, n_levels, trailing, replicas, rows_dtype)
    if rows_dtype is not None:
        table2d = table2d.to(rows_dtype)
    return table2d.index_select(0, flat)


def scene_major_points(table: torch.Tensor, table_dims: int, xyz: torch.Tensor):
    """Points of one field or of a fleet, whose tables carry a leading scene
    axis (``table.dim() == table_dims + 1``, ``xyz (B, ..., 3)``), as
    ``(N * B, 3)`` in (point, scene) order: the flat indices then lay out as
    ``(N, B, L, ...)``, B * L levels for the scatter-add kernel. Returns the
    points and B (1 for one field)."""
    if table.dim() == table_dims:
        return xyz.reshape(-1, 3), 1
    b = table.shape[0]
    return xyz.reshape(b, -1, 3).transpose(0, 1).reshape(-1, 3), b


def scene_major_features(feats: torch.Tensor, b: int, lead) -> torch.Tensor:
    """``(N * B, D)`` features in (point, scene) order -> ``(*lead, D)``."""
    d = feats.shape[-1]
    if b == 1:
        return feats.reshape(*lead, d)
    return feats.reshape(-1, b, d).transpose(0, 1).reshape(*lead, d)


def hash_encode(table: torch.Tensor, xyz: torch.Tensor, resolutions,
                pallas_grad: bool = False, stage=NO_STAGES) -> torch.Tensor:
    """Trilinear multiresolution hash encoding ``(L, T, F)`` table,
    ``(..., 3)`` points in [0, 1] -> ``(..., L * F)``; a fleet's ``(B, L, T,
    F)`` tables take ``(B, ..., 3)``. CPU tensors run ``hash_encode_plain``;
    any other device kernel B8 (``kernels/hash_encode_cuda.py:hash_encode``),
    which raises off CUDA and on a table or points it does not take, and
    uploads nothing (``stage`` opens no wait)."""
    if table.device.type == "cpu" and xyz.device.type == "cpu":
        return hash_encode_plain(table, xyz, resolutions, pallas_grad, stage)
    return hash_encode_cuda.hash_encode(table, xyz, resolutions, pallas_grad)


def hash_encode_plain(table: torch.Tensor, xyz: torch.Tensor, resolutions,
                      pallas_grad: bool = False, stage=NO_STAGES) -> torch.Tensor:
    """``hash_encode`` as a chain of PyTorch operations (the CPU's path).

    Corners are clamped to ``res - 1`` so the +1 corner at xyz == 1 stays in
    range (its weight is 0). The flat index layout is ``(N, L, 8)``, corners
    minor, which the kernel's level split relies on (trailing = 8); a
    fleet's is ``(N, B, L, 8)``, B * L levels. The JAX package chunks large
    batches under ``lax.map``; that changes nothing numerically, and the
    port encodes a batch in one pass. ``stage`` (``train/timing.py:Stages``)
    uploads the host constants: six uploads a call, each a wait where the
    card tests run this chain on the card beside B8."""
    L, T, F = table.shape[-3:]
    lead = xyz.shape[:-1]
    x, b = scene_major_points(table, 3, xyz)
    n = x.shape[0]
    res_np = np.asarray(resolutions, np.int64)
    resf = stage.upload(res_np, x.device, x.dtype)
    p = x[:, None, :] * (resf[None, :, None] - 1.0)  # (N, L, 3)
    p0 = torch.floor(p)
    frac = p - p0
    corners = stage.upload(CORNER_OFFSETS.astype(np.int64), x.device)
    c = p0.to(torch.int64)[:, :, None, :] + corners[None, None]  # (N, L, 8, 3)
    c = torch.minimum(c, stage.upload(res_np - 1, x.device).view(1, L, 1, 1))
    flat = _level_flat(hash_cells(c, res_np, T, stage).reshape(-1, b * L, 8), b * L, T)
    gathered = gather_rows(table.reshape(b * L * T, F), flat, b * L, 8, pallas_grad)
    w = corner_weights(frac.reshape(-1, 3), stage)  # (N * L, 8)
    feats = (gathered.view(n * L, 8, F) * w[..., None]).sum(1)
    return scene_major_features(feats.reshape(n, L * F), b, lead)


def ngp_resolutions(n_levels: int = 16, base_res: int = 16, max_res: int = 2048):
    """Geometric progression of grid resolutions (NGP eq. 2-3)."""
    if n_levels == 1:
        return np.array([base_res])
    b = np.exp((np.log(max_res) - np.log(base_res)) / (n_levels - 1))
    return np.round(base_res * b ** np.arange(n_levels)).astype(np.int64)


def sh_encode_deg2(d: torch.Tensor) -> torch.Tensor:
    """Degree-2 real spherical harmonics of unit directions -> (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.31539156525252005 * (3 * z * z - 1),
            1.0925484305920792 * x * z,
            0.5462742152960396 * (x * x - y * y),
        ],
        dim=-1,
    )


def density_activation(sigma_raw: torch.Tensor) -> torch.Tensor:
    """exp activation like instant-ngp."""
    return torch.exp(torch.clamp(sigma_raw, -15.0, 15.0))


class FleetDense(nn.Module):
    """B scenes' ``Dense`` layers stacked: ``weight (B, out, in)``, ``bias
    (B, out)``, applied to ``(B, ..., in)`` as one batched matmul."""

    def __init__(self, n_scenes: int, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((n_scenes, out_dim, in_dim)))
        self.bias = nn.Parameter(torch.zeros((n_scenes, out_dim)))


def dense(layer, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``
    (None keeps f32). A ``FleetDense`` takes scene b's rows ``x[b]`` to its
    own weights (flax's Dense under ``vmap``)."""
    w, bias = layer.weight, layer.bias
    if dtype is not None:
        x, w, bias = x.to(dtype), w.to(dtype), bias.to(dtype)
    if w.dim() == 2:
        return nn.functional.linear(x, w, bias)
    b = w.shape[0]
    y = torch.baddbmm(bias[:, None, :], x.reshape(b, -1, x.shape[-1]), w.transpose(1, 2))
    return y.reshape(*x.shape[:-1], w.shape[1])


class NGPHeads(nn.Module):
    """The sigma, color and instance MLPs shared by both field encodings;
    parameter names follow the flax modules (``sigma_0`` ... ``inst_1``)."""

    def _make_heads(self, in_dim, geo_feat_dim, hidden, num_instances, dtype,
                    n_scenes=None):
        self.dtype = dtype
        self.n_scenes = n_scenes

        def layer(i, o):
            return nn.Linear(i, o) if n_scenes is None else FleetDense(n_scenes, i, o)

        self.sigma_0 = layer(in_dim, hidden)
        self.sigma_1 = layer(hidden, 1 + geo_feat_dim)
        self.color_0 = layer(geo_feat_dim + 9, hidden)
        self.color_1 = layer(hidden, hidden)
        self.color_2 = layer(hidden, 3)
        self.inst_0 = layer(geo_feat_dim, hidden)
        self.inst_1 = layer(hidden, num_instances)

    def _stacked(self, shape):
        """A parameter shape with the fleet's leading scene axis, if any."""
        return shape if self.n_scenes is None else (self.n_scenes, *shape)

    def sigma_head(self, h):
        """Encoded features -> (sigma_raw (...,), geo (..., geo_feat_dim))."""
        h = torch.relu(dense(self.sigma_0, h, self.dtype))
        h = dense(self.sigma_1, h, self.dtype)
        return h[..., 0], h[..., 1:]

    def query(self, xyz, stage=NO_STAGES):
        """(..., 3) -> (sigma_raw (...,), geo (..., geo_feat_dim))."""
        return self.sigma_head(self.encode(xyz, stage))

    def color(self, geo, viewdir):
        sh = sh_encode_deg2(viewdir)
        h = torch.cat([geo, sh.to(geo.dtype)], dim=-1)
        h = torch.relu(dense(self.color_0, h, self.dtype))
        h = torch.relu(dense(self.color_1, h, self.dtype))
        return torch.sigmoid(dense(self.color_2, h, self.dtype))

    def instance(self, geo):
        """Instance logits from detached geometry features: the instance
        field trains without disturbing the radiance field."""
        h = torch.relu(dense(self.inst_0, geo.detach(), self.dtype))
        return dense(self.inst_1, h, self.dtype)

    def forward(self, xyz, viewdir, with_instance: bool = True, stage=NO_STAGES):
        """-> (sigma_raw, rgb, instance logits or None); ``stage``
        (``train/timing.py:Stages``) opens the ``encode`` and ``mlp`` spans
        and the encoding's ``wait`` spans."""
        with stage("encode"):
            h = self.encode(xyz, stage)
        with stage("mlp"):
            sigma_raw, geo = self.sigma_head(h)
            rgb = self.color(geo, viewdir)
            logits = self.instance(geo) if with_instance else None
        return sigma_raw, rgb, logits


class InstanceNGP(NGPHeads):
    """Hash-grid NeRF + instance-logit head. ``num_instances`` includes
    background/void at 0. ``dtype`` is the MLPs' compute dtype (None = f32;
    parameters stay f32). ``n_scenes``: a fleet of that many fields, every
    parameter stacked on a leading scene axis, queried with ``(B, ..., 3)``
    points (scene b's through field b)."""

    def __init__(self, n_levels: int = 16, table_size: int = 2 ** 19, n_features: int = 2,
                 base_res: int = 16, max_res: int = 2048, geo_feat_dim: int = 15,
                 hidden: int = 64, num_instances: int = 33, dtype=None,
                 pallas_grad: bool = False, n_scenes: int | None = None):
        super().__init__()
        self.pallas_grad = pallas_grad
        self.resolutions = ngp_resolutions(n_levels, base_res, max_res)
        self.n_scenes = n_scenes
        self.hash_table = nn.Parameter(
            torch.zeros(self._stacked((n_levels, table_size, n_features)),
                        dtype=torch.float32))
        self._make_heads(n_levels * n_features, geo_feat_dim, hidden, num_instances, dtype,
                         n_scenes)

    def encode(self, xyz, stage=NO_STAGES):
        return hash_encode(self.hash_table, xyz, self.resolutions,
                           pallas_grad=self.pallas_grad, stage=stage)
