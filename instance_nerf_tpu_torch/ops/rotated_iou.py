"""Rotated (z-yaw) 3D box IoU and the GIoU / DIoU losses (PyTorch
counterpart of ``instance_nerf_tpu.ops.rotated_iou``), differentiable by
autograd: gradients flow through the vertex coordinates; the vertex order
is an index and carries none.

Algorithm, as in the JAX package:

1. 2D rectangle corners from ``(x, y, w, h, theta)``.
2. 16 edge-pair intersection candidates and 8 corner-inside candidates,
   each with a validity mask (24 candidates).
3. The valid candidates sorted by angle around their centroid (a stable
   sort, as ``jnp.argsort``), then the shoelace area.
4. 3D IoU = 2D intersection area x z-overlap over the union of volumes.

Every function broadcasts over leading dims. ``pairwise_iou_3d`` computes
an ``(N, M)`` matrix in row chunks, so the ``(rows, M, 24, 2)`` vertex
tensors stay bounded; each pair's arithmetic is the same in every chunk,
so a chunked matrix equals an unchunked one bit for bit.

Against XLA the results differ only through the last bit of ``sin``,
``cos`` and ``atan2``: IoUs agree to 1e-5 absolute
(``tests/test_torch_rotated_iou.py``).
"""
from __future__ import annotations

import torch

EPS = 1e-8
# Pairs per chunk of ``pairwise_iou_3d``: about 200 MB for each
# (pairs, 24, 2) f32 intermediate.
CHUNK_PAIRS = 1 << 20


def box2corners(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, h, alpha] -> (..., 4, 2) CCW corners."""
    x, y, w, h, alpha = box.unbind(-1)
    xs = torch.stack([0.5 * w, -0.5 * w, -0.5 * w, 0.5 * w], dim=-1)
    ys = torch.stack([0.5 * h, 0.5 * h, -0.5 * h, -0.5 * h], dim=-1)
    c, s = torch.cos(alpha)[..., None], torch.sin(alpha)[..., None]
    rx = xs * c - ys * s
    ry = xs * s + ys * c
    corners = torch.stack([rx, ry], dim=-1)
    return corners + torch.stack([x, y], dim=-1)[..., None, :]


_NEXT = [1, 2, 3, 0]


def _edge_intersections(corners1, corners2):
    """All 4x4 edge-pair intersections: (..., 16, 2) points and (..., 16)
    validity. Collinear edges yield no intersection."""
    p1, q1 = corners1, corners1[..., _NEXT, :]
    p2, q2 = corners2, corners2[..., _NEXT, :]
    x1, y1 = p1[..., :, None, 0], p1[..., :, None, 1]
    x2, y2 = q1[..., :, None, 0], q1[..., :, None, 1]
    x3, y3 = p2[..., None, :, 0], p2[..., None, :, 1]
    x4, y4 = q2[..., None, :, 0], q2[..., None, :, 1]

    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    parallel = num == 0.0
    num_safe = torch.where(parallel, torch.ones_like(num), num)
    t = den_t / num_safe
    u = -den_u / num_safe
    mask = (~parallel) & (t > 0) & (t < 1) & (u > 0) & (u < 1)
    t_safe = den_t / (num + EPS)
    ix = x1 + t_safe * (x2 - x1)
    iy = y1 + t_safe * (y2 - y1)
    pts = torch.stack([ix, iy], dim=-1) * mask[..., None]
    shp = pts.shape[:-3] + (16, 2)
    return pts.reshape(shp), mask.reshape(shp[:-1])


def _corners_in_box(corners1, corners2):
    """(..., 4) bool: is corner i of box1 inside box2 (projection test,
    tolerant to on-edge points by 1e-4 of the edge, as the JAX package)."""
    a = corners2[..., 0:1, :]
    b = corners2[..., 1:2, :]
    d = corners2[..., 3:4, :]
    ab, ad = b - a, d - a
    am = corners1 - a
    p_ab = torch.sum(ab * am, dim=-1)
    n_ab = torch.sum(ab * ab, dim=-1)
    p_ad = torch.sum(ad * am, dim=-1)
    n_ad = torch.sum(ad * ad, dim=-1)
    r_ab = p_ab / n_ab.clamp_min(EPS)
    r_ad = p_ad / n_ad.clamp_min(EPS)
    tol = 1e-4
    return (r_ab > -tol) & (r_ab < 1 + tol) & (r_ad > -tol) & (r_ad < 1 + tol)


def _polygon_area(vertices, mask):
    """Shoelace area of the angle-sorted valid subset of 24 candidates.

    The angle is ``atan2`` taken in f64 and rounded once to f32. torch's
    f32 ``atan2`` on the CPU differs by an ulp between vectorised and
    scalar lanes, so an f32 angle (and at a near-tie the vertex order)
    would depend on where a pair sits in the tensor; the rounded f64 angle
    does not, on the CPU or the card."""
    nv = torch.sum(mask, dim=-1)
    maskf = mask.to(vertices.dtype)[..., None]
    center = torch.sum(vertices * maskf, dim=-2, keepdim=True) / nv.clamp_min(1).to(
        vertices.dtype)[..., None, None]
    v = (vertices - center) * maskf  # invalid -> exactly (0, 0)
    ang = torch.atan2(v[..., 1].double(), v[..., 0].double()).to(v.dtype)
    ang = torch.where(mask, ang, torch.full_like(ang, 1e9))
    order = torch.argsort(ang, dim=-1, stable=True)
    sv = torch.gather(v, -2, order[..., None].expand(*order.shape, 2))
    # consecutive cross products; zero padding kills pairs past nv - 1
    cross = sv[..., :-1, 0] * sv[..., 1:, 1] - sv[..., :-1, 1] * sv[..., 1:, 0]
    total = torch.sum(cross, dim=-1)
    # closing edge (last valid -> first)
    last_idx = (nv - 1).clamp_min(0)
    last = torch.gather(sv, -2, last_idx[..., None, None].expand(*last_idx.shape, 1, 2))[..., 0, :]
    first = sv[..., 0, :]
    total = total + (last[..., 0] * first[..., 1] - last[..., 1] * first[..., 0])
    area = torch.abs(total) / 2.0
    return torch.where(nv >= 3, area, torch.zeros_like(area))


def oriented_box_intersection_2d(corners1, corners2):
    """Intersection area of two rotated rectangles given (..., 4, 2) corners."""
    inters, m_inter = _edge_intersections(corners1, corners2)
    c12 = _corners_in_box(corners1, corners2)
    c21 = _corners_in_box(corners2, corners1)
    vertices = torch.cat([corners1, corners2, inters], dim=-2)
    mask = torch.cat([c12, c21, m_inter], dim=-1)
    return _polygon_area(vertices, mask)


def _iou_2d(corners1, corners2, area1, area2):
    """(iou, union) from corners and areas that broadcast together."""
    shape = torch.broadcast_shapes(corners1.shape, corners2.shape)
    corners1, corners2 = corners1.expand(shape), corners2.expand(shape)
    inter = oriented_box_intersection_2d(corners1, corners2)
    # the intersection of two convex regions cannot exceed either area;
    # non-positive boxes get IoU 0
    valid = (area1 > 0) & (area2 > 0)
    inter = torch.minimum(inter.clamp_min(0.0), torch.minimum(area1, area2))
    u = (area1 + area2 - inter).clamp_min(EPS)
    iou = torch.where(valid, inter / u, torch.zeros_like(inter))
    return iou, u


def cal_iou(box1, box2):
    """2D rotated IoU for (..., 5) boxes whose leading dims broadcast
    (``(N, 1, 5)`` vs ``(1, M, 5)`` -> ``(N, M)``). Returns (iou, corners1,
    corners2, union). Corners are computed once per box, then broadcast:
    the same arithmetic per pair as broadcasting the boxes first."""
    corners1 = box2corners(box1)
    corners2 = box2corners(box2)
    area1 = box1[..., 2] * box1[..., 3]
    area2 = box2[..., 2] * box2[..., 3]
    iou, u = _iou_2d(corners1, corners2, area1, area2)
    shape = iou.shape + (4, 2)
    return iou, corners1.expand(shape), corners2.expand(shape), u


def _split_3d(box3d):
    box2d = box3d[..., [0, 1, 3, 4, 6]]
    zmin = box3d[..., 2] - box3d[..., 5] * 0.5
    zmax = box3d[..., 2] + box3d[..., 5] * 0.5
    return box2d, zmin, zmax


def _iou_3d(iou_2d, u, zmin1, zmax1, zmin2, zmax2, v1, v2):
    """(3D IoU, 3D union)."""
    z_overlap = (torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)).clamp_min(0.0)
    inter_3d = iou_2d * u * z_overlap
    # same convexity bound as cal_iou: keeps IoU in [0, 1] for degenerate
    # boxes instead of inter / EPS blow-ups
    valid = (v1 > 0) & (v2 > 0)
    inter_3d = torch.minimum(inter_3d.clamp_min(0.0), torch.minimum(v1, v2))
    u3d = (v1 + v2 - inter_3d).clamp_min(EPS)
    return torch.where(valid, inter_3d / u3d, torch.zeros_like(inter_3d)), u3d


def _volume(box3d):
    return box3d[..., 3] * box3d[..., 4] * box3d[..., 5]


def cal_iou_3d(box3d1: torch.Tensor, box3d2: torch.Tensor, verbose: bool = False):
    """3D rotated IoU for (..., 7) [x, y, z, w, l, h, theta] boxes whose
    leading dims broadcast. ``verbose`` also returns the 2D corners of both,
    the z extent of their union and the 3D union: (iou, corners1, corners2,
    z_range, union)."""
    box1, zmin1, zmax1 = _split_3d(box3d1)
    box2, zmin2, zmax2 = _split_3d(box3d2)
    iou_2d, c1, c2, u = cal_iou(box1, box2)
    iou3d, u3d = _iou_3d(iou_2d, u, zmin1, zmax1, zmin2, zmax2,
                         _volume(box3d1), _volume(box3d2))
    if verbose:
        z_range = (torch.maximum(zmax1, zmax2) - torch.minimum(zmin1, zmin2)).clamp_min(0.0)
        return iou3d, c1, c2, z_range, u3d
    return iou3d


def pairwise_iou_3d(a: torch.Tensor, b: torch.Tensor,
                    chunk_pairs: int = CHUNK_PAIRS) -> torch.Tensor:
    """``(N, M)`` rotated IoU of ``(N, 7)`` against ``(M, 7)`` boxes, equal
    to ``cal_iou_3d(a[:, None], b[None])`` bit for bit, computed in chunks
    of about ``chunk_pairs`` pairs (whole rows)."""
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n, m), dtype=torch.result_type(a, b), device=a.device)
    if n == 0 or m == 0:
        return out
    box_a, zmin_a, zmax_a = _split_3d(a)
    box_b, zmin_b, zmax_b = _split_3d(b)
    ca, cb = box2corners(box_a), box2corners(box_b)
    area_a, area_b = box_a[:, 2] * box_a[:, 3], box_b[:, 2] * box_b[:, 3]
    vol_a, vol_b = _volume(a), _volume(b)
    rows = max(1, chunk_pairs // m)
    for r0 in range(0, n, rows):
        r = slice(r0, min(r0 + rows, n))
        iou_2d, u = _iou_2d(ca[r, None], cb[None], area_a[r, None], area_b[None])
        out[r] = _iou_3d(iou_2d, u, zmin_a[r, None], zmax_a[r, None],
                         zmin_b[None], zmax_b[None], vol_a[r, None], vol_b[None])[0]
    return out


# enclosing boxes for the GIoU / DIoU losses: (w, h) of a rectangle holding
# the 8 corners of both boxes


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last dim, as it differentiates."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def enclosing_box_aligned(corners1, corners2):
    c = torch.cat([corners1, corners2], dim=-2)
    w = c[..., 0].amax(dim=-1) - c[..., 0].amin(dim=-1)
    h = c[..., 1].amax(dim=-1) - c[..., 1].amin(dim=-1)
    return w, h


def enclosing_box_pca(corners1, corners2):
    """Along the principal axes of the 8 corners. The covariance's products
    are written out in f32 (the JAX einsum runs at HIGHEST precision)."""
    c = torch.cat([corners1, corners2], dim=-2)  # (..., 8, 2)
    c = c - c.mean(dim=-2, keepdim=True)
    a = torch.sum(c[..., 0] * c[..., 0], dim=-1)
    b = torch.sum(c[..., 1] * c[..., 1], dim=-1)
    cc = torch.sum(c[..., 0] * c[..., 1], dim=-1)
    # EPS floor: sqrt'(0) = inf would NaN the gradient at collinear corners
    delta = torch.sqrt((a * a + 4 * cc * cc - 2 * a * b + b * b).clamp_min(EPS))
    cc_safe = torch.where(torch.abs(cc) < EPS, torch.full_like(cc, EPS), cc)
    one = torch.ones_like(a)
    v1 = torch.stack([(a - b - delta) / (2 * cc_safe), one], dim=-1)
    v2 = torch.stack([(a - b + delta) / (2 * cc_safe), one], dim=-1)
    v1 = v1 / _norm(v1)
    v2 = v2 / _norm(v2)
    p1 = torch.sum(c * v1[..., None, :], dim=-1)
    p2 = torch.sum(c * v2[..., None, :], dim=-1)
    w = p1.amax(dim=-1) - p1.amin(dim=-1)
    h = p2.amax(dim=-1) - p2.amin(dim=-1)
    return w, h


def _hull_edge_pairs():
    """The 24 corner pairs that can be an edge of the 8 corners' convex
    hull: all 28 pairs of ``triu_indices(8, 1)`` but the 4 box diagonals."""
    skip = {(0, 2), (1, 3), (5, 7), (4, 6)}
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8) if (i, j) not in skip]
    return [i for i, _ in pairs], [j for _, j in pairs]


_PAIR_I, _PAIR_J = _hull_edge_pairs()


def smallest_bounding_box(corners1, corners2):
    """Minimum-area rectangle holding the 8 corners: it lies along a hull
    edge, so every candidate pair's direction is tried (the first of equal
    areas wins, as ``jnp.argmin``)."""
    pts = torch.cat([corners1, corners2], dim=-2)  # (..., 8, 2)
    a = pts[..., _PAIR_I, :]  # (..., 24, 2)
    d = pts[..., _PAIR_J, :] - a
    norm = _norm(d).clamp_min(EPS)
    u = d / norm  # edge direction
    n = torch.stack([-u[..., 1], u[..., 0]], dim=-1)  # its normal
    rel = pts[..., None, :, :] - a[..., :, None, :]  # (..., 24, 8, 2)
    pu = torch.sum(rel * u[..., :, None, :], dim=-1)
    pn = torch.sum(rel * n[..., :, None, :], dim=-1)
    w = pu.amax(dim=-1) - pu.amin(dim=-1)  # (..., 24)
    h = pn.amax(dim=-1) - pn.amin(dim=-1)
    areas = torch.where(norm[..., 0] < 1e-6, torch.full_like(w, torch.inf), w * h)
    best = areas.argmin(dim=-1, keepdim=True)
    return torch.gather(w, -1, best)[..., 0], torch.gather(h, -1, best)[..., 0]


def enclosing_box(corners1, corners2, enclosing_type: str = "smallest"):
    if enclosing_type == "aligned":
        return enclosing_box_aligned(corners1, corners2)
    if enclosing_type == "pca":
        return enclosing_box_pca(corners1, corners2)
    if enclosing_type == "smallest":
        return smallest_bounding_box(corners1, corners2)
    raise ValueError(f"Unknown enclosing type: {enclosing_type}")


def cal_giou_3d(box3d1, box3d2, enclosing_type: str = "smallest"):
    """3D rotated GIoU loss: (loss, giou, iou)."""
    iou3d, c1, c2, z_range, u3d = cal_iou_3d(box3d1, box3d2, verbose=True)
    w, h = enclosing_box(c1, c2, enclosing_type)
    v_c = (z_range * w * h).clamp_min(EPS)
    giou_loss = 1.0 - iou3d + (v_c - u3d) / v_c
    return giou_loss, 1.0 - giou_loss, iou3d


def cal_diou_3d(box3d1, box3d2, enclosing_type: str = "smallest"):
    """3D rotated DIoU loss: (loss, iou)."""
    iou3d, c1, c2, z_range, _ = cal_iou_3d(box3d1, box3d2, verbose=True)
    w, h = enclosing_box(c1, c2, enclosing_type)
    d2 = torch.sum((box3d1[..., 0:3] - box3d2[..., 0:3]) ** 2, dim=-1)
    c2_ = (w * w + h * h + z_range * z_range).clamp_min(EPS)
    return 1.0 - iou3d + d2 / c2_, iou3d


def aabb2obb_3d(aabb: torch.Tensor) -> torch.Tensor:
    """AABB ``(..., 6)`` -> canonical OBB ``(..., 7)``: ``w >= l``, theta 0,
    or pi / 2 where the AABB is longer along y. (``ops/boxes.py``'s
    ``aabb2obb_3d`` keeps the AABB's extents and theta 0, as the JAX
    package's ``ops/boxes.py`` one does.)"""
    lo, hi = aabb[..., 0:3], aabb[..., 3:6]
    center = 0.5 * (lo + hi)
    whd = hi - lo
    w_t, l_t, h = whd[..., 0], whd[..., 1], whd[..., 2]
    rot = w_t < l_t
    w = torch.where(rot, l_t, w_t)
    l = torch.where(rot, w_t, l_t)
    theta = torch.where(rot, torch.full_like(w, torch.pi / 2), torch.zeros_like(w))
    return torch.cat([center, torch.stack([w, l, h, theta], dim=-1)], dim=-1)
