"""Box-delta coders (PyTorch counterpart of ``instance_nerf_tpu.ops.coders``):
``AABBCoder``, the 7-parameter ``RotatedCoder`` (the legacy two-stage
path) and the midpoint-offset OBB coder."""
from __future__ import annotations

import math

import torch

from instance_nerf_tpu_torch.ops.boxes import obb2hbb, obb2poly, rectpoly2obb

BBOX_XFORM_CLIP = math.log(2000.0)


class AABBCoder:
    """(dx, dy, dz, dw, dh, dd) deltas between AABBs."""

    def __init__(self, bbox_xform_clip: float = BBOX_XFORM_CLIP):
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor,
               proposals: torch.Tensor) -> torch.Tensor:
        """Deltas mapping ``proposals`` -> ``reference_boxes`` (both (..., 6))."""
        ex_whd = proposals[..., 3:6] - proposals[..., 0:3]
        ex_ctr = proposals[..., 0:3] + 0.5 * ex_whd
        gt_whd = reference_boxes[..., 3:6] - reference_boxes[..., 0:3]
        gt_ctr = reference_boxes[..., 0:3] + 0.5 * gt_whd
        ex_whd = ex_whd.clamp_min(1e-6)
        d_ctr = (gt_ctr - ex_ctr) / ex_whd
        d_whd = torch.log(gt_whd.clamp_min(1e-6) / ex_whd)
        return torch.cat([d_ctr, d_whd], dim=-1)

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Apply (..., 6) deltas to (..., 6) reference boxes."""
        whd = boxes[..., 3:6] - boxes[..., 0:3]
        ctr = boxes[..., 0:3] + 0.5 * whd
        d_ctr = rel_codes[..., 0:3]
        d_whd = rel_codes[..., 3:6].clamp_max(self.bbox_xform_clip)
        pred_ctr = d_ctr * whd + ctr
        pred_whd = torch.exp(d_whd) * whd
        half = 0.5 * pred_whd
        return torch.cat([pred_ctr - half, pred_ctr + half], dim=-1)


class RotatedCoder:
    """7-param OBB deltas: the center offset in the anchor's rotated frame,
    log sizes, and the angle difference over 2*pi, wrapped into
    (-pi/2, pi/2] at decode (``%`` is ``jnp.remainder``, so
    ``torch.remainder``, the sign of the divisor)."""

    def __init__(self, bbox_xform_clip: float = BBOX_XFORM_CLIP):
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, gt_rois: torch.Tensor, ex_rois: torch.Tensor) -> torch.Tensor:
        """(..., 7) gt + (..., 7) anchors -> (..., 7) deltas."""
        coord = gt_rois[..., 0:3] - ex_rois[..., 0:3]
        c, s = torch.cos(ex_rois[..., 6]), torch.sin(ex_rois[..., 6])
        ew = ex_rois[..., 3].clamp_min(1e-6)
        eh = ex_rois[..., 4].clamp_min(1e-6)
        ed = ex_rois[..., 5].clamp_min(1e-6)
        dx = (c * coord[..., 0] + s * coord[..., 1]) / ew
        dy = (-s * coord[..., 0] + c * coord[..., 1]) / eh
        dz = coord[..., 2] / ed
        dw = torch.log(gt_rois[..., 3].clamp_min(1e-6) / ew)
        dh = torch.log(gt_rois[..., 4].clamp_min(1e-6) / eh)
        dd = torch.log(gt_rois[..., 5].clamp_min(1e-6) / ed)
        da = (gt_rois[..., 6] - ex_rois[..., 6]) / (2 * math.pi)
        return torch.stack([dx, dy, dz, dw, dh, dd, da], dim=-1)

    def decode(self, deltas: torch.Tensor, ex_rois: torch.Tensor) -> torch.Tensor:
        """(..., 7) deltas + (..., 7) anchors -> (..., 7) OBBs."""
        c, s = torch.cos(ex_rois[..., 6]), torch.sin(ex_rois[..., 6])
        dw = deltas[..., 3].clamp_max(self.bbox_xform_clip)
        dh = deltas[..., 4].clamp_max(self.bbox_xform_clip)
        dd = deltas[..., 5].clamp_max(self.bbox_xform_clip)
        w, h, d = ex_rois[..., 3], ex_rois[..., 4], ex_rois[..., 5]
        px = deltas[..., 0] * w * c - deltas[..., 1] * h * s + ex_rois[..., 0]
        py = deltas[..., 0] * w * s + deltas[..., 1] * h * c + ex_rois[..., 1]
        pz = deltas[..., 2] * d + ex_rois[..., 2]
        pw, ph, pd = torch.exp(dw) * w, torch.exp(dh) * h, torch.exp(dd) * d
        pa = torch.remainder((2 * math.pi) * deltas[..., 6] + ex_rois[..., 6], math.pi)
        pa = torch.where(pa > math.pi / 2, pa - math.pi, pa)
        return torch.stack([px, py, pz, pw, ph, pd, pa], dim=-1)


class MidpointOffsetCoder:
    """8-param OBB deltas (dx, dy, dz, dw, dh, dd, da, db) against AABB
    anchors. ``means`` / ``stds`` are f32, as the JAX package's arrays."""

    def __init__(self, means=(0.0,) * 8, stds=(1.0,) * 8):
        self.means = torch.tensor(means, dtype=torch.float32)
        self.stds = torch.tensor(stds, dtype=torch.float32)

    def encode(self, gt_bboxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """gt OBB (..., 7) + AABB anchors (..., 6) -> deltas (..., 8)."""
        p_ctr = 0.5 * (anchors[..., 0:3] + anchors[..., 3:6])
        p_whd = (anchors[..., 3:6] - anchors[..., 0:3]).clamp_min(1e-6)
        gz, gd = gt_bboxes[..., 2], gt_bboxes[..., 5]
        gt_2d = torch.cat([gt_bboxes[..., 0:2], gt_bboxes[..., 3:5],
                           gt_bboxes[..., 6:7]], dim=-1)
        hbb = obb2hbb(gt_2d)
        poly = obb2poly(gt_2d)
        gx = 0.5 * (hbb[..., 0] + hbb[..., 2])
        gy = 0.5 * (hbb[..., 1] + hbb[..., 3])
        gw = (hbb[..., 2] - hbb[..., 0]).clamp_min(1e-6)
        gh = (hbb[..., 3] - hbb[..., 1]).clamp_min(1e-6)
        x_coor, y_coor = poly[..., 0::2], poly[..., 1::2]
        y_min = y_coor.amin(dim=-1, keepdim=True)
        x_max = x_coor.amax(dim=-1, keepdim=True)
        # midpoint of the top edge / right edge (the reference's -1000 trick)
        far = torch.full_like(x_coor, -1000.0)
        ga = torch.where(torch.abs(y_coor - y_min) > 0.1, far, x_coor).amax(dim=-1)
        gb = torch.where(torch.abs(x_coor - x_max) > 0.1, far, y_coor).amax(dim=-1)
        dx = (gx - p_ctr[..., 0]) / p_whd[..., 0]
        dy = (gy - p_ctr[..., 1]) / p_whd[..., 1]
        dz = (gz - p_ctr[..., 2]) / p_whd[..., 2]
        dw = torch.log(gw / p_whd[..., 0])
        dh = torch.log(gh / p_whd[..., 1])
        dd = torch.log(gd.clamp_min(1e-6) / p_whd[..., 2])
        da = (ga - gx) / gw
        db = (gb - gy) / gh
        deltas = torch.stack([dx, dy, dz, dw, dh, dd, da, db], dim=-1)
        return (deltas - self.means.to(deltas.device)) / self.stds.to(deltas.device)

    def decode(self, pred_deltas: torch.Tensor, anchors: torch.Tensor,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
        """deltas (..., 8) + AABB anchors (..., 6) -> OBB (..., 7)."""
        dev = pred_deltas.device
        deltas = pred_deltas * self.stds.to(dev) + self.means.to(dev)
        dx, dy, dz, dw, dh, dd, da, db = deltas.unbind(-1)
        max_ratio = abs(math.log(wh_ratio_clip))
        dw = dw.clamp(-max_ratio, max_ratio)
        dh = dh.clamp(-max_ratio, max_ratio)
        dd = dd.clamp(-max_ratio, max_ratio)

        p_ctr = 0.5 * (anchors[..., 0:3] + anchors[..., 3:6])
        p_whd = anchors[..., 3:6] - anchors[..., 0:3]
        gw = p_whd[..., 0] * torch.exp(dw)
        gh = p_whd[..., 1] * torch.exp(dh)
        gd = p_whd[..., 2] * torch.exp(dd)
        gx = p_ctr[..., 0] + p_whd[..., 0] * dx
        gy = p_ctr[..., 1] + p_whd[..., 1] * dy
        gz = p_ctr[..., 2] + p_whd[..., 2] * dz

        x1, y1 = gx - gw * 0.5, gy - gh * 0.5
        x2, y2 = gx + gw * 0.5, gy + gh * 0.5
        da = da.clamp(-0.5, 0.5)
        db = db.clamp(-0.5, 0.5)
        ga, _ga = gx + da * gw, gx - da * gw
        gb, _gb = gy + db * gh, gy - db * gh
        polys = torch.stack([ga, y1, x2, gb, _ga, y2, x1, _gb], dim=-1)

        # rectangularize: rescale the vertices to a common diagonal length
        center = torch.stack([gx, gy] * 4, dim=-1)
        cp = polys - center
        diag = torch.sqrt(cp[..., 0::2] ** 2 + cp[..., 1::2] ** 2)
        max_diag = diag.amax(dim=-1, keepdim=True)
        scale = max_diag / diag.clamp_min(1e-8)
        cp = cp * torch.repeat_interleave(scale, 2, dim=-1)
        obb2d = rectpoly2obb(cp + center)  # (..., 5)
        return torch.cat([obb2d[..., 0:2], gz[..., None], obb2d[..., 2:4],
                          gd[..., None], obb2d[..., 4:5]], dim=-1)
