"""3D RoIAlign (PyTorch counterpart of ``instance_nerf_tpu.ops.roi_align``).

Channels-last features ``(N, W, L, H, C)``; torchvision ``aligned=False``
coordinates (sample for output cell i at ``x1*scale + (i+0.5)*bin``, voxel
centers on integer coordinates); samples outside ``[-1, size]`` weigh 0,
the rest clamp to the grid. The 8 corners are gathered from the flattened
grid with flat indices clipped to its range, as ``take(mode="clip")``
does, so an out-of-range batch index reads finite values.
"""
from __future__ import annotations

import torch


def roi_align_3d(
    features: torch.Tensor,
    rois: torch.Tensor,
    roi_batch: torch.Tensor,
    out_size: tuple[int, int, int],
    spatial_scale: float = 1.0,
    sampling_ratio: int = 1,
) -> torch.Tensor:
    """Average-pooled trilinear RoIAlign -> ``(K, ow, ol, oh, C)``.

    ``rois`` is ``(K, 6)`` in input-grid coordinates (before
    ``spatial_scale``), ``roi_batch`` ``(K,)`` int. The sum runs in the
    feature dtype, with the corner weights cast to it.
    """
    ow, ol, oh = out_size
    s = max(int(sampling_ratio), 1)
    n, w, l, h, c = features.shape
    k = rois.shape[0]
    dev = features.device
    integer_input = not features.dtype.is_floating_point
    cdt = torch.float32  # coordinate dtype (JAX promotes them to f32)

    lo = rois[:, 0:3].to(cdt) * spatial_scale
    hi = rois[:, 3:6].to(cdt) * spatial_scale
    bin_sz = (hi - lo) / torch.tensor([ow, ol, oh], dtype=cdt, device=dev)

    def axis_coords(axis: int, res: int) -> torch.Tensor:
        cell = torch.arange(res * s, dtype=cdt, device=dev)
        offs = torch.div(cell, s, rounding_mode="floor") + ((cell % s) + 0.5) / s
        return lo[:, axis, None] + offs[None, :] * bin_sz[:, axis, None]

    def corner(coord: torch.Tensor, size: int):
        in_range = (coord >= -1.0) & (coord <= size)
        cc = coord.clamp(0.0, size - 1)
        c0 = torch.floor(cc)
        frac = cc - c0
        i0 = c0.to(torch.int64)
        i1 = (i0 + 1).clamp_max(size - 1)
        return i0, i1, frac, in_range.to(coord.dtype)

    x0, x1, fx, mx = corner(axis_coords(0, ow), w)
    y0, y1, fy, my = corner(axis_coords(1, ol), l)
    z0, z1, fz, mz = corner(axis_coords(2, oh), h)

    flat = features.reshape(n * w * l * h, c)
    base = roi_batch.to(torch.int64) * w  # (K,)
    last = n * w * l * h - 1

    def gather(ix, iy, iz):
        idx = (((base[:, None] + ix) * l)[:, :, None, None]
               + iy[:, None, :, None]) * h + iz[:, None, None, :]
        vals = flat[idx.reshape(-1).clamp(0, last)]
        return vals.reshape(k, ix.shape[1], iy.shape[1], iz.shape[1], c)

    wx = ((1.0 - fx) * mx, fx * mx)
    wy = ((1.0 - fy) * my, fy * my)
    wz = ((1.0 - fz) * mz, fz * mz)

    out = None
    for ix, wxs in zip((x0, x1), wx):
        for iy, wys in zip((y0, y1), wy):
            for iz, wzs in zip((z0, z1), wz):
                vals = gather(ix, iy, iz)
                if integer_input:
                    vals = vals.to(torch.float32)
                wgt = (wxs[:, :, None, None] * wys[:, None, :, None]
                       * wzs[:, None, None, :])[..., None]
                term = vals * wgt.to(vals.dtype)
                out = term if out is None else out + term

    if s > 1:
        out = out.reshape(k, ow, s, ol, s, oh, s, c).mean(dim=(2, 4, 6))
    return out


def project_masks_on_boxes(gt_masks: torch.Tensor, boxes: torch.Tensor,
                           mask_size: tuple[int, int, int]) -> torch.Tensor:
    """Crop ground-truth voxel masks to boxes at mask resolution (the
    reference's ``roi_align_3d`` of the binary mask grid, one mask per roi):
    ``gt_masks`` ``(K, W, L, H)`` float or bool, mask i cropped by box i of
    ``boxes`` ``(K, 6)`` -> ``(K, mw, ml, mh)`` f32 in [0, 1]."""
    k = gt_masks.shape[0]
    feats = gt_masks[..., None].to(torch.float32)
    out = roi_align_3d(feats, boxes, torch.arange(k, device=boxes.device), mask_size,
                       spatial_scale=1.0)
    return out[..., 0]
