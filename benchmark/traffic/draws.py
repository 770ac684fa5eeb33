"""A field cell's inputs, made from ``--seed`` and handed the same to the
program and to the plain reference: the scenes (``scenes.py``) and what
the first call of the window's entry draws.

The benchmark draws the first call itself, on the device from a
``torch.Generator`` of its own, so that neither side's random streams
decide what is compared:

* each step's view and pixel ids ``(B, R)`` and stratified jitter
  ``(B, R, S)``, or ``(B, R, 1)`` where the configuration jitters a ray
  once (``ray_jitter``);
* the occupancy grid the first call starts from, ``(B, G, G, G)``: blocks
  of cells pruned at random and single cells pruned inside the kept
  blocks, so that the occupancy lookups, the coarse selection and the fine
  mask all select;
* the draws of the refresh that ends the call: the jitter of every cell
  ``(B, G^3, 3)``, or with ``occ_subsample`` under 1 the cells re-sampled
  ``(B, M)`` and their jitter ``(B, M, 3)``.

Every seed draws the same sizes; only the values move.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.plain_field import rays
from benchmark.traffic.scenes import make_scenes

# the benchmark's own stream, apart from the weights' (``seed`` itself)
STREAM = 1 << 40
# the start grid: blocks of cells kept with this share, single cells
# inside a kept block pruned with this share
BLOCK_KEPT, CELL_PRUNED = 0.6, 0.25
OCCUPIED, PRUNED = 1e3, 1e-3


class Inputs(NamedTuple):
    scenes: list  # scenes.Scene, one a field
    hw: tuple
    poses: torch.Tensor  # (B, V, 4, 4)
    intrinsics: torch.Tensor  # (B, 4)
    images: torch.Tensor  # (B, V, H * W, 3) the training targets (uint8 levels with device_data)
    views: torch.Tensor  # (steps, B, R)
    pixels: torch.Tensor  # (steps, B, R)
    jitter: torch.Tensor  # (steps, B, R, S or 1)
    grid: torch.Tensor  # (B, G, G, G) the occupancy the first call starts from
    cells: Optional[torch.Tensor]  # (B, M) cells the refresh re-samples; None: all
    cell_jitter: torch.Tensor  # (B, G^3 or M, 3)


def start_grid(b: int, g: int, gen, device) -> torch.Tensor:
    nb = min(8, g)
    f = g // nb
    blocks = torch.rand((b, nb, nb, nb), generator=gen, device=device) < BLOCK_KEPT
    kept = blocks[:, :, None, :, None, :, None].expand(b, nb, f, nb, f, nb, f).reshape(b, g, g, g)
    cells = torch.rand((b, g, g, g), generator=gen, device=device) >= CELL_PRUNED
    return torch.where(kept & cells, OCCUPIED, PRUNED).to(torch.float32)


@torch.no_grad()
def make(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    b = cfg.get("n_scenes", 1)
    scenes = make_scenes(seed, b, traffic, device)
    h, w = scenes[0].hw
    im = np.stack([s.images.reshape(-1, h * w, 3) for s in scenes]).astype(np.float32)
    if cfg.get("device_data"):  # the targets as the uint8 store holds them
        im = np.round(np.clip(im, 0.0, 1.0) * 255.0).astype(np.uint8).astype(np.float32) / 255.0
    poses = torch.as_tensor(np.stack([s.poses for s in scenes]), device=device)
    intr = torch.as_tensor(np.stack([np.asarray(s.intrinsics, np.float32) for s in scenes]),
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seed + STREAM)
    steps, r, v = traffic["steps_per_call"], cfg["n_rays"], traffic["n_views"]
    views = torch.randint(0, v, (steps, b, r), generator=gen, device=device)
    pixels = torch.randint(0, h * w, (steps, b, r), generator=gen, device=device)
    per_ray = 1 if cfg.get("ray_jitter") else cfg["n_samples"]
    jitter = torch.rand((steps, b, r, per_ray), generator=gen, device=device)
    g = cfg["occ_res"]
    grid = start_grid(b, g, gen, device)
    sub = cfg.get("occ_subsample", 1.0)
    cells = None
    m = g ** 3
    if sub < 1.0:
        m = max(1, int(g ** 3 * sub))
        cells = torch.randint(0, g ** 3, (b, m), generator=gen, device=device)
    cell_jitter = torch.rand((b, m, 3), generator=gen, device=device)
    return Inputs(scenes, (h, w), poses, intr, torch.as_tensor(im, device=device), views,
                  pixels, jitter, grid, cells, cell_jitter)


def batch(inp: Inputs, step: int):
    """Step ``step``'s ``(o, d, target rgb, jitter)``, each ``(B, R, ...)``."""
    v, pix = inp.views[step], inp.pixels[step]
    o, d = rays(inp.poses, inp.intrinsics, inp.hw, v, pix)
    bidx = torch.arange(v.shape[0], device=v.device)[:, None]
    return o, d, inp.images[bidx, v, pix], inp.jitter[step]
