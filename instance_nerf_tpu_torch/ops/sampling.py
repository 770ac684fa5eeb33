"""Target assignment (matcher) and balanced sampling with static shapes
(PyTorch counterpart of ``instance_nerf_tpu.ops.sampling``).

``match_proposals`` is torchvision's ``Matcher`` as masks: BELOW/BETWEEN
sentinels and the recovery of low-quality matches. ``balanced_sample``
draws a fixed budget with a target positive fraction by ranking uniforms.
The JAX package draws those uniforms from a key; here they come in as a
tensor ``(..., 2, N)`` (positives' row, then negatives'), or from a
``torch.Generator``. Given the JAX key's uniforms the masks are identical:
the ranks argsort the same values stably, as ``jnp.argsort`` does.
Every function takes leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_proposals(
    match_quality_matrix: torch.Tensor,
    high_threshold: float,
    low_threshold: float,
    allow_low_quality_matches: bool = False,
    gt_valid: torch.Tensor | None = None,
    gt_best: torch.Tensor | None = None,
) -> torch.Tensor:
    """Assign each prediction the best gt (or a negative sentinel).

    ``match_quality_matrix`` is ``(..., M, N)`` gt x predictions, ``gt_valid``
    an optional ``(..., M)`` mask of padded gt rows. Returns ``(..., N)``
    int64: the matched gt index, or -1 (below low) / -2 (between). Ties go to
    the first gt, as ``jnp.argmax``. ``gt_best`` ``(..., M)``: each gt's
    best quality over all predictions, where these are only some of them
    (default: the best over these)."""
    quality = match_quality_matrix
    if gt_valid is not None:
        quality = torch.where(gt_valid[..., :, None], quality, torch.full_like(quality, -1.0))
    matched_vals = quality.amax(dim=-2)
    all_matches = quality.argmax(dim=-2)
    matches = torch.where(
        matched_vals < low_threshold, torch.full_like(all_matches, BELOW_LOW_THRESHOLD),
        torch.where(matched_vals < high_threshold,
                    torch.full_like(all_matches, BETWEEN_THRESHOLDS), all_matches))
    if allow_low_quality_matches:
        # predictions reaching a gt's best quality (ties included) get their
        # argmax gt back
        if gt_best is None:
            gt_best = quality.amax(dim=-1)
        is_best = quality == gt_best[..., None]
        if gt_valid is not None:
            is_best = is_best & gt_valid[..., :, None]
        matches = torch.where(is_best.any(dim=-2), all_matches, matches)
    return matches


class SampleResult(NamedTuple):
    pos_mask: torch.Tensor  # (..., N) bool
    neg_mask: torch.Tensor  # (..., N) bool


def _rank_within(uniforms: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """Rank of each member among the members by its uniform (non-members
    rank after every member)."""
    r = torch.where(member_mask, uniforms, torch.full_like(uniforms, torch.inf))
    order = torch.argsort(r, dim=-1, stable=True)
    ar = torch.arange(r.shape[-1], device=r.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def balanced_sample(
    matched_idxs: torch.Tensor,
    batch_size_per_image: int,
    positive_fraction: float,
    valid: torch.Tensor | None = None,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> SampleResult:
    """Sample a fixed budget with a target positive fraction.

    ``matched_idxs`` (..., N) follows the reference's labelling: >= 1
    positive, 0 negative, < 0 ignored. ``uniforms`` (..., 2, N) are the
    draws that rank the positives and the negatives; without them they are
    drawn from ``generator`` on the labels' device."""
    positive = matched_idxs >= 1
    negative = matched_idxs == 0
    if valid is not None:
        positive = positive & valid
        negative = negative & valid
    if uniforms is None:
        shape = (*matched_idxs.shape[:-1], 2, matched_idxs.shape[-1])
        uniforms = torch.rand(shape, generator=generator, device=matched_idxs.device)
    num_pos_target = int(batch_size_per_image * positive_fraction)
    num_pos = positive.sum(-1).clamp_max(num_pos_target)
    num_neg = torch.minimum(negative.sum(-1), batch_size_per_image - num_pos)
    pos_rank = _rank_within(uniforms[..., 0, :], positive)
    neg_rank = _rank_within(uniforms[..., 1, :], negative)
    return SampleResult(positive & (pos_rank < num_pos[..., None]),
                        negative & (neg_rank < num_neg[..., None]))
