"""FAST-9/16 dense score map and 3x3 NMS.

Port of ``pointslot_tpu/ops/fast.py``. The score is min/max/subtract only,
so it equals the reference exactly in float32. The 16 ring differences are
stacked on one leading axis and the circular arc min/max is built by
doubling with ``torch.roll`` over that axis (2 -> 4 -> 8 -> 9), a handful
of tensor ops per side instead of 64 per side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 points, (dy, dx), clockwise from top.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """img (..., H, W) float32 -> (..., H, W) float32 FAST-9 scores: 0 where
    not a corner at `threshold`, else the largest threshold at which the
    pixel is still a corner. The 3px border is zero."""
    h, w = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    d = torch.stack([padded[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] - img
                     for dy, dx in CIRCLE])            # (16, ..., H, W)

    def rot(x, s):          # rot(x, s)[i] == x[(i + s) % 16]
        return torch.roll(x, -s, dims=0)

    # bright side: max over the 16 arcs of (min of d over the arc)
    mn2 = torch.minimum(d, rot(d, 1))
    mn4 = torch.minimum(mn2, rot(mn2, 2))
    mn8 = torch.minimum(mn4, rot(mn4, 4))
    bright = torch.minimum(mn8, rot(d, 8)).amax(dim=0)
    # dark side: max over arcs of min(-d) = -(min over arcs of max(d))
    mx2 = torch.maximum(d, rot(d, 1))
    mx4 = torch.maximum(mx2, rot(mx2, 2))
    mx8 = torch.maximum(mx4, rot(mx4, 4))
    dark = -torch.maximum(mx8, rot(d, 8)).amin(dim=0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    border[3:h - 3, 3:w - 3] = True
    return score * border


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima in a 3x3 neighbourhood; ties go to the earlier
    pixel in raster order. Leading batch dims pass through."""
    h, w = score.shape[-2:]
    padded = F.pad(score, (1, 1, 1, 1), value=-1.0)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            n = padded[..., dy: dy + h, dx: dx + w]
            if dy < 1 or (dy == 1 and dx < 1):
                keep &= score > n
            else:
                keep &= score >= n
    return torch.where(keep, score, torch.zeros_like(score))
