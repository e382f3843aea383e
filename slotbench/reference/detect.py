"""Plain FAST, non-maximum suppression and per-cell selection, to judge which
keypoints the frontend keeps.

What the frontend of the port keeps of one image, worked out again from the
image's pyramid (``frontend.pyramid``):

- the FAST-9 score of each pixel on the 16-pixel circle of radius 3: the
  largest of, over the 16 arcs of 9 contiguous circle pixels, the least
  difference (circle pixel minus centre, or centre minus circle pixel) along
  the arc; 0 unless above the configuration's least FAST threshold, and 0 on
  the 3-pixel border;
- times the allowed-region mask where there is one, resized to the level by
  ``jax.image.resize``'s "nearest" (``nearest_index``), and 0 within 16
  pixels of the level's edge;
- 3x3 non-maximum suppression, a tie going to the pixel earlier in raster
  order;
- at most one keypoint a 16x16 cell (the cell's highest score, the earliest
  pixel among equals), and the level's budget of cells by score, a tie going
  to the earlier cell in raster order. The budgets split the configuration's
  feature count geometrically over the levels (ORB-SLAM2's
  ``ORBextractor``).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# the 16 circle pixels, (dy, dx), clockwise from the top
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
ARC = 9
EDGE = 16
CELL = 16


def level_budgets(n_features: int, n_levels: int, scale: float) -> List[int]:
    """Keypoints a level may keep: a geometric split, the last level taking
    what rounding leaves."""
    inv = 1.0 / scale
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    out = [int(round(first * inv ** l)) for l in range(n_levels - 1)]
    return out + [max(n_features - sum(out), 0)]


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source sample of each of `n_out` samples along an axis of `n_in` under
    ``jax.image.resize(..., "nearest")``: floor((i + 0.5) n_in (1 / n_out))
    in float32, the two constants folded into one float32 factor."""
    if n_in == n_out:
        return np.arange(n_out)
    factor = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * factor).astype(np.int64)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(h, w) -> FAST-9 scores, 0 where not above `threshold` and on the
    3-pixel border."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3))[0, 0]
    d = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dy, dx in CIRCLE])
    best = torch.full_like(img, float("-inf"))
    for s in range(16):
        arc = d[[(s + j) % 16 for j in range(ARC)]]
        best = torch.maximum(best, torch.maximum(arc.amin(dim=0), (-arc).amin(dim=0)))
    score = torch.where(best > threshold, best, torch.zeros_like(best))
    inner = torch.zeros_like(score, dtype=torch.bool)
    inner[3:h - 3, 3:w - 3] = True
    return torch.where(inner, score, torch.zeros_like(score))


def suppress(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: a pixel stays if it is above each
    neighbour before it in raster order and not below each after it."""
    h, w = score.shape
    pad = F.pad(score[None, None], (1, 1, 1, 1), value=-1.0)[0, 0]
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            keep &= (score > n) if (dy, dx) < (0, 0) else (score >= n)
    return torch.where(keep, score, torch.zeros_like(score))


def select_cells(score: torch.Tensor, budget: int):
    """(scores (n,), ys (n,), xs (n,)) of the kept keypoints, best first, n
    at most `budget`: each cell's best pixel, the cells by score."""
    h, w = score.shape
    hc, wc = -(-h // CELL), -(-w // CELL)
    cand = []                                   # (score, cell index, y, x)
    s = score.cpu().numpy()
    for cy in range(hc):
        for cx in range(wc):
            block = s[cy * CELL:(cy + 1) * CELL, cx * CELL:(cx + 1) * CELL]
            m = block.max()
            if m <= 0:
                continue
            iy, ix = np.argwhere(block == m)[0]      # the first in raster order
            cand.append((float(m), cy * wc + cx, cy * CELL + int(iy), cx * CELL + int(ix)))
    cand.sort(key=lambda c: (-c[0], c[1]))
    cand = cand[:budget]
    return (np.array([c[0] for c in cand], np.float64), np.array([c[2] for c in cand], np.int64),
            np.array([c[3] for c in cand], np.int64))


def detect(levels: List[torch.Tensor], budgets: List[int], threshold: float,
           gate: Optional[np.ndarray] = None) -> dict:
    """The kept keypoints of one image, level by level and best first
    within a level: level (n,), x and y in level pixels (n,), score (n,).
    `gate`: an (H, W) boolean allowed-region mask of level 0, or None."""
    H, W = levels[0].shape
    out = dict(level=[], x=[], y=[], score=[])
    for l, img in enumerate(levels):
        h, w = img.shape
        score = fast_score(img.float(), threshold)
        if gate is not None:
            g = np.asarray(gate)[nearest_index(H, h)][:, nearest_index(W, w)]
            score = score * torch.as_tensor(g, device=score.device).float()
        edge = torch.zeros_like(score, dtype=torch.bool)
        edge[EDGE:h - EDGE, EDGE:w - EDGE] = True
        score = suppress(torch.where(edge, score, torch.zeros_like(score)))
        sc, ys, xs = select_cells(score, budgets[l])
        out["level"].append(np.full(len(sc), l, np.int64))
        out["x"].append(xs)
        out["y"].append(ys)
        out["score"].append(sc)
    return {k: np.concatenate(v) for k, v in out.items()}
