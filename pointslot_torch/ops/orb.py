"""ORB feature extraction: pyramid -> FAST -> NMS -> per-cell select ->
patch gather -> intensity-centroid angle -> 7x7 blur -> steered BRIEF.

Port of ``pointslot_tpu/ops/orb.py`` (the ungated single-image path, with
the learned or the gaussian BRIEF table; a gate is applied to the score
maps by the frontend). Hazards kept in mind:

- ``lax.top_k`` breaks ties toward the lower index and ``torch.topk`` does
  not; the zero-padded cells always tie, so selection is a stable
  descending sort.
- ``lax.reduce_window`` over 16x16 cells becomes a pad (-inf for the max,
  h*w for the index min) to whole cells, a reshape and ``amax``/``amin``.
- Descriptors are (N, 8) int32 words with the same bits as the
  reference's uint32 words (bit j of word w is BRIEF pair 32 w + j).

The reference samples BRIEF pairs with one-hot interpolation matmuls
because the TPU has no fast gather; here the four bilinear taps are
gathered, with the same weights in the same order (rows, then columns).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pointslot_torch.config import ORBConfig
from pointslot_torch.convert import to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops import fast as fast_ops
from pointslot_torch.ops import pyramid as pyr_ops
from pointslot_torch.ops.brief_pattern import LEARNED_PATTERN
from pointslot_torch.ops.patch import PATCH, gather_patches

HALF_PATCH = 15          # orientation patch radius (31x31 patch)
EDGE_MARGIN = 16         # no keypoints closer than this to a level border
CELL = 16                # selection cell size: at most one keypoint per cell
PATTERN_BITS = 256


class FeatureSet(NamedTuple):
    """SoA feature batch; all tensors have leading dim N = capacity."""

    xy: torch.Tensor        # (N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST score
    angle: torch.Tensor     # (N,) float32 radians
    level: torch.Tensor     # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 8) int32 words of the 256-bit descriptor
    valid: torch.Tensor     # (N,) bool


def brief_pattern(kind: str = "learned") -> np.ndarray:
    """(256, 4) int32 sample-pair offsets (xa, ya, xb, yb), radius <= 13:
    the learned ORB table, or isotropic-Gaussian pairs (the original BRIEF
    construction, the object frontend's default) drawn from numpy's
    generator with seed 1234, exactly as the reference draws them."""
    if kind == "learned":
        return LEARNED_PATTERN
    if kind != "gaussian":
        raise ValueError(f"unknown BRIEF pattern {kind!r}")
    rng = np.random.default_rng(1234)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(PATTERN_BITS * 2, 2))
    r = np.linalg.norm(pts, axis=1)
    scale = np.minimum(1.0, 13.0 / np.maximum(r, 1e-6))
    pts = np.round(pts * scale[:, None]).astype(np.int32)
    return np.concatenate([pts[:PATTERN_BITS], pts[PATTERN_BITS:]], axis=1)


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level keypoint budget (geometric split)."""
    inv = 1.0 / scale_factor
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    budgets = []
    acc = 0
    for lvl in range(n_levels - 1):
        k = int(round(first * inv ** lvl))
        budgets.append(k)
        acc += k
    budgets.append(max(n_features - acc, 0))
    return budgets


@functools.lru_cache(maxsize=2)
def _blur_band(P: int) -> np.ndarray:
    """(P, P) banded matrix of the 7-tap sigma-2 Gaussian; row r holds
    kernel[r' - r + 3], zero outside: a SAME conv with zero padding."""
    k = pyr_ops.gaussian_kernel(7, 2.0)
    B = np.zeros((P, P), np.float32)
    for r in range(P):
        for t in range(-3, 4):
            if 0 <= r + t < P:
                B[r, r + t] = k[t + 3]
    return B


def _moment_weights(patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """(patch, patch) weight images for m10/m01 with the circular mask."""
    half = patch // 2
    ys, xs = np.mgrid[0:patch, 0:patch]
    dy = (ys - half).astype(np.float32)
    dx = (xs - half).astype(np.float32)
    mask = (dx ** 2 + dy ** 2) <= (HALF_PATCH + 0.5) ** 2
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, bit j of word w = bits[32 w + j]."""
    K = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(K, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


class ORBExtractor:
    """ORB extraction at fixed image geometry on one device."""

    def __init__(self, height: int, width: int, config: Optional[ORBConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config or ORBConfig()
        cfg = self.config
        dev = self.device
        self.height, self.width = height, width
        self.shapes = pyr_ops.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.capacity = sum(self.budgets)
        pat = brief_pattern(cfg.brief_pattern)
        # interleave a|b sample points: one (512, 2) table
        self._pat = torch.from_numpy(
            np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0).astype(np.float32)).to(dev)
        wx, wy = _moment_weights(PATCH)
        self._wxy = torch.from_numpy(
            np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)).to(dev)   # (2304, 2)
        self._band = torch.from_numpy(_blur_band(PATCH)).to(dev)
        self._mats = pyr_ops.pyramid_mats(height, width, cfg.n_levels,
                                          cfg.scale_factor, dev)
        self._level_scale = [float(np.float32(cfg.scale_factor ** lvl))
                             for lvl in range(cfg.n_levels)]
        m = EDGE_MARGIN
        self._borders = []
        for h, w in self.shapes:
            b = torch.zeros((h, w), dtype=torch.bool, device=dev)
            b[m:h - m, m:w - m] = True
            self._borders.append(b)

    # ------------------------------------------------------------------
    def __call__(self, img) -> FeatureSet:
        img = to_tensor(img, torch.float32, self.device)
        levels = self.pyramid(img)
        return FeatureSet(*self._extract_from_scores(levels, self.scores(levels)))

    def pyramid(self, img: torch.Tensor) -> List[torch.Tensor]:
        return pyr_ops.build_pyramid(img, self._mats)

    def scores(self, levels: List[torch.Tensor]) -> List[torch.Tensor]:
        return [fast_ops.fast_score_map(x, self.config.min_th_fast) for x in levels]

    # ------------------------------------------------------------------
    def _select_cells(self, score: torch.Tensor, k: int):
        """Per-cell argmax then top-k by score over (..., h, w). Returns
        (score, y, x), each (..., k); invalid entries have score 0. When
        the cell grid is smaller than k, the tail is zero-padded."""
        cs = CELL
        h, w = score.shape[-2:]
        lead = score.shape[:-2]
        hc, wc = -(-h // cs), -(-w // cs)
        pad = (0, wc * cs - w, 0, hc * cs - h)                   # high side only
        cells = lead + (hc, cs, wc, cs)
        cellmax = F.pad(score, pad, value=float("-inf")).reshape(cells).amax(dim=(-3, -1))
        up = cellmax[..., :, None, :, None].expand(cells).reshape(
            lead + (hc * cs, wc * cs))[..., :h, :w]
        flat_idx = (torch.arange(h, dtype=torch.int32, device=score.device)[:, None] * w
                    + torch.arange(w, dtype=torch.int32, device=score.device)[None, :])
        none = h * w
        masked_idx = torch.where((score >= up) & (score > 0), flat_idx,
                                 torch.full_like(flat_idx, none))
        cell_idx = F.pad(masked_idx, pad, value=none).reshape(cells).amin(dim=(-3, -1))
        has = cell_idx < none
        cell_idx = torch.where(has, cell_idx, torch.zeros_like(cell_idx))
        flat_scores = torch.where(has, cellmax, torch.zeros_like(cellmax)).reshape(lead + (-1,))
        flat_cells = cell_idx.reshape(lead + (-1,))
        if k > hc * wc:
            flat_scores = F.pad(flat_scores, (0, k - hc * wc))
            flat_cells = F.pad(flat_cells, (0, k - hc * wc))
        top, ti = torch.sort(flat_scores, dim=-1, descending=True, stable=True)
        top, ti = top[..., :k], ti[..., :k]
        sel = flat_cells.gather(-1, ti)
        return top, sel // w, sel % w

    def detect(self, scores: List[torch.Tensor]):
        """Per level: border gate, NMS, per-cell select. scores: per-level
        (..., h, w). Returns (xyl, xy, response, level, valid), each with
        leading dims (..., capacity); xyl is int32 (x, y, level) in level
        coords, the keypoint order is level by level."""
        out_xyl, out_xy, out_resp, out_lvl, out_valid = [], [], [], [], []
        for lvl, score in enumerate(scores):
            h, w = self.shapes[lvl]
            score = fast_ops.nms3x3(score * self._borders[lvl])
            top, ys, xs = self._select_cells(score, self.budgets[lvl])
            out_xyl.append(torch.stack([
                torch.clamp(xs, 0, w - 1), torch.clamp(ys, 0, h - 1),
                torch.full_like(xs, lvl),
            ], dim=-1).to(torch.int32))
            out_xy.append(torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1)
                          * self._level_scale[lvl])
            out_resp.append(top)
            out_lvl.append(torch.full_like(xs, lvl, dtype=torch.int32))
            out_valid.append(top > 0.0)
        return (torch.cat(out_xyl, dim=-2), torch.cat(out_xy, dim=-2),
                torch.cat(out_resp, dim=-1), torch.cat(out_lvl, dim=-1),
                torch.cat(out_valid, dim=-1))

    def describe(self, levels: List[torch.Tensor], xyl: torch.Tensor):
        """One image's levels (per-level (h, w) planes), xyl (K, 3) ->
        (patches, angle, desc)."""
        patches = gather_patches(levels, xyl)                   # (K, 48, 48)
        angle = self._orientation_from_patches(patches)
        desc = self._descriptors_from_patches(self._blur_patches(patches), angle)
        return patches, angle, desc

    def _orientation_from_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """Intensity-centroid angle from raw (K, 48, 48) patches."""
        mm = torch.matmul(patches.reshape(patches.shape[0], -1), self._wxy)
        return torch.atan2(mm[:, 1], mm[:, 0])

    def _blur_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """Separable 7x7 sigma-2 Gaussian, B @ P @ B^T (zero padding; the
        edge effects stay in the outer 3px ring, outside BRIEF's reach)."""
        return torch.matmul(self._band, torch.matmul(patches, self._band.T))

    def _descriptors_from_patches(self, blurred: torch.Tensor, angles: torch.Tensor):
        """Steered BRIEF: rotate the 512 sample points by the keypoint angle,
        sample the blurred patch bilinearly, compare pairs, pack bits."""
        K, P = blurred.shape[0], blurred.shape[1]
        half = P // 2
        ca, sa = torch.cos(angles), torch.sin(angles)
        px, py = self._pat[:, 0], self._pat[:, 1]
        sx = half + ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        sy = half + sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        x0 = torch.floor(sx)
        fx = sx - x0
        y0 = torch.floor(sy)
        fy = sy - y0
        # the pattern radius (<= 13 sqrt 2) keeps every tap inside the patch;
        # the clamp only guards the memory access
        xi = x0.to(torch.int64).clamp(0, P - 2)
        yi = y0.to(torch.int64).clamp(0, P - 2)
        flat = blurred.reshape(K, P * P)
        base = yi * P + xi

        def tap(offset):
            return flat.gather(1, base + offset)

        a0 = (1.0 - fy) * tap(0) + fy * tap(P)          # column x0
        a1 = (1.0 - fy) * tap(1) + fy * tap(P + 1)      # column x0 + 1
        samples = (1.0 - fx) * a0 + fx * a1             # (K, 512)
        return pack_bits(samples[:, :PATTERN_BITS] < samples[:, PATTERN_BITS:])

    def _extract_from_scores(self, levels: List[torch.Tensor],
                             scores: List[torch.Tensor], return_patches: bool = False):
        """One image: select keypoints on every level, then ONE patch gather
        over all levels and the patch post-processing on the whole batch."""
        xyl, xy, resp, lvl, valid = self.detect(scores)
        patches, angle, desc = self.describe(levels, xyl)
        feats = (xy, resp, angle, lvl, desc, valid)
        if return_patches:
            return feats, patches
        return feats
