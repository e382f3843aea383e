"""Projection matching and descriptor-table matching.

Port of ``pointslot_tpu/slam/matchers.py``:

- ``project_and_match`` with the object vmap written out: the map side
  carries a leading batch axis B (B = 1 for the camera's local map, B = O
  for the object tables); the frame's features are shared, or carry the
  same axis B (each object's own features, the object tracker's case).
  ``jax.ops.segment_min`` becomes ``scatter_reduce`` with ``"amin"``; the
  ``.at[].set(mode="drop")`` write becomes a write into an N + 1 buffer
  whose last slot is then sliced off.
- ``brute_match``: mutual-best matching with the Lowe ratio and the
  rotation histogram, on one table pair or on a leading batch axis (the
  reference's ``jax.vmap(brute_match)`` over objects). ``torch.argmin`` breaks ties to the first index as
  ``jnp.argmin`` does; ``lax.top_k``'s third-largest bin is a sort of the
  30 bins.
- ``guided_match``: position-guided point->feature matching for the
  offline-flow object path, on one table pair or on a leading batch axis
  (the reference's ``jax.vmap(guided_match)`` over objects), with
  ``project_and_match``'s conflict resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointslot_torch.ops.hamming import hamming_table_popcount

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
_BIG = 1 << 20


class ProjMatchResult(NamedTuple):
    point_for_feature: torch.Tensor  # (B, N) int32 map-point row or -1
    n_matches: torch.Tensor          # (B,) int32
    visible: torch.Tensor            # (B, M) bool point projects into the image


def project_and_match(
    pts_w: torch.Tensor,        # (B, M, 3) points in the world/object frame
    pt_desc: torch.Tensor,      # (B, M, 8) int32 words
    pt_valid: torch.Tensor,     # (B, M) bool
    T_cw: torch.Tensor,         # (B, 4, 4)
    feat_xy: torch.Tensor,      # (N, 2) or (B, N, 2)
    feat_level: torch.Tensor,   # (N,) or (B, N) int32
    feat_desc: torch.Tensor,    # (N, 8) or (B, N, 8) int32 words
    feat_valid: torch.Tensor,   # (N,) or (B, N) bool
    radius: float,              # search radius in px at level 0
    scale_factors: torch.Tensor,  # (n_levels,)
    pred_level: torch.Tensor,   # (B, M) int32 predicted octave per point
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    th_desc: int = TH_HIGH,
    level_window: int = 1,
) -> ProjMatchResult:
    B, M = pts_w.shape[:2]
    if feat_xy.dim() == 2:
        feat_xy, feat_level, feat_desc, feat_valid = (
            x[None] for x in (feat_xy, feat_level, feat_desc, feat_valid))
    N = feat_xy.shape[1]
    R, t = T_cw[:, :3, :3], T_cw[:, :3, 3]
    pc = torch.matmul(pts_w, R.transpose(-1, -2)) + t[:, None, :]
    z = pc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = fx * pc[..., 0] * zi + cx
    v = fy * pc[..., 1] * zi + cy
    visible = pt_valid & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    # search radius scaled by the point's predicted octave
    n_lv = scale_factors.shape[0]
    r_px = radius * scale_factors[torch.clamp(pred_level, 0, n_lv - 1).long()]

    du = u[..., None] - feat_xy[:, None, :, 0]
    dv = v[..., None] - feat_xy[:, None, :, 1]
    in_window = (torch.abs(du) <= r_px[..., None]) & (torch.abs(dv) <= r_px[..., None])
    lvl_ok = torch.abs(feat_level[:, None, :] - pred_level[..., None]) <= level_window
    mask = visible[..., None] & feat_valid[:, None, :] & in_window & lvl_ok   # (B, M, N)

    dist = hamming_table_popcount(pt_desc, feat_desc)                 # (B, M, N)
    dist = torch.where(mask, dist, torch.full_like(dist, _BIG))
    best_feat = torch.argmin(dist, dim=-1)                            # (B, M) int64
    best_dist = dist.gather(-1, best_feat[..., None])[..., 0]
    matched = best_dist <= th_desc

    # resolve feature conflicts: keep the best point per feature, ties to
    # the lowest point row
    key = torch.where(matched, best_dist, torch.full_like(best_dist, _BIG))
    big = torch.full((B, N), _BIG, dtype=key.dtype, device=key.device)
    per_feat_best = big.scatter_reduce(1, best_feat, key, "amin")
    winner = matched & (key == per_feat_best.gather(1, best_feat))
    pid = torch.arange(M, dtype=torch.int32, device=pts_w.device).expand(B, M)
    tie_key = torch.where(winner, pid, torch.full_like(pid, M + 1))
    per_feat_pid = torch.full((B, N), M + 1, dtype=torch.int32, device=key.device)
    per_feat_pid = per_feat_pid.scatter_reduce(1, best_feat, tie_key, "amin")
    winner = winner & (pid == per_feat_pid.gather(1, best_feat))

    slot = torch.where(winner, best_feat, torch.full_like(best_feat, N))
    buf = torch.full((B, N + 1), -1, dtype=torch.int32, device=pts_w.device)
    buf = buf.scatter(1, slot, torch.where(winner, pid, torch.full_like(pid, -1)))
    return ProjMatchResult(
        point_for_feature=buf[:, :N],
        n_matches=winner.sum(dim=1, dtype=torch.int32),
        visible=visible,
    )


class BruteMatchResult(NamedTuple):
    idx_b_for_a: torch.Tensor   # (NA,) or (B, NA) int32 match in B or -1
    n_matches: torch.Tensor     # () or (B,) int32


def brute_match(
    desc_a: torch.Tensor, angle_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, angle_b: torch.Tensor, valid_b: torch.Tensor,
    nn_ratio: float = 0.9,
    th_desc: int = TH_LOW,
    check_rotation: bool = True,
) -> BruteMatchResult:
    """Mutual-best descriptor matching with Lowe ratio and rotation-histogram
    filtering (keep the 3 dominant relative-orientation bins). Descriptors
    are (NA, 8) / (NB, 8) int32 words; every input may carry a leading batch
    axis B, one independent match per lane."""
    single = desc_a.dim() == 2
    if single:
        desc_a, angle_a, valid_a, desc_b, angle_b, valid_b = (
            x[None] for x in (desc_a, angle_a, valid_a, desc_b, angle_b, valid_b))
    NA = desc_a.shape[1]
    dist = hamming_table_popcount(desc_a, desc_b)                      # (B, NA, NB)
    dist = torch.where(valid_a[:, :, None] & valid_b[:, None, :], dist,
                       torch.full_like(dist, _BIG))

    # two smallest per row: the second from a copy with the best masked
    best = torch.argmin(dist, dim=2)
    d1 = dist.gather(2, best[..., None])[..., 0]
    d2 = dist.scatter(2, best[..., None], _BIG).amin(dim=2)
    ok = (d1 <= th_desc) & (d1.to(torch.float32) < nn_ratio * d2.to(torch.float32))

    # mutual check: the best row of the column must be this row
    rows = torch.arange(NA, device=dist.device)
    col_best = torch.argmin(dist, dim=1)                               # (B, NB)
    ok = ok & (col_best.gather(1, best) == rows)

    if check_rotation:
        two_pi = 2.0 * torch.pi
        rot = torch.remainder(angle_a - angle_b.gather(1, best), two_pi)
        bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int32),
                           0, HISTO_LENGTH - 1).long()
        hist = torch.zeros((bins.shape[0], HISTO_LENGTH + 1), dtype=torch.int32,
                           device=dist.device)
        hist = hist.scatter_add(1, torch.where(ok, bins, torch.full_like(bins, HISTO_LENGTH)),
                                torch.ones_like(bins, dtype=torch.int32))[:, :HISTO_LENGTH]
        third = torch.sort(hist, dim=1, descending=True).values[:, 2:3]
        keep_bin = hist >= torch.clamp(third, min=1)
        ok = ok & keep_bin.gather(1, bins)

    out = torch.where(ok, best.to(torch.int32), torch.full_like(best, -1, dtype=torch.int32))
    n = ok.sum(dim=1, dtype=torch.int32)
    if single:
        return BruteMatchResult(idx_b_for_a=out[0], n_matches=n[0])
    return BruteMatchResult(idx_b_for_a=out, n_matches=n)


class GuidedMatchResult(NamedTuple):
    point_for_feature: torch.Tensor  # (N,) or (B, N) int32 point row or -1
    n_matches: torch.Tensor          # () or (B,) int32


def guided_match(
    pred_xy: torch.Tensor,     # (M, 2) or (B, M, 2) predicted pixel position per point
    pred_ok: torch.Tensor,     # (M,) or (B, M) bool prediction available
    pt_desc: torch.Tensor,     # (M, 8) or (B, M, 8) int32 words
    feat_xy: torch.Tensor,     # (N, 2) or (B, N, 2)
    feat_desc: torch.Tensor,   # (N, 8) or (B, N, 8) int32 words
    feat_valid: torch.Tensor,  # (N,) or (B, N) bool
    radius: float = 5.0,
    th_desc: int = 130,
) -> GuidedMatchResult:
    """Each point carries an externally predicted pixel position (its last
    observation warped by the offline optical flow); its candidates are the
    features within `radius` px on every pyramid level, scored by Hamming
    distance, kept at or under `th_desc`; a feature claimed by several
    points goes to the nearest, ties to the lowest point row (the
    reference's SearchByOfflineOpticalFlowTracking,
    src/ORBmatcher.cc:2236-2369, as one masked distance table)."""
    single = pred_xy.dim() == 2
    if single:
        pred_xy, pred_ok, pt_desc, feat_xy, feat_desc, feat_valid = (
            x[None] for x in (pred_xy, pred_ok, pt_desc, feat_xy, feat_desc, feat_valid))
    B, M = pred_ok.shape
    N = feat_valid.shape[1]
    du = pred_xy[..., 0][..., None] - feat_xy[:, None, :, 0]
    dv = pred_xy[..., 1][..., None] - feat_xy[:, None, :, 1]
    in_window = (torch.abs(du) <= radius) & (torch.abs(dv) <= radius)
    mask = pred_ok[..., None] & feat_valid[:, None, :] & in_window     # (B, M, N)

    dist = hamming_table_popcount(pt_desc, feat_desc)
    dist = torch.where(mask, dist, torch.full_like(dist, _BIG))
    best_feat = torch.argmin(dist, dim=-1)                            # (B, M) int64
    best_dist = dist.gather(-1, best_feat[..., None])[..., 0]
    matched = best_dist <= th_desc

    # conflict resolution: best point per feature, ties to the lowest row
    key = torch.where(matched, best_dist, torch.full_like(best_dist, _BIG))
    big = torch.full((B, N), _BIG, dtype=key.dtype, device=key.device)
    per_feat_best = big.scatter_reduce(1, best_feat, key, "amin")
    winner = matched & (key == per_feat_best.gather(1, best_feat))
    pid = torch.arange(M, dtype=torch.int32, device=key.device).expand(B, M)
    tie_key = torch.where(winner, pid, torch.full_like(pid, M + 1))
    per_feat_pid = torch.full((B, N), M + 1, dtype=torch.int32, device=key.device)
    per_feat_pid = per_feat_pid.scatter_reduce(1, best_feat, tie_key, "amin")
    winner = winner & (pid == per_feat_pid.gather(1, best_feat))

    slot = torch.where(winner, best_feat, torch.full_like(best_feat, N))
    buf = torch.full((B, N + 1), -1, dtype=torch.int32, device=key.device)
    buf = buf.scatter(1, slot, torch.where(winner, pid, torch.full_like(pid, -1)))
    n = winner.sum(dim=1, dtype=torch.int32)
    if single:
        return GuidedMatchResult(point_for_feature=buf[0, :N], n_matches=n[0])
    return GuidedMatchResult(point_for_feature=buf[:, :N], n_matches=n)
