"""Projection matching of map points to frame features.

Port of ``pointslot_tpu/slam/matchers.py::project_and_match`` with the
object vmap written out: the map side carries a leading batch axis B (B = 1
for the camera's local map, B = O for the object tables), the frame's
features are shared. ``jax.ops.segment_min`` becomes ``scatter_reduce``
with ``"amin"``; the ``.at[].set(mode="drop")`` write becomes a write into
an N + 1 buffer whose last slot is then sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointslot_torch.ops.hamming import hamming_table_popcount

TH_LOW = 50
TH_HIGH = 100
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
    feat_xy: torch.Tensor,      # (N, 2)
    feat_level: torch.Tensor,   # (N,) int32
    feat_desc: torch.Tensor,    # (N, 8) int32 words
    feat_valid: torch.Tensor,   # (N,) bool
    radius: float,              # search radius in px at level 0
    scale_factors: torch.Tensor,  # (n_levels,)
    pred_level: torch.Tensor,   # (B, M) int32 predicted octave per point
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    th_desc: int = TH_HIGH,
    level_window: int = 1,
) -> ProjMatchResult:
    B, M = pts_w.shape[:2]
    N = feat_xy.shape[0]
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

    du = u[..., None] - feat_xy[:, 0]
    dv = v[..., None] - feat_xy[:, 1]
    in_window = (torch.abs(du) <= r_px[..., None]) & (torch.abs(dv) <= r_px[..., None])
    lvl_ok = torch.abs(feat_level - pred_level[..., None]) <= level_window
    mask = visible[..., None] & feat_valid & in_window & lvl_ok       # (B, M, N)

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
