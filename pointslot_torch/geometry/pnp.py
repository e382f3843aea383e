"""PnP (2D-3D) and rigid 3D-3D alignment with batched RANSAC.

Port of ``pointslot_tpu/geometry/pnp.py`` (the reference's EPnP+RANSAC
relocalization solver, src/PnPsolver.cc, and Sim3Solver, src/Sim3Solver.cc):
``_orthogonalize``, ``pnp_dlt``, ``pnp_ransac``, ``rigid_ransac``,
``rigid_refine`` and ``umeyama``. Every hypothesis is solved in one batch
(the reference's ``jax.vmap``), scored against every point in one (H, N)
table and the best taken with ``argmax`` (the first of equal scores, as
``jnp.argmax``), with no host sync.

The minimal sets are an argument, an (H, m) tensor of row indices: the
reference draws them with ``jax.random.categorical`` over equal logits of
the valid rows, which is a uniform draw with replacement; the port's
callers draw the same distribution from a seeded ``torch.Generator``
(``draw_index_sets``), and the tests pass JAX's own draws. A repeated
index is set once, as the reference's ``w.at[sel].set(1.0)`` does, so a
hypothesis with a repeat has fewer distinct points.

``eigh`` (the DLT's null vector) and ``svd`` (the rotation projections) are
library calls here as in the reference; the eigenvector's sign is fixed by
the depth of the weighted mean point and the SVDs' reflections by the
determinant, as there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pointslot_torch.geometry import se3


def draw_index_sets(valid: np.ndarray, n_hypotheses: int, m: int, seed: int) -> torch.Tensor:
    """(H, m) int64 row indices drawn uniformly with replacement from the
    valid rows (from all rows when none is valid, as equal logits give),
    from a CPU ``torch.Generator`` seeded with `seed`: the same draw on any
    device."""
    rows = np.nonzero(np.asarray(valid))[0]
    if len(rows) == 0:
        rows = np.arange(len(valid))
    g = torch.Generator().manual_seed(int(seed))
    pick = torch.randint(len(rows), (n_hypotheses, m), generator=g)
    return torch.from_numpy(rows)[pick]


def _selection_weights(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(H, m) index sets -> (H, N) 0/1 weights: a repeated row is set once."""
    H = idx.shape[0]
    w = torch.zeros((H, valid.shape[0]), dtype=torch.float32, device=valid.device)
    w = w.scatter(1, idx.to(valid.device).long(), 1.0)
    return w * valid.to(torch.float32)


def _orthogonalize(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(R)
    d = torch.linalg.det(u @ vt)
    fix = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (u * fix[..., None, :]) @ vt


def pnp_dlt(pts: torch.Tensor, uv_norm: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted linear PnP from >= 6 correspondences.

    pts: (N, 3) 3D points; uv_norm: (N, 2) NORMALIZED image coords
    ((u-cx)/fx, (v-cy)/fy); weights: (..., N) selection weights (0/1 masks
    ok), one solve per leading index. Returns T (..., 4, 4) with the
    rotation projected onto SO(3).
    """
    N = pts.shape[0]
    zeros = torch.zeros((N, 4), dtype=pts.dtype, device=pts.device)
    Ph = torch.cat([pts, torch.ones((N, 1), dtype=pts.dtype, device=pts.device)], dim=1)
    r1 = torch.cat([Ph, zeros, -uv_norm[:, 0:1] * Ph], dim=1)
    r2 = torch.cat([zeros, Ph, -uv_norm[:, 1:2] * Ph], dim=1)
    A = torch.cat([r1, r2], dim=0)                                  # (2N, 12)
    w = torch.cat([weights, weights], dim=-1)[..., None]            # (..., 2N, 1)
    AtA = (A * w).transpose(-1, -2) @ A                             # (..., 12, 12)
    _, v = torch.linalg.eigh(AtA)
    p = v[..., :, 0].reshape(weights.shape[:-1] + (3, 4))
    # fix sign: points must be in front (positive depth for the weighted mean)
    mean_pt = ((pts * weights[..., None]).sum(dim=-2)
               / torch.clamp(weights.sum(dim=-1), min=1.0)[..., None])
    depth = (p[..., 2, :3] * mean_pt).sum(dim=-1) + p[..., 2, 3]
    p = p * torch.where(depth < 0, -1.0, 1.0)[..., None, None]
    # scale so that R has unit determinant-ish: normalize by norm of third row
    scale = torch.linalg.norm(p[..., 2, :3], dim=-1)
    p = p / torch.clamp(scale, min=1e-12)[..., None, None]
    R = _orthogonalize(p[..., :, :3])
    return se3.rt_to_mat(R, p[..., :, 3])


class RansacResult(NamedTuple):
    T: torch.Tensor          # (4, 4) best pose
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool — enough inliers found


def _best(Ts: torch.Tensor, inl: torch.Tensor):
    """The hypothesis with the most inliers (the first of equal counts)."""
    scores = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(scores)
    return Ts[best], inl[best], scores[best]


def pnp_ransac(
    pts: torch.Tensor,            # (N, 3)
    uv: torch.Tensor,             # (N, 2) pixel coords
    valid: torch.Tensor,          # (N,) bool
    idx: torch.Tensor,            # (H, min_set) minimal index sets
    fx: float, fy: float, cx: float, cy: float,
    reproj_threshold: float = 5.991 ** 0.5 * 2.0,
    min_inliers: int = 10,
) -> RansacResult:
    uv_norm = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=1)
    Ts = pnp_dlt(pts, uv_norm, _selection_weights(idx, valid))      # (H, 4, 4)

    # score: reprojection error of all points under all hypotheses
    pc = torch.einsum("kij,nj->kni", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    du = fx * pc[..., 0] / z + cx - uv[None, :, 0]
    dv = fy * pc[..., 1] / z + cy - uv[None, :, 1]
    inl = (du * du + dv * dv < reproj_threshold ** 2) & (pc[..., 2] > 0.05) & valid[None, :]
    best_T, best_inl, n = _best(Ts, inl)

    # refine with one weighted DLT on the full inlier set
    refined = pnp_dlt(pts, uv_norm, best_inl.to(torch.float32))
    pc = se3.transform_points(refined, pts)
    z = torch.clamp(pc[:, 2], min=1e-6)
    du = fx * pc[:, 0] / z + cx - uv[:, 0]
    dv = fy * pc[:, 1] / z + cy - uv[:, 1]
    inl_ref = (du * du + dv * dv < reproj_threshold ** 2) & (pc[:, 2] > 0.05) & valid
    n_ref = inl_ref.sum(dtype=torch.int32)
    use_refined = n_ref >= n
    n_out = torch.maximum(n_ref, n)
    return RansacResult(T=torch.where(use_refined, refined, best_T),
                        inliers=torch.where(use_refined, inl_ref, best_inl),
                        n_inliers=n_out, ok=n_out >= min_inliers)


def rigid_ransac(
    src: torch.Tensor,            # (N, 3)
    dst: torch.Tensor,            # (N, 3)
    valid: torch.Tensor,          # (N,) bool
    idx: torch.Tensor,            # (H, 3) minimal index sets
    inlier_threshold: float = 0.3,
    with_scale: bool = False,
    min_inliers: int = 12,
) -> RansacResult:
    """3-point Horn RANSAC for rigid (or Sim3) 3D-3D alignment, the
    reference's Sim3Solver::iterate (src/Sim3Solver.cc) with every
    hypothesis solved in one batch. Returns RansacResult with T = [sR | t].
    """
    s, R, t = umeyama(src, dst, _selection_weights(idx, valid), with_scale=with_scale)
    Ts = se3.rt_to_mat(s[:, None, None] * R, t)                     # (H, 4, 4)
    pred = torch.einsum("kij,nj->kni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    err = torch.linalg.norm(pred - dst[None], dim=-1)
    inl = (err < inlier_threshold) & valid[None, :]
    best_T, best_inl, n = _best(Ts, inl)

    # refine on the best inlier set
    s, R, t = umeyama(src, dst, best_inl.to(torch.float32), with_scale=with_scale)
    sR = s * R
    T_ref = se3.rt_to_mat(sR, t)
    pred = src @ sR.T + t
    inl_ref = (torch.linalg.norm(pred - dst, dim=-1) < inlier_threshold) & valid
    n_ref = inl_ref.sum(dtype=torch.int32)
    use_ref = n_ref >= n
    n_out = torch.maximum(n_ref, n)
    return RansacResult(T=torch.where(use_ref, T_ref, best_T),
                        inliers=torch.where(use_ref, inl_ref, best_inl),
                        n_inliers=n_out, ok=n_out >= min_inliers)


def rigid_refine(
    src: torch.Tensor,            # (N, 3)
    dst: torch.Tensor,            # (N, 3)
    valid: torch.Tensor,          # (N,) bool — the RANSAC inlier set
    T0: torch.Tensor,             # (4, 4) initial estimate
    huber_delta: float = 0.15,
    n_iters: int = 4,
    with_scale: bool = False,
) -> torch.Tensor:
    """Inlier-weighted IRLS refinement of a rigid (or Sim3) alignment (the
    role of the reference's Optimizer::OptimizeSim3, src/Optimizer.cc:1684):
    each round re-solves the weighted alignment with Huber weights on the
    current 3D residuals. Exactly `n_iters` rounds."""
    T = T0
    for _ in range(n_iters):
        pred = src @ T[:3, :3].T + T[:3, 3]
        r = torch.linalg.norm(pred - dst, dim=-1)
        w_huber = torch.where(r > huber_delta, huber_delta / torch.clamp(r, min=1e-9),
                              torch.ones_like(r))
        s, R, t = umeyama(src, dst, w_huber * valid.to(torch.float32), with_scale=with_scale)
        T = se3.rt_to_mat(s * R, t)
    return T


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
            with_scale: bool = False):
    """Weighted Horn/Umeyama closed-form alignment: finds (s, R, t) minimizing
    sum w_i |dst_i - (s R src_i + t)|^2, one solve per leading index of
    `weights` (..., N). Returns (scale (...), R (..., 3, 3), t (..., 3));
    with_scale=False pins s=1 (stereo)."""
    wsum = torch.clamp(weights.sum(dim=-1), min=1e-9)[..., None]    # (..., 1)
    wc = weights[..., None]                                          # (..., N, 1)
    mu_s = (src * wc).sum(dim=-2) / wsum
    mu_d = (dst * wc).sum(dim=-2) / wsum
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd * wc).transpose(-1, -2) @ xs / wsum[..., None]         # (..., 3, 3)
    u, s, vt = torch.linalg.svd(cov)
    d = torch.linalg.det(u) * torch.linalg.det(vt)
    ones = torch.ones_like(d)
    diag = torch.stack([ones, ones, torch.where(d < 0, -1.0, 1.0)], dim=-1)
    R = (u * diag[..., None, :]) @ vt
    if with_scale:
        var_s = (wc * xs * xs).sum(dim=(-2, -1)) / wsum[..., 0]
        scale = (s * diag).sum(dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones_like(d)
    t = mu_d - scale[..., None] * (R @ mu_s[..., None])[..., 0]
    return scale, R, t
