"""Monocular two-view reconstruction: H/F model selection and triangulation.

Port of ``pointslot_tpu/geometry/two_view.py`` (the reference's
Initializer / TwoViewReconstruction, src/Initializer.cc: parallel
homography and fundamental RANSAC, SH/(SH+SF) model selection, E
decomposition with cheirality checks). No System calls it, in either
package; it is the monocular initialiser of the surface.

Every step is the JAX package's, batched over the K hypotheses with
``torch.linalg.eigh`` / ``svd`` in place of ``vmap``:
- a weighted DLT homography and a weighted 8-point F with its rank-2
  projection to unit singular values, each from the hypothesis' minimal
  set as 0/1 weights over all points;
- the symmetric transfer error of H (through the inverse of H + 1e-12 I)
  and the epipolar error of F, each thresholded into inlier sets;
- H is used when SH / (SH + SF) > 0.45;
- E = the 8-point fit on the best F's inliers, its four (R, t) candidates
  triangulated, the one with the most points in front of both views kept;
- ok = at least 30 inliers and a cheirality count above 0.7 x SF.

The minimal sets are drawn as ``jax.random.categorical`` draws them: with
replacement over the valid rows (over all rows when none is valid), a
repeated row weighted once. ``reconstruct_two_view_from_sets`` takes the
(K, 4) and (K, 8) index sets, so that a test can pass the JAX package's
draws. Eigen- and singular-vector signs differ between libraries; H and
F are homogeneous and the candidates cover +-t, so the outputs do not
depend on them.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from pointslot_torch.geometry import se3


class TwoViewResult(NamedTuple):
    ok: torch.Tensor               # () bool
    T21: torch.Tensor              # (4, 4) pose of view 2 wrt view 1 (unit baseline)
    points: torch.Tensor           # (N, 3) triangulated in view-1 frame
    inliers: torch.Tensor          # (N,) bool
    used_homography: torch.Tensor  # () bool


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    """(..., n, n) symmetric -> (..., n) eigenvector of the least eigenvalue."""
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT: p1, p2 (N, 2) normalized coords, w (K, N) -> H (K, 3, 3)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], 1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], 1)
    A = torch.cat([r1, r2], 0)
    ww = torch.cat([w, w], 1)[..., None]
    AtA = (A * ww).transpose(-1, -2) @ A
    return _smallest_eigvec(AtA).reshape(-1, 3, 3)


def _eight_point_F(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point fundamental/essential on normalized coords: w (K, N)
    -> (K, 3, 3) of rank 2 with unit singular values."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], 1)
    AtA = (A * w[..., None]).transpose(-1, -2) @ A
    F = _smallest_eigvec(AtA).reshape(-1, 3, 3)
    u, _, vt = torch.linalg.svd(F)
    unit = torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)
    return (u * unit) @ vt


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], 1)


def _sym_transfer_err_H(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """H (K, 3, 3) -> (K, N) symmetric transfer errors."""
    def transfer(H, a, b):
        q = _homogeneous(a) @ H.transpose(-1, -2)
        q = q[..., :2] / torch.where(torch.abs(q[..., 2:3]) > 1e-9, q[..., 2:3],
                                     torch.full_like(q[..., 2:3], 1e-9))
        return torch.sum((q - b) ** 2, dim=-1)

    Hinv = torch.linalg.inv(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))
    return transfer(H, p1, p2) + transfer(Hinv, p2, p1)


def _epipolar_err_F(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """F (K, 3, 3) -> (K, N) epipolar errors."""
    h1, h2 = _homogeneous(p1), _homogeneous(p2)
    Fx1 = h1 @ F.transpose(-1, -2)
    Ftx2 = h2 @ F
    x2Fx1 = torch.sum(h2 * Fx1, dim=-1)
    return x2Fx1 ** 2 * (
        1.0 / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=1e-12)
        + 1.0 / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=1e-12))


def _selection_weights(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K, m) index sets -> (K, N) 0/1 weights: a repeated row is set once."""
    w = torch.zeros((idx.shape[0], valid.shape[0]), dtype=torch.float32, device=valid.device)
    return w.scatter(1, idx.to(valid.device).long(), 1.0) * valid.to(torch.float32)


def draw_index_sets(valid: torch.Tensor, n_hypotheses: int,
                    generator: Union[torch.Generator, int]):
    """(K, 4) and (K, 8) int64 minimal sets, drawn with replacement over the
    valid rows (over all rows when none is valid, as equal logits give) by
    ``torch.multinomial`` from a CPU generator (or one seeded with an int):
    the same draws on any device."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    w = valid.detach().to("cpu", torch.float32)
    if not bool(w.any()):
        w = torch.ones_like(w)
    w = w.expand(n_hypotheses, -1)
    idx_h = torch.multinomial(w, 4, replacement=True, generator=generator)
    idx_f = torch.multinomial(w, 8, replacement=True, generator=generator)
    return idx_h, idx_f


def _triangulate(T21: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor):
    """Each candidate T21 (C, 4, 4): the (C, N, 3) linear triangulations and
    the (C, N) flags of points in front of both views."""
    C = T21.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=p1.dtype, device=p1.device),
                    torch.zeros((3, 1), dtype=p1.dtype, device=p1.device)], 1)
    P1 = P1.expand(C, 3, 4)
    P2 = T21[:, :3, :4]
    rows = []
    for Pm, uv in ((P1, p1), (P2, p2)):
        rows.append(uv[None, :, 0:1] * Pm[:, None, 2] - Pm[:, None, 0])
        rows.append(uv[None, :, 1:2] * Pm[:, None, 2] - Pm[:, None, 1])
    A = torch.stack(rows, dim=2)                                 # (C, N, 4, 4)
    X = _smallest_eigvec(A.transpose(-1, -2) @ A)
    w = X[..., 3:4]
    pts = X[..., :3] / torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))
    pc2 = pts @ T21[:, :3, :3].transpose(-1, -2) + T21[:, None, :3, 3]
    good = (pts[..., 2] > 0) & (pc2[..., 2] > 0) & valid
    return pts, good


def reconstruct_two_view_from_sets(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                                   idx_h: torch.Tensor, idx_f: torch.Tensor,
                                   err_threshold: float = 4e-5) -> TwoViewResult:
    """The reconstruction from given minimal sets: p1, p2 (N, 2) normalized
    coords, valid (N,) bool, idx_h (K, 4), idx_f (K, 8)."""
    p1 = p1.to(torch.float32)
    p2 = p2.to(torch.float32)
    valid = valid.to(torch.bool)

    # homography RANSAC
    H_all = _dlt_homography(p1, p2, _selection_weights(idx_h, valid))
    inlH = (_sym_transfer_err_H(H_all, p1, p2) < err_threshold) & valid
    scoreH = inlH.sum(dim=1)
    bestH = torch.argmax(scoreH)

    # fundamental RANSAC
    F_all = _eight_point_F(p1, p2, _selection_weights(idx_f, valid))
    inlF = (_epipolar_err_F(F_all, p1, p2) < err_threshold) & valid
    scoreF = inlF.sum(dim=1)
    bestF = torch.argmax(scoreF)

    # model selection (the reference uses SH/(SH+SF) > 0.40 -> H)
    ratio = scoreH[bestH] / torch.clamp(scoreH[bestH] + scoreF[bestF], min=1)
    use_H = ratio > 0.45

    # decompose E (normalized coords: F is E)
    E = _eight_point_F(p1, p2, inlF[bestF].to(torch.float32)[None])[0]
    u, _, vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2]
    candidates = se3.rt_to_mat(torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t]))

    all_pts, all_good = _triangulate(candidates, p1, p2, valid)
    cheirality = all_good.sum(dim=1)
    best = torch.argmax(cheirality)
    inliers = all_good[best] & inlF[bestF]
    ok = (inliers.sum() >= 30) & (cheirality[best] > 0.7 * torch.clamp(scoreF[bestF], min=1))
    return TwoViewResult(ok=ok, T21=candidates[best], points=all_pts[best], inliers=inliers,
                         used_homography=use_H)


def reconstruct_two_view(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                         generator: Union[torch.Generator, int], n_hypotheses: int = 128,
                         err_threshold: float = 4e-5) -> TwoViewResult:
    """p1, p2 (N, 2) NORMALIZED image coords of views 1 and 2 and valid
    (N,) bool, on one device; `generator` draws the minimal sets (a CPU
    ``torch.Generator`` or an int seed). Returns device tensors."""
    idx_h, idx_f = draw_index_sets(valid, n_hypotheses, generator)
    return reconstruct_two_view_from_sets(p1, p2, valid, idx_h, idx_f, err_threshold)
