"""Plain per-point Gauss-Newton, to judge the windowed BA's answer.

Local mapping's bundle adjustment answers with keyframe poses and map points
that jointly minimise the reprojection error of the window's observations. At
a joint optimum every point also minimises its own reprojection cost with the
poses held where the answer put them. This module takes the problem the
program solved (its observations, information scales and stereo flags) and
its answer, and measures, point by point, by how much the cost of the
answer's point lies above the least cost over the same edges with the
answer's poses, per edge, found in float64: at an optimum, by nothing. The
edges are the observations within the chi-square gates (5.991 mono, 7.815
stereo) at the answer.

``solve_points`` is the reference's own point solve in a given precision:
bfloat16 makes the lower-precision control. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _normal_equations(R, t, X, uvr, stereo, inv_sigma2, use, cam):
    """Per point: H (L, 3, 3), g (L, 3), cost (L,) over its edges, and the
    gated edges (`use` given: those edges). R (L, K, 3, 3), t (L, K, 3) are
    the observing poses of each slot."""
    fx, fy, cx, cy, bf = cam
    pc = (R @ X[:, None, :, None])[..., 0] + t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    front = z > 0.05
    z = torch.where(front, z, torch.ones_like(z))
    u = fx * x / z + cx
    v = fy * y / z + cy
    rows = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo), stereo], -1)
    r = torch.stack([u - uvr[..., 0], v - uvr[..., 1], u - bf / z - uvr[..., 2]], -1)
    r = torch.where(rows, r, torch.zeros_like(r))
    chi2 = (r * r).sum(-1) * inv_sigma2
    if use is None:
        use = front & (chi2 <= torch.where(stereo, CHI2_STEREO, CHI2_MONO))
    zero = torch.zeros_like(x)
    Jp = torch.stack([torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
                      torch.stack([zero, fy / z, -fy * y / z ** 2], -1),
                      torch.stack([fx / z, zero, (bf - fx * x) / z ** 2], -1)], -2)
    J = Jp @ R                                                   # (L, K, 3, 3)
    w = torch.where(use, inv_sigma2, torch.zeros_like(inv_sigma2))[..., None] * rows
    H = torch.einsum("lkai,lka,lkaj->lij", J, w, J)
    g = torch.einsum("lkai,lka,lka->li", J, w, r)
    cost = torch.where(use, chi2, torch.zeros_like(chi2)).sum(-1)
    return H, g, cost, use


def _slots(poses, obs_pose):
    P = poses[obs_pose.long().clamp(min=0)]
    return P[..., :3, :3], P[..., :3, 3]


def point_excess(poses, points, point_valid, obs_pose, obs_uvr, obs_stereo, obs_inv_sigma2,
                 obs_valid, cam, iters: int = 10):
    """(excess, edges) per valid point with 2 edges or more: by how much the
    answer's point lies above its least cost with the answer's poses, per
    edge (chi-square)."""
    f64 = lambda a: torch.as_tensor(np.asarray(a)).double()   # noqa: E731
    poses, X, uvr, inv2 = f64(poses), f64(points), f64(obs_uvr), f64(obs_inv_sigma2)
    stereo = torch.as_tensor(np.asarray(obs_stereo))
    valid = torch.as_tensor(np.asarray(obs_valid)) & torch.as_tensor(np.asarray(point_valid))[:, None]
    R, t = _slots(poses, torch.as_tensor(np.asarray(obs_pose)))
    H, g, c0, use = _normal_equations(R, t, X, uvr, stereo, inv2, None, cam)
    use = use & valid
    H, g, c0, _ = _normal_equations(R, t, X, uvr, stereo, inv2, use, cam)
    best, Xb = c0.clone(), X
    eye = torch.eye(3, dtype=X.dtype)
    for _ in range(iters):
        d = -torch.linalg.solve(H + 1e-9 * eye, g[..., None])[..., 0]
        Xc = Xb + d
        Hc, gc, cc, _ = _normal_equations(R, t, Xc, uvr, stereo, inv2, use, cam)
        better = cc < best
        Xb = torch.where(better[:, None], Xc, Xb)
        H = torch.where(better[:, None, None], Hc, H)
        g = torch.where(better[:, None], gc, g)
        best = torch.where(better, cc, best)
    n = use.sum(-1)
    keep = n >= 2
    return ((c0 - best) / torch.clamp(n, min=1))[keep].numpy(), n[keep].numpy()


def solve_points(poses, points_init, point_valid, obs_pose, obs_uvr, obs_stereo,
                 obs_inv_sigma2, obs_valid, cam, dtype=torch.bfloat16, iters: int = 10):
    """The reference's own points, `iters` Gauss-Newton steps from the
    problem's initial points with the answer's poses, every product in
    `dtype` (the 3x3 solves in float64)."""
    lo = lambda a: torch.as_tensor(np.asarray(a)).double().to(dtype)   # noqa: E731
    poses, X, uvr, inv2 = lo(poses), lo(points_init), lo(obs_uvr), lo(obs_inv_sigma2)
    stereo = torch.as_tensor(np.asarray(obs_stereo))
    valid = torch.as_tensor(np.asarray(obs_valid)) & torch.as_tensor(np.asarray(point_valid))[:, None]
    R, t = _slots(poses, torch.as_tensor(np.asarray(obs_pose)))
    cam = tuple(torch.tensor(c, dtype=dtype) for c in cam)
    eye = torch.eye(3, dtype=torch.float64)
    for _ in range(iters):
        H, g, _, use = _normal_equations(R, t, X, uvr, stereo, inv2, None, cam)
        H, g, _, _ = _normal_equations(R, t, X, uvr, stereo, inv2, use & valid, cam)
        d = -torch.linalg.solve(H.double() + 1e-9 * eye, g.double()[..., None])[..., 0]
        X = X + d.to(dtype)
    return X.double().numpy()
