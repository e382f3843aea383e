"""Plain Gauss-Newton on a pose's reprojection cost, to judge the pose LMs.

Camera tracking answers each frame with a pose (T_cw) that minimises the
reprojection error of the map points bound to the frame's keypoints; object
tracking answers with each object's pose (T_co) that minimises its points'
reprojection error plus a pull of its translation toward the detection's
(ORB-SLAM2's PoseOptimization; PointSLOT's object pose with the translation
prior). This module takes the inputs of the program's last such solve (the
bound points, the keypoints' pixels and right-image columns, each edge's
information scale, the prior) and measures by how much the cost of the
program's answer lies above the least cost, found in float64, per edge: at
an optimum, by nothing. The edges are those within the chi-square gates of 2 and 3 degrees
of freedom at 95 % (5.991 mono, 7.815 stereo) at the answer, as the final
stage of the method keeps them.

``solve`` is the reference's own solve in a given precision: bfloat16 makes
the lower-precision control. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _normal_equations(T, pts, obs, is_stereo, inv_sigma2, valid, cam, prior, prior_w,
                      use=None):
    """H (B, 6, 6), g (B, 6) and cost (B,) of the gated cost at T, for the
    left perturbation T <- exp([rho, omega]) T, and the gated edge mask
    (`use`, when given, fixes the edges instead)."""
    fx, fy, cx, cy, bf = cam
    R, t = T[:, :3, :3], T[:, :3, 3]
    pc = torch.einsum("bij,bmj->bmi", R, pts) + t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    front = z > 0.05
    z = torch.where(front, z, torch.ones_like(z))
    u = fx * x / z + cx
    v = fy * y / z + cy
    ur = u - bf / z
    r = torch.stack([u - obs[..., 0], v - obs[..., 1], ur - obs[..., 2]], -1)   # (B, M, 3)
    r = torch.where(is_stereo[..., None] | (torch.arange(3, device=r.device) < 2),
                    r, torch.zeros_like(r))
    chi2 = (r * r).sum(-1) * inv_sigma2
    gate = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    if use is None:
        use = valid & front & (chi2 <= gate)
    zero = torch.zeros_like(x)
    # d(u, v, ur) / d pc, then d pc / d(rho, omega) = [I | -hat(pc)]
    Jp = torch.stack([torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
                      torch.stack([zero, fy / z, -fy * y / z ** 2], -1),
                      torch.stack([fx / z, zero, (bf - fx * x) / z ** 2], -1)], -2)
    dpc = torch.cat([torch.eye(3, dtype=T.dtype, device=T.device).expand(*pc.shape[:2], 3, 3),
                     -_hat(pc)], -1)                                          # (B, M, 3, 6)
    J = Jp @ dpc                                                              # (B, M, 3, 6)
    w = torch.where(use, inv_sigma2, torch.zeros_like(inv_sigma2))
    rows = torch.where(is_stereo[..., None] | (torch.arange(3, device=r.device) < 2),
                       w[..., None], torch.zeros_like(r))                     # (B, M, 3)
    H = torch.einsum("bmki,bmk,bmkj->bij", J, rows, J)
    g = torch.einsum("bmki,bmk,bmk->bi", J, rows, r)
    cost = torch.where(use, chi2, torch.zeros_like(chi2)).sum(-1)
    if prior is not None and prior_w > 0:
        Jt = torch.cat([torch.eye(3, dtype=T.dtype, device=T.device).expand(len(t), 3, 3),
                        -_hat(t)], -1)
        H = H + prior_w * Jt.transpose(-1, -2) @ Jt
        g = g + prior_w * (Jt.transpose(-1, -2) @ (t - prior)[..., None])[..., 0]
        cost = cost + prior_w * ((t - prior) ** 2).sum(-1)
    return H, g, cost, use


def _step(H, g):
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    return -torch.linalg.solve(H.double() + 1e-9 * eye.double(), g.double()[..., None])[..., 0]


def _retract(T, d):
    """exp([rho, omega]) T to first order, rotation put back on SO(3)."""
    rho, om = d[:, :3], d[:, 3:]
    R = (torch.eye(3, dtype=T.dtype) + _hat(om)) @ T[:, :3, :3]
    U, _, Vh = torch.linalg.svd(R.double())
    out = T.clone()
    out[:, :3, :3] = (U @ Vh).to(T.dtype)
    out[:, :3, 3] = T[:, :3, 3] + rho + (_hat(om) @ T[:, :3, 3:])[..., 0]
    return out


def excess_cost(T, pts, obs, is_stereo, inv_sigma2, valid, cam, prior=None, prior_w=0.0,
                iters: int = 20):
    """(excess, edges): by how much the cost (chi-square) of each answer T
    (B, 4, 4) lies above the least cost over the same gated edges, per edge,
    and the edges it counts. The least is found by Gauss-Newton from the
    answer in float64 (each step kept only where it lowers the cost). A
    cost, unlike the distance to the optimum, does not grow along directions
    the points hardly constrain."""
    f64 = lambda a: None if a is None else torch.as_tensor(a).double()   # noqa: E731
    T, pts, obs, inv_sigma2, prior = map(f64, (T, pts, obs, inv_sigma2, prior))
    is_stereo, valid = torch.as_tensor(is_stereo), torch.as_tensor(valid)
    H, g, c0, use = _normal_equations(T, pts, obs, is_stereo, inv_sigma2, valid, cam,
                                      prior, prior_w)
    best, Tb = c0.clone(), T
    for _ in range(iters):
        Tc = _retract(Tb, _step(H, g))
        Hc, gc, cc, _ = _normal_equations(Tc, pts, obs, is_stereo, inv_sigma2, valid, cam,
                                          prior, prior_w, use)
        better = cc < best
        Tb = torch.where(better[:, None, None], Tc, Tb)
        H = torch.where(better[:, None, None], Hc, H)
        g = torch.where(better[:, None], gc, g)
        best = torch.where(better, cc, best)
    n = use.sum(-1)
    return ((c0 - best) / torch.clamp(n, min=1)).numpy(), n.numpy()


def solve(T_init, pts, obs, is_stereo, inv_sigma2, valid, cam, prior=None, prior_w=0.0,
          dtype=torch.bfloat16, iters: int = 10) -> np.ndarray:
    """The reference's own pose, `iters` Gauss-Newton steps from T_init with
    every product in `dtype` (the 6x6 solve in float64)."""
    lo = lambda a: None if a is None else torch.as_tensor(a).double().to(dtype)   # noqa: E731
    T, pts, obs, inv_sigma2, prior = map(lo, (T_init, pts, obs, inv_sigma2, prior))
    is_stereo, valid = torch.as_tensor(is_stereo), torch.as_tensor(valid)
    cam = tuple(torch.tensor(c, dtype=dtype) for c in cam)
    for _ in range(iters):
        H, g, _, _ = _normal_equations(T, pts, obs, is_stereo, inv_sigma2, valid, cam, prior,
                                       prior_w)
        T = _retract(T, _step(H, g).to(dtype))
    return T.double().numpy()
