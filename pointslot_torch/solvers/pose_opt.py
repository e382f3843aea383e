"""Motion-only pose optimization: batched Levenberg-Marquardt on SE(3).

Port of ``pointslot_tpu/solvers/pose_opt.py::pose_optimize`` with the
object vmap written out as a leading batch axis B (B = 1 for the camera,
B = O for the objects). 4 stages of up to 10 LM iterations, Huber on the
first two, chi2 re-gating between stages; an optional per-lane translation
prior (the objects' detection anchor, the reference's
EdgeTransConstraintFromDetction; ``pose_optimize_batched(use_trans_prior=
True)`` in the JAX package).

The reference's early-exit ``lax.while_loop`` becomes exactly
``iters_per_stage`` iterations in which a lane freezes its whole carry once
it is done. That is the same result (the vmapped JAX loop also stops
changing a finished lane) and needs no host sync, so the step can later be
captured in a CUDA graph. The 6x6 solves use ``linalg.solve_ex``, which
skips the error check that would sync with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pointslot_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    T: torch.Tensor          # (B, 4, 4) optimized pose
    inliers: torch.Tensor    # (B, M) bool final inlier set
    n_inliers: torch.Tensor  # (B,) int32
    chi2: torch.Tensor       # (B, M) final per-edge chi2 (unrobust)


def _bwhere(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where() with a per-lane (B,) condition broadcast over trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def pose_optimize(
    T_init: torch.Tensor,      # (B, 4, 4)
    pts: torch.Tensor,         # (B, M, 3) points in the fixed frame
    obs: torch.Tensor,         # (B, M, 3) measurements (u, v, u_right)
    is_stereo: torch.Tensor,   # (B, M) bool
    inv_sigma2: torch.Tensor,  # (B, M) per-edge information scale
    valid: torch.Tensor,       # (B, M) bool
    fx: float, fy: float, cx: float, cy: float, bf: float,
    stages: int = 4,
    iters_per_stage: int = 10,
    chi2_mono: float = CHI2_MONO,
    chi2_stereo: float = CHI2_STEREO,
    trans_prior: Optional[torch.Tensor] = None,   # (B, 3) prior on t of T
    trans_prior_weight: float = 50.0,
) -> PoseOptResult:
    # Huber thresholds as float32 square roots, as the reference takes them
    delta_th = torch.where(is_stereo, float(np.sqrt(np.float32(chi2_stereo))),
                           float(np.sqrt(np.float32(chi2_mono))))
    gate = torch.where(is_stereo, chi2_stereo, chi2_mono)
    ptsT = pts.transpose(-1, -2)                           # (B, 3, M)
    obsT = obs.transpose(-1, -2)
    eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)

    def full_pass(T, active, use_huber: bool):
        """One residual + Jacobian evaluation at T -> (cost, H, b, chi2, behind)."""
        R, t = T[:, :3, :3], T[:, :3, 3]
        pc = torch.matmul(R, ptsT) + t[:, :, None]
        x, y = pc[:, 0], pc[:, 1]
        behind = pc[:, 2] <= 0.05
        z = torch.clamp(pc[:, 2], min=1e-6)
        iz = 1.0 / z
        iz2 = iz * iz
        u = fx * x * iz + cx
        v = fy * y * iz + cy
        du = u - obsT[:, 0]
        dv = v - obsT[:, 1]
        dur = (u - bf * iz) - obsT[:, 2]
        chi2 = (du * du + dv * dv
                + torch.where(is_stereo, dur * dur, torch.zeros_like(dur))) * inv_sigma2
        ok = active & ~behind & valid
        zero = torch.zeros_like(chi2)
        cost = torch.where(ok, chi2, zero).sum(dim=-1)
        r_norm = torch.sqrt(torch.clamp(chi2, min=1e-12))
        if use_huber:
            huber_w = torch.where(r_norm > delta_th, delta_th / r_norm,
                                  torch.ones_like(r_norm))
        else:
            huber_w = torch.ones_like(r_norm)
        w = torch.where(ok, inv_sigma2 * huber_w, zero)
        sw = torch.sqrt(w)
        sw_r = torch.where(is_stereo, sw, zero)            # u_right row
        # Jacobian of [du, dv, dur] wrt the left-multiplied xi, by rows
        a = fx * iz
        b2 = fy * iz
        c = -fx * x * iz2
        d = -fy * y * iz2
        e3 = c + bf * iz2
        A0 = torch.stack([a, zero, c, c * y, a * z - c * x, -a * y], dim=1) * sw[:, None]
        A1 = torch.stack([zero, b2, d, -b2 * z + d * y, -d * x, b2 * x], dim=1) * sw[:, None]
        A2 = torch.stack([a, zero, e3, e3 * y, a * z - e3 * x, -a * y], dim=1) * sw_r[:, None]
        r0, r1, r2 = du * sw, dv * sw, dur * sw_r
        H = (torch.matmul(A0, A0.transpose(-1, -2))
             + torch.matmul(A1, A1.transpose(-1, -2))
             + torch.matmul(A2, A2.transpose(-1, -2)))     # (B, 6, 6)
        b = (torch.matmul(A0, r0[..., None]) + torch.matmul(A1, r1[..., None])
             + torch.matmul(A2, r2[..., None]))[..., 0]    # (B, 6)
        if trans_prior is not None and trans_prior_weight > 0.0:
            # residual t(T) - prior; d t / d xi = [I | -hat(t)]
            rp = t - trans_prior
            Jp = torch.cat([eye6[:3, :3].expand(t.shape[0], 3, 3), -se3.hat(t)], dim=-1)
            Jp_T = Jp.transpose(-1, -2)
            H = H + trans_prior_weight * (Jp_T @ Jp)
            b = b + trans_prior_weight * (Jp_T @ rp[..., None])[..., 0]
            cost = cost + trans_prior_weight * torch.sum(rp * rp, dim=-1)
        return cost, H, b, chi2, behind

    def lm_stage(T, active, use_huber: bool, boundary):
        """One LM stage from the (cost, H, b, chi2, behind) already
        evaluated at T. A lane is done once an accepted step improves its
        cost by < 1e-4 relative or the step is negligible; from then on its
        carry is frozen (`run` is False), as the reference's loop stops."""
        cost_best, H, b, chi2, behind = boundary
        T_best = T
        lam = torch.full_like(cost_best, 1e-4)
        done = torch.zeros_like(cost_best, dtype=torch.bool)
        for _ in range(iters_per_stage):
            run = ~done
            diag = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
            Hd = H + lam[:, None, None] * diag + 1e-8 * eye6
            dx = -torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
            T_cand = se3.se3_retract(T_best, dx)
            cost_c, H_c, b_c, chi2_c, behind_c = full_pass(T_cand, active, use_huber)
            accept = cost_c < cost_best
            improve = cost_best - cost_c
            now_done = ((accept & (improve <= 1e-4 * cost_best))
                        | (torch.sum(dx * dx, dim=-1) < 1e-12))
            take = run & accept
            T_best = _bwhere(take, T_cand, T_best)
            cost_best = torch.where(take, cost_c, cost_best)
            H = _bwhere(take, H_c, H)
            b = _bwhere(take, b_c, b)
            chi2 = _bwhere(take, chi2_c, chi2)
            behind = _bwhere(take, behind_c, behind)
            lam = torch.where(run, torch.where(accept, lam * 0.5, lam * 4.0), lam)
            done = done | now_done
        return T_best, chi2, behind

    active = valid
    T = T_init
    chi2 = behind = None
    for s in range(stages):
        use_huber = s < 2
        if s > 0:
            active = valid & (chi2 <= gate) & ~behind
        boundary = full_pass(T, active, use_huber)
        T, chi2, behind = lm_stage(T, active, use_huber, boundary)
    active = valid & (chi2 <= gate) & ~behind
    return PoseOptResult(T=T, inliers=active,
                         n_inliers=active.sum(dim=-1, dtype=torch.int32), chi2=chi2)
