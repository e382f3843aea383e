"""Windowed bundle adjustment with an explicit Schur complement.

Port of ``pointslot_tpu/solvers/local_ba.py``: ``BAProblem``, ``BAResult``,
the host-side ``build_problem`` (a copy: flat edge lists packed into the
point-major (L, K) slot layout) and ``bundle_adjust`` for one problem
(the reference's LocalBundleAdjustment: 5 + 10 LM iterations with an
outlier pass between the stages, points marginalized).

What changes on the card:
- the TPU's one-hot gathers and reductions (``_gather_rows`` for P <= 64,
  ``_pose_onehot`` with the ``lkp,...`` einsums) become ``index_select``
  and ``index_add_``. The gathers stay exact; the pose-block sums run in
  another order, so results match the reference within a tolerance. The
  (L, K, P) one-hot is never built;
- the dense (L, P, 6, 3) coupling ``U`` and the (P, P, 6, 6) reduced
  camera system stay plain products, as in the reference (TF32 off);
- ``fori_loop`` becomes exactly ``n_iters`` Python iterations that accept
  or reject with ``torch.where``, and the (6P, 6P) solve is
  ``linalg.solve_ex``: the solve has no host sync.

Left for later (ROADMAP items 12 and 15): ``bundle_adjust_batched``, the
motion priors and the sharded (``axis_name``) form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pointslot_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. P poses, L points, K obs slots per point."""

    poses: torch.Tensor           # (P, 4, 4) T_cw initial
    pose_fixed: torch.Tensor      # (P,) bool, held constant
    pose_valid: torch.Tensor      # (P,) bool
    dof_mask: torch.Tensor        # (P, 6) float, 1 = free, 0 = frozen dof
    points: torch.Tensor          # (L, 3) world points initial
    point_valid: torch.Tensor     # (L,) bool
    obs_pose: torch.Tensor        # (L, K) int32 pose index per slot
    obs_uvr: torch.Tensor         # (L, K, 3) (u, v, uR)
    obs_stereo: torch.Tensor      # (L, K) bool
    obs_inv_sigma2: torch.Tensor  # (L, K)
    obs_valid: torch.Tensor       # (L, K) bool


class BAResult(NamedTuple):
    poses: torch.Tensor       # (P, 4, 4)
    points: torch.Tensor      # (L, 3)
    obs_inlier: torch.Tensor  # (L, K) bool
    cost: torch.Tensor        # () final cost of the last stage


# ---------------------------------------------------------------------------
# host-side problem builder: flat edge lists -> point-major slots
# ---------------------------------------------------------------------------

def build_problem(
    poses: np.ndarray,          # (n, 4, 4)
    pose_fixed,                 # (n,) bool-like
    points: np.ndarray,         # (m, 3)
    e_pose: np.ndarray,         # (E,) int
    e_point: np.ndarray,        # (E,) int
    e_obs: np.ndarray,          # (E, 3)
    e_stereo: np.ndarray,       # (E,) bool
    e_inv_sigma2: np.ndarray,   # (E,)
    P_cap: int,
    L_cap: int,
    K: int,
    dof_mask: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[BAProblem, np.ndarray]:
    """Pack flat edge arrays into the point-major layout, on `device`.

    Returns (problem, slot_edge) where slot_edge (L_cap, K) maps each
    observation slot back to its row in the input edge arrays (-1 = empty),
    so callers can push per-slot inlier flags back onto their own indices.
    Edges beyond K per point or beyond the caps are dropped.
    """
    n = len(poses)
    m = len(points)
    assert n <= P_cap and m <= L_cap, (n, P_cap, m, L_cap)
    e_pose = np.asarray(e_pose, np.int64)
    e_point = np.asarray(e_point, np.int64)
    keep = (e_pose >= 0) & (e_pose < n) & (e_point >= 0) & (e_point < m)
    eidx = np.nonzero(keep)[0]

    order = eidx[np.argsort(e_point[eidx], kind="stable")]
    sp = e_point[order]
    first = np.searchsorted(sp, sp, side="left")
    slot = np.arange(len(sp)) - first
    sel = slot < K
    order, sp, slot = order[sel], sp[sel], slot[sel]

    obs_pose = np.zeros((L_cap, K), np.int32)
    obs_uvr = np.zeros((L_cap, K, 3), np.float32)
    obs_stereo = np.zeros((L_cap, K), bool)
    obs_inv2 = np.ones((L_cap, K), np.float32)
    obs_valid = np.zeros((L_cap, K), bool)
    slot_edge = np.full((L_cap, K), -1, np.int64)

    obs_pose[sp, slot] = e_pose[order].astype(np.int32)
    obs_uvr[sp, slot] = np.asarray(e_obs, np.float32)[order]
    obs_stereo[sp, slot] = np.asarray(e_stereo, bool)[order]
    obs_inv2[sp, slot] = np.asarray(e_inv_sigma2, np.float32)[order]
    obs_valid[sp, slot] = True
    slot_edge[sp, slot] = order

    def pad(a, cap, fill=0):
        a = np.asarray(a)
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a[:cap]
        return out

    if dof_mask is None:
        dof = np.ones((P_cap, 6), np.float32)
    else:
        dof = pad(np.asarray(dof_mask, np.float32), P_cap, 1.0)

    host = BAProblem(
        poses=pad(np.asarray(poses, np.float32), P_cap),
        pose_fixed=pad(np.asarray(pose_fixed, bool), P_cap, True),
        pose_valid=pad(np.ones(n, bool), P_cap, False),
        dof_mask=dof,
        points=pad(np.asarray(points, np.float32), L_cap),
        point_valid=pad(np.ones(m, bool), L_cap, False),
        obs_pose=obs_pose,
        obs_uvr=obs_uvr,
        obs_stereo=obs_stereo,
        obs_inv_sigma2=obs_inv2,
        obs_valid=obs_valid,
    )
    dev = torch.device(device)
    prob = BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host))
    return prob, slot_edge


# ---------------------------------------------------------------------------
# device-side pieces
# ---------------------------------------------------------------------------

def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (P, ...) gathered by integer idx of any shape (exact)."""
    out = table.reshape(table.shape[0], -1).index_select(0, idx.reshape(-1).long())
    return out.reshape(idx.shape + table.shape[1:])


def _pose_sum(values: torch.Tensor, obs_pose: torch.Tensor, P: int) -> torch.Tensor:
    """Sum (L, K, ...) slot values into their poses -> (P, ...)."""
    flat = values.reshape((-1,) + values.shape[2:])
    out = torch.zeros((P,) + values.shape[2:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, obs_pose.reshape(-1).long(), flat)


def _coupling(G: torch.Tensor, obs_pose: torch.Tensor, P: int) -> torch.Tensor:
    """(L, K, 6, 3) slot couplings -> dense (L, P, 6, 3), slots of one point
    summed into their pose's column."""
    L = G.shape[0]
    rows = (torch.arange(L, device=G.device)[:, None] * P + obs_pose.long()).reshape(-1)
    out = torch.zeros((L * P,) + G.shape[2:], dtype=G.dtype, device=G.device)
    out.index_add_(0, rows, G.reshape((-1,) + G.shape[2:]))
    return out.reshape((L, P) + G.shape[2:])


def _transform(poses, points, prob: BAProblem):
    """Camera-frame points (L, K, 3) of every slot, and the slots' poses."""
    T = _gather_rows(poses, prob.obs_pose)                   # (L, K, 4, 4)
    pc = torch.einsum("lkij,lj->lki", T[..., :3, :3], points) + T[..., :3, 3]
    return pc, T


def _residuals_only(poses, points, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (L, K, 3) + behind-camera mask, no Jacobians."""
    pc, _ = _transform(poses, points, prob)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    res = torch.stack([u, v, u - bf / z], dim=-1) - prob.obs_uvr
    return res, pc[..., 2] <= 0.05


def _residuals_jac(poses, points, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (L, K, 3), pose Jac (L, K, 3, 6), point Jac (L, K, 3, 3)."""
    pc, T = _transform(poses, points, prob)
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    res = torch.stack([u, v, ur], dim=-1) - prob.obs_uvr

    zero = torch.zeros_like(z)
    du_dp = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv_dp = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur_dp = du_dp + torch.stack([zero, zero, bf * iz2], dim=-1)
    J_p = torch.stack([du_dp, dv_dp, dur_dp], dim=-2)        # (L, K, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)         # (L, K, 3, 6)
    J_pose = J_p @ dpc_dxi                                   # (L, K, 3, 6)
    J_point = J_p @ T[..., :3, :3]                           # (L, K, 3, 3)
    return res, J_pose, J_point, pc[..., 2] <= 0.05


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _chi2(res, stereo, inv_sigma2):
    r2 = (res[..., 0] ** 2 + res[..., 1] ** 2
          + torch.where(stereo, res[..., 2] ** 2, torch.zeros_like(res[..., 2])))
    return r2 * inv_sigma2


def _robust_cost(chi2, delta2):
    """Huber-robustified total cost."""
    lin = 2.0 * torch.sqrt(torch.clamp(chi2 * delta2, min=0.0)) - delta2
    return torch.where(chi2 <= delta2, chi2, lin)


def _damped(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """H + lam * diag(max(diag(H), 1e-6)) for a stack of (n, n) blocks."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)[None]
    diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-6)
    return H + lam * eye * diag[:, :, None] * eye


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def bundle_adjust(
    prob: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    stage_iters: tuple = (5, 10),
    use_huber_stages: tuple = (True, False),
) -> BAResult:
    """Two-stage LM Schur BA with an outlier pass between stages (the
    reference's 5 + 10 iterations, src/Optimizer.cc:996-1035). Runs on
    the problem's device and returns device tensors."""
    P = prob.poses.shape[0]
    dev, dt = prob.points.device, prob.points.dtype
    f32 = dict(dtype=dt, device=dev)
    delta2 = torch.where(prob.obs_stereo, torch.tensor(CHI2_STEREO, **f32),
                         torch.tensor(CHI2_MONO, **f32))
    row_mask = torch.stack([torch.ones_like(delta2), torch.ones_like(delta2),
                            prob.obs_stereo.to(dt)], dim=-1)          # (L, K, 3)
    dofg = _gather_rows(prob.dof_mask, prob.obs_pose)                  # (L, K, 6)
    free = ((prob.pose_valid & ~prob.pose_fixed)[:, None].repeat(1, 6).reshape(-1)
            & (prob.dof_mask.reshape(-1) > 0.5))
    pinned = (prob.pose_fixed | ~prob.pose_valid)[:, None, None]
    eye3 = torch.eye(3, **f32)[None]
    diag_pin = torch.diag(torch.where(free, 0.0, 1.0) + 1e-9)
    arP = torch.arange(P, device=dev)

    def total_cost(poses, points, active, robust):
        res, behind = _residuals_only(poses, points, prob, fx, fy, cx, cy, bf)
        chi2 = _chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
        per = _robust_cost(chi2, delta2) if robust else chi2
        return torch.where(active & ~behind, per, torch.zeros_like(per)).sum()

    def lm_step(poses, points, lam, cost, active, robust):
        res, J_pose, J_point, behind = _residuals_jac(
            poses, points, prob, fx, fy, cx, cy, bf)
        ok = active & ~behind
        chi2 = _chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
        if robust:
            r_norm2 = torch.clamp(chi2, min=1e-12)
            huber_w = torch.where(r_norm2 > delta2, torch.sqrt(delta2 / r_norm2),
                                  torch.ones_like(chi2))
        else:
            huber_w = torch.ones_like(chi2)
        w = torch.where(ok, prob.obs_inv_sigma2 * huber_w, torch.zeros_like(chi2))
        J_pose_m = J_pose * dofg[..., None, :]
        wr = w[..., None] * row_mask                                   # (L, K, 3)
        Jw_pose = J_pose_m * wr[..., None]
        Jw_point = J_point * wr[..., None]

        # pose blocks: per-slot products summed into their poses
        Hpp = _pose_sum(torch.einsum("lkri,lkrj->lkij", Jw_pose, J_pose_m), prob.obs_pose, P)
        bp = _pose_sum(torch.einsum("lkri,lkr->lki", Jw_pose, res), prob.obs_pose, P)
        # point blocks: dense per-row reductions
        Hll = torch.einsum("lkri,lkrj->lij", Jw_point, J_point)       # (L, 3, 3)
        bl = torch.einsum("lkri,lkr->li", Jw_point, res)              # (L, 3)
        # coupling, dense over the pose axis
        U = _coupling(torch.einsum("lkri,lkrj->lkij", Jw_pose, J_point),
                      prob.obs_pose, P)                               # (L, P, 6, 3)

        # damp + invert point blocks (marginalization)
        Hll_inv = _inv3x3(_damped(Hll, lam) + 1e-9 * eye3)
        Hll_inv = torch.where(prob.point_valid[:, None, None], Hll_inv,
                              torch.zeros_like(Hll_inv))

        # reduced camera system
        W2 = torch.einsum("lpij,ljk->lpik", U, Hll_inv)               # (L, P, 6, 3)
        S = -torch.einsum("laik,lbjk->abij", W2, U)                   # (P, P, 6, 6)
        S[arP, arP] += _damped(Hpp, lam)
        b_red = bp - torch.einsum("lpij,lj->pi", W2, bl)              # (P, 6)

        # flatten to (6P, 6P), pin fixed/invalid poses to identity rows
        S_flat = S.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        S_flat = torch.where(free[:, None] & free[None, :], S_flat,
                             torch.zeros_like(S_flat)) + diag_pin
        b_flat = torch.where(free, b_red.reshape(-1), torch.zeros_like(free, dtype=dt))
        dx_p = -torch.linalg.solve_ex(S_flat, b_flat[:, None])[0][:, 0].reshape(P, 6)
        dx_p = dx_p * prob.dof_mask

        # back-substitute points
        rhs = bl + torch.einsum("lpij,pi->lj", U, dx_p)
        dx_l = -torch.einsum("lij,lj->li", Hll_inv, rhs)

        poses_new = torch.where(pinned, poses, se3.se3_retract(poses, dx_p))
        points_new = torch.where(prob.point_valid[:, None], points + dx_l, points)
        new_cost = total_cost(poses_new, points_new, active, robust)
        accept = new_cost < cost
        return (torch.where(accept, poses_new, poses),
                torch.where(accept, points_new, points),
                torch.where(accept, lam * 0.5, lam * 5.0),
                torch.where(accept, new_cost, cost))

    active = prob.obs_valid
    poses, points = prob.poses, prob.points
    cost = torch.zeros((), **f32)
    gate = torch.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    for iters, robust in zip(stage_iters, use_huber_stages):
        lam = torch.tensor(1e-4, **f32)
        cost = total_cost(poses, points, active, robust)
        for _ in range(iters):
            poses, points, lam, cost = lm_step(poses, points, lam, cost, active, robust)
        # outlier pass (reference drops chi2 > gate or depth <= 0 between stages)
        res, behind = _residuals_only(poses, points, prob, fx, fy, cx, cy, bf)
        chi2 = _chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
        active = prob.obs_valid & (chi2 <= gate) & ~behind

    return BAResult(poses=poses, points=points, obs_inlier=active, cost=cost)
