"""Windowed bundle adjustment with an explicit Schur complement.

Port of ``pointslot_tpu/solvers/local_ba.py``: ``BAProblem``, ``BAResult``,
``MotionPriors``, the host-side ``build_problem`` / ``build_motion_priors``
(copies: flat edge lists packed into the point-major (L, K) slot layout),
``stack_problems``, and ``bundle_adjust`` / ``bundle_adjust_batched`` (the
reference's LocalBundleAdjustment: 5 + 10 LM iterations with an outlier
pass between the stages, points marginalized, optional SE(3) motion priors
between pose pairs).

What changes on the card:
- the solver runs on a leading problem axis B: ``bundle_adjust`` is the
  batch of one, ``bundle_adjust_batched`` solves a stack of same-shape
  problems in one pass (the reference's ``jax.vmap``);
- the pose-block sums (``Hpp``, ``bp``), the coupling ``U`` and the prior
  blocks contract a one-hot of each slot's pose, as the reference does, as
  batched GEMMs. Their sums run in a fixed order, so a solve repeats bit
  for bit on the card under torch's default algorithms (a scatter-add's
  atomics land in no fixed order). The gathers are ``index_select``;
- ``fori_loop`` becomes exactly ``n_iters`` Python iterations that accept
  or reject per problem with ``torch.where``, and the (6P, 6P) solve is
  ``linalg.solve_ex``: the solve has no host sync;
- the priors' Jacobians come from ``torch.func.jacfwd``, as the
  reference's from ``jax.jacfwd``.

Left for later (ROADMAP item 15): the sharded (``axis_name``) form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pointslot_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. P poses, L points, K obs slots per point.
    A stack of problems (``stack_problems``) has a leading axis B on every
    field."""

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


class MotionPriors(NamedTuple):
    """SE(3) relative-pose factors between pose pairs (the reference's
    EdgeMotionModel / EdgeSmoothTerm role): pose j is predicted from pose i
    by T_rel, residual log(T_j (T_rel T_i)^-1), weight an information
    scale."""

    idx: torch.Tensor     # (R, 2) int32 (i_prev, j_cur) pose indices
    T_rel: torch.Tensor   # (R, 4, 4) predicted T_j<-i
    weight: torch.Tensor  # (R,) information scale (per factor)
    valid: torch.Tensor   # (R,) bool


def _on(device, *arrays):
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def build_motion_priors(idx: np.ndarray, T_rel: np.ndarray, weight: np.ndarray,
                        R_cap: int, device="cuda") -> MotionPriors:
    """Pad flat prior arrays to a fixed capacity, on `device`."""
    idx = np.asarray(idx, np.int32).reshape(-1, 2)
    n = min(len(idx), R_cap)
    pidx = np.zeros((R_cap, 2), np.int32)
    pT = np.tile(np.eye(4, dtype=np.float32), (R_cap, 1, 1))
    pw = np.zeros(R_cap, np.float32)
    pv = np.zeros(R_cap, bool)
    pidx[:n] = idx[:n]
    pT[:n] = np.asarray(T_rel, np.float32).reshape(-1, 4, 4)[:n]
    pw[:n] = np.asarray(weight, np.float32).reshape(-1)[:n]
    pv[:n] = True
    return MotionPriors(*_on(device, pidx, pT, pw, pv))


def empty_motion_priors(R_cap: int = 32, device="cuda") -> MotionPriors:
    """All-invalid priors (zero weight), the filler of a batch."""
    return build_motion_priors(np.zeros((0, 2)), np.zeros((0, 4, 4)), np.zeros(0),
                               R_cap, device)


def stack_problems(items: Sequence[NamedTuple]) -> NamedTuple:
    """Stack same-shape BAProblems (or MotionPriors) along a new leading
    axis for ``bundle_adjust_batched``."""
    return type(items[0])(*(torch.stack(fields) for fields in zip(*items)))


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
    return BAProblem(*_on(device, *host)), slot_edge


# ---------------------------------------------------------------------------
# device-side pieces, on a leading problem axis B
# ---------------------------------------------------------------------------

def _lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-problem (B,) value shaped to broadcast over `like` (B, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, P, ...) gathered per problem by integer idx (B, ...) (exact)."""
    B, P = table.shape[:2]
    offset = torch.arange(B, device=idx.device) * P
    rows = (idx.long() + _lanes(offset, idx)).reshape(-1)
    out = table.reshape(B * P, -1).index_select(0, rows)
    return out.reshape(idx.shape + table.shape[2:])


def _onehot(idx: torch.Tensor, P: int, dtype) -> torch.Tensor:
    """(B, ...) pose indices -> (B, n, P) one-hot over the flattened slots."""
    ar = torch.arange(P, dtype=idx.dtype, device=idx.device)
    return (idx.reshape(idx.shape[0], -1, 1) == ar).to(dtype)


def _pose_sum(values: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Sum (B, n, ...) slot values into their poses -> (B, P, ...): one GEMM
    per problem, whose sums run in a fixed order."""
    B, n = values.shape[:2]
    out = torch.bmm(onehot.transpose(1, 2), values.reshape(B, n, -1))
    return out.reshape((B, onehot.shape[2]) + values.shape[2:])


def _coupling(G: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(B, L, K, 6, 3) slot couplings -> dense (B, L, P, 6, 3), the slots of
    one point summed into their pose's column (one small GEMM per point)."""
    B, L, K = G.shape[:3]
    P = onehot.shape[2]
    oh = onehot.reshape(B * L, K, P).transpose(1, 2)
    return torch.bmm(oh, G.reshape(B * L, K, -1)).reshape((B, L, P) + G.shape[3:])


def _transform(poses, points, prob: BAProblem):
    """Camera-frame points (B, L, K, 3) of every slot, and the slots' poses."""
    T = _gather_rows(poses, prob.obs_pose)                    # (B, L, K, 4, 4)
    pc = torch.einsum("blkij,blj->blki", T[..., :3, :3], points) + T[..., :3, 3]
    return pc, T


def _residuals_only(poses, points, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (B, L, K, 3) + behind-camera mask, no Jacobians."""
    pc, _ = _transform(poses, points, prob)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    res = torch.stack([u, v, u - bf / z], dim=-1) - prob.obs_uvr
    return res, pc[..., 2] <= 0.05


def _residuals_jac(poses, points, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (B, L, K, 3), pose Jac (B, L, K, 3, 6), point Jac (B, L, K, 3, 3)."""
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
    J_p = torch.stack([du_dp, dv_dp, dur_dp], dim=-2)        # (B, L, K, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)         # (B, L, K, 3, 6)
    J_pose = J_p @ dpc_dxi                                   # (B, L, K, 3, 6)
    J_point = J_p @ T[..., :3, :3]                           # (B, L, K, 3, 3)
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
    """H + lam * diag(max(diag(H), 1e-6)) for (B, ..., n, n) blocks, lam (B,)."""
    diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
    return H + torch.diag_embed(_lanes(lam, diag) * diag)


def _prior_residual(poses, priors: MotionPriors):
    """(B, R, 6) residuals log(T_j (T_rel T_i)^-1) of the motion priors."""
    Ti = _gather_rows(poses, priors.idx[..., 0])
    Tj = _gather_rows(poses, priors.idx[..., 1])
    return se3.se3_log(Tj @ se3.se3_inverse(priors.T_rel @ Ti))


def _prior_one(xi, Ti, Tj, Trel):
    """One prior's residual at the tangent updates xi = (xi_i, xi_j). It
    works on a leading axis of one: forward-mode AD gives 0-dim
    intermediates float64 tangents where a Python float divides them."""
    xi = xi[None]
    pred = Trel @ se3.se3_retract(Ti, xi[:, :6])
    return se3.se3_log(se3.se3_retract(Tj, xi[:, 6:]) @ se3.se3_inverse(pred))[0]


def _prior_terms(poses, priors: MotionPriors):
    """Gauss-Newton pieces of the motion priors: residuals r (B, R, 6),
    Jacobians J_i, J_j (B, R, 6, 6) wrt the two poses' tangent updates,
    weights w (B, R)."""
    Ti = _gather_rows(poses, priors.idx[..., 0])
    Tj = _gather_rows(poses, priors.idx[..., 1])
    B, R = Ti.shape[:2]
    zero = torch.zeros(12, dtype=poses.dtype, device=poses.device)
    jac = torch.func.vmap(torch.func.jacfwd(_prior_one), in_dims=(None, 0, 0, 0))
    J = jac(zero, Ti.reshape(-1, 4, 4), Tj.reshape(-1, 4, 4),
            priors.T_rel.reshape(-1, 4, 4)).reshape(B, R, 6, 12)
    r = _prior_residual(poses, priors)
    w = torch.where(priors.valid, priors.weight, torch.zeros_like(priors.weight))
    return r, J[..., :6], J[..., 6:], w


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _solve(prob: BAProblem, fx, fy, cx, cy, bf, stage_iters, use_huber_stages,
           priors: Optional[MotionPriors]) -> BAResult:
    """The two-stage LM over a stack of B problems (every field has a
    leading axis B); each problem accepts or rejects its own steps."""
    B, P = prob.poses.shape[:2]
    dev, dt = prob.points.device, prob.points.dtype
    f32 = dict(dtype=dt, device=dev)
    delta2 = torch.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    row_mask = torch.stack([torch.ones_like(delta2), torch.ones_like(delta2),
                            prob.obs_stereo.to(dt)], dim=-1)          # (B, L, K, 3)
    dofg = _gather_rows(prob.dof_mask, prob.obs_pose)                  # (B, L, K, 6)
    onehot = _onehot(prob.obs_pose, P, dt)                             # (B, L*K, P)
    free = ((prob.pose_valid & ~prob.pose_fixed)[..., None].expand(B, P, 6).reshape(B, -1)
            & (prob.dof_mask.reshape(B, -1) > 0.5))                    # (B, 6P)
    pinned = (prob.pose_fixed | ~prob.pose_valid)[..., None, None]
    eye3 = torch.eye(3, **f32)
    diag_pin = torch.diag_embed(torch.where(free, 0.0, 1.0) + 1e-9)
    arP = torch.arange(P, device=dev)
    if priors is not None:
        oh_i = _onehot(priors.idx[..., 0], P, dt)                      # (B, R, P)
        oh_j = _onehot(priors.idx[..., 1], P, dt)
        dof_i = _gather_rows(prob.dof_mask, priors.idx[..., 0])        # (B, R, 6)
        dof_j = _gather_rows(prob.dof_mask, priors.idx[..., 1])

    def total_cost(poses, points, active, robust):
        res, behind = _residuals_only(poses, points, prob, fx, fy, cx, cy, bf)
        chi2 = _chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
        per = _robust_cost(chi2, delta2) if robust else chi2
        cost = torch.where(active & ~behind, per, torch.zeros_like(per)).sum(dim=(1, 2))
        if priors is not None:
            r = _prior_residual(poses, priors)
            w = torch.where(priors.valid, priors.weight, torch.zeros_like(priors.weight))
            cost = cost + (w * (r * r).sum(dim=-1)).sum(dim=-1)
        return cost

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
        wr = w[..., None] * row_mask                                   # (B, L, K, 3)
        Jw_pose = J_pose_m * wr[..., None]
        Jw_point = J_point * wr[..., None]

        # pose blocks: per-slot products contracted with the pose one-hot
        Hpp = _pose_sum(torch.einsum("blkri,blkrj->blkij", Jw_pose, J_pose_m)
                        .flatten(1, 2), onehot)                       # (B, P, 6, 6)
        bp = _pose_sum(torch.einsum("blkri,blkr->blki", Jw_pose, res).flatten(1, 2),
                       onehot)                                         # (B, P, 6)
        # point blocks: dense per-row reductions
        Hll = torch.einsum("blkri,blkrj->blij", Jw_point, J_point)    # (B, L, 3, 3)
        bl = torch.einsum("blkri,blkr->bli", Jw_point, res)           # (B, L, 3)
        # coupling, dense over the pose axis
        U = _coupling(torch.einsum("blkri,blkrj->blkij", Jw_pose, J_point),
                      onehot)                                          # (B, L, P, 6, 3)

        # damp + invert point blocks (marginalization)
        Hll_inv = _inv3x3(_damped(Hll, lam) + 1e-9 * eye3)
        Hll_inv = torch.where(prob.point_valid[..., None, None], Hll_inv,
                              torch.zeros_like(Hll_inv))

        if priors is not None:
            # motion priors: pose-pose factors straight into the reduced
            # system (diagonal blocks into Hpp, so the damping sees them)
            pr, Ji, Jj, pw = _prior_terms(poses, priors)
            Ji = Ji * dof_i[..., None, :]
            Jj = Jj * dof_j[..., None, :]
            Jiw = Ji * pw[..., None, None]
            Jjw = Jj * pw[..., None, None]
            Hpp = (Hpp + _pose_sum(torch.einsum("brki,brkj->brij", Jiw, Ji), oh_i)
                   + _pose_sum(torch.einsum("brki,brkj->brij", Jjw, Jj), oh_j))
            bp = (bp + _pose_sum(torch.einsum("brki,brk->bri", Jiw, pr), oh_i)
                  + _pose_sum(torch.einsum("brki,brk->bri", Jjw, pr), oh_j))
            H_ij = torch.einsum("brki,brkj->brij", Jiw, Jj)           # (B, R, 6, 6)
            # the (i, j) blocks, S[i, j] += H_ij, as one GEMM per problem
            cross = _pose_sum(oh_j[..., None, None] * H_ij[:, :, None], oh_i)

        # reduced camera system
        W2 = torch.einsum("blpij,bljk->blpik", U, Hll_inv)            # (B, L, P, 6, 3)
        S = -torch.einsum("zlaik,zlcjk->zacij", W2, U)                # (B, P, P, 6, 6)
        S[:, arP, arP] += _damped(Hpp, lam)
        b_red = bp - torch.einsum("blpij,blj->bpi", W2, bl)           # (B, P, 6)
        if priors is not None:
            S = S + cross + cross.permute(0, 2, 1, 4, 3)

        # flatten to (6P, 6P), pin fixed/invalid poses to identity rows
        S_flat = S.permute(0, 1, 3, 2, 4).reshape(B, 6 * P, 6 * P)
        S_flat = torch.where(free[:, :, None] & free[:, None, :], S_flat,
                             torch.zeros_like(S_flat)) + diag_pin
        b_flat = torch.where(free, b_red.reshape(B, -1), torch.zeros_like(free, dtype=dt))
        dx_p = -torch.linalg.solve_ex(S_flat, b_flat[..., None])[0][..., 0].reshape(B, P, 6)
        dx_p = dx_p * prob.dof_mask

        # back-substitute points (a matmul over the 6P columns: the einsum's
        # own contraction order strayed 10x further from the reference's)
        L = U.shape[1]
        rhs = bl + (U.reshape(B, L, 6 * P, 3).transpose(2, 3)
                    @ dx_p.reshape(B, 1, 6 * P, 1))[..., 0]
        dx_l = -torch.einsum("blij,blj->bli", Hll_inv, rhs)

        poses_new = torch.where(pinned, poses, se3.se3_retract(poses, dx_p))
        points_new = torch.where(prob.point_valid[..., None], points + dx_l, points)
        new_cost = total_cost(poses_new, points_new, active, robust)
        accept = new_cost < cost
        return (torch.where(_lanes(accept, poses), poses_new, poses),
                torch.where(_lanes(accept, points), points_new, points),
                torch.where(accept, lam * 0.5, lam * 5.0),
                torch.where(accept, new_cost, cost))

    active = prob.obs_valid
    poses, points = prob.poses, prob.points
    cost = torch.zeros(B, **f32)
    gate = torch.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    for iters, robust in zip(stage_iters, use_huber_stages):
        lam = torch.full((B,), 1e-4, **f32)
        cost = total_cost(poses, points, active, robust)
        for _ in range(iters):
            poses, points, lam, cost = lm_step(poses, points, lam, cost, active, robust)
        # outlier pass (reference drops chi2 > gate or depth <= 0 between stages)
        res, behind = _residuals_only(poses, points, prob, fx, fy, cx, cy, bf)
        chi2 = _chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
        active = prob.obs_valid & (chi2 <= gate) & ~behind

    return BAResult(poses=poses, points=points, obs_inlier=active, cost=cost)


def bundle_adjust(
    prob: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    stage_iters: tuple = (5, 10),
    use_huber_stages: tuple = (True, False),
    priors: Optional[MotionPriors] = None,
) -> BAResult:
    """Two-stage LM Schur BA with an outlier pass between stages (the
    reference's 5 + 10 iterations, src/Optimizer.cc:996-1035), with
    optional motion priors. Runs on the problem's device and returns device
    tensors."""
    one = stack_problems([prob])
    pri = None if priors is None else stack_problems([priors])
    out = _solve(one, fx, fy, cx, cy, bf, stage_iters, use_huber_stages, pri)
    return BAResult(*(x[0] for x in out))


def bundle_adjust_batched(
    probs: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    priors: Optional[MotionPriors] = None,
    stage_iters: tuple = (5, 10),
    use_huber_stages: tuple = (True, False),
) -> BAResult:
    """Solve a stack of same-shape BA problems (``stack_problems``) in one
    pass; every field of the result has the leading problem axis.
    ``priors``, when given, is stacked the same way."""
    return _solve(probs, fx, fy, cx, cy, bf, stage_iters, use_huber_stages, priors)
