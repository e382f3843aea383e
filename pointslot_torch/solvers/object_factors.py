"""Object-state factors beyond point reprojection.

Port of ``pointslot_tpu/solvers/object_factors.py``: the cuboid helpers
(the reference's ObjectState::compute3D_BoxCorner and its box projection,
include/g2o_Object.h:100/:172), the 4D bbox residual
(EdgeSE3CuboidFixScaleProj :245), the motion-model and smoothness residuals
(:361-:396), the planar bicycle velocity (:202) and
``fine_tune_with_bbox`` (Tracking::FineTuningUsing2dBox,
src/Tracking.cc:1704-1786: a Gauss-Newton alignment of the projected cuboid
to the detected 2D box, over the translation and optionally the yaw).

The Jacobians come from ``torch.func.jacfwd``, as the reference's from
``jax.jacfwd``; its min/max pick the extreme corner and split ties evenly,
as jax's do. ``fine_tune_with_bbox`` runs its fixed 12 iterations with
``solve_ex``, with no host sync.
"""

from __future__ import annotations

import torch

from pointslot_torch.geometry import se3


def cuboid_corners(dims: torch.Tensor) -> torch.Tensor:
    """(3,) full extents -> (8, 3) corners in the object frame, corner
    4 bx + 2 by + bz at sign (2 b - 1) per axis (x outermost, as the
    reference lists them), made on the device without a host copy."""
    i = torch.arange(8, device=dims.device)
    bits = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=-1)
    return (bits.to(dims.dtype) * 2 - 1) * (dims / 2.0)[..., None, :]


def project_cuboid_bbox(T_co: torch.Tensor, dims: torch.Tensor,
                        fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """Projected axis-aligned bbox (xmin, ymin, xmax, ymax) of the cuboid;
    T_co (..., 4, 4)."""
    pc = se3.transform_points(T_co, cuboid_corners(dims))
    z = torch.clamp(pc[..., 2], min=0.1)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    return torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)], dim=-1)


def bbox_residual(T_co, dims, det_bbox_xywh, fx, fy, cx, cy) -> torch.Tensor:
    """4D residual: projected bbox minus the detected (x, y, w, h) box."""
    x, y, w, h = det_bbox_xywh.unbind(-1)
    det = torch.stack([x, y, x + w, y + h], dim=-1)
    return project_cuboid_bbox(T_co, dims, fx, fy, cx, cy) - det


def motion_model_residual(T_wo_prev, T_wo_cur, velocity_T):
    """6D residual of the current pose against the constant-velocity
    prediction velocity_T @ T_prev."""
    pred = velocity_T @ T_wo_prev
    return se3.se3_log(torch.linalg.solve(pred, T_wo_cur))


def smoothness_residual(vel_prev_T, vel_cur_T, angular_weight: float = 2.0):
    """6D residual between consecutive velocities, the angular part
    up-weighted (the reference's EdAngularVelThanLinearVelBAWeightTimes)."""
    r = se3.se3_log(torch.linalg.solve(vel_prev_T, vel_cur_T))
    w = torch.tensor([1.0, 1.0, 1.0, angular_weight, angular_weight, angular_weight],
                     dtype=r.dtype, device=r.device)
    return r * w


def planar_velocity_to_se2(v: torch.Tensor, steer: torch.Tensor, axle: float = 0.15,
                           dt: float = 1.0) -> torch.Tensor:
    """Bicycle-model planar motion: forward speed + steering angle -> per-frame
    SE(3) in the object's x-z plane (y down, yaw about y)."""
    dyaw = v * torch.tan(steer) / max(axle, 1e-6) * dt
    return se3.rt_to_mat(_rotation_y(dyaw), torch.stack(
        [torch.zeros_like(v), torch.zeros_like(v), v * dt], dim=-1))


def _rotation_y(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


def _apply(T: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """T with its translation moved by params[..., :3] and, with a 4th
    parameter, its rotation turned by that yaw."""
    R, t = T[..., :3, :3], T[..., :3, 3] + params[..., :3]
    if params.shape[-1] == 4:
        R = _rotation_y(params[..., 3]) @ R
    return se3.rt_to_mat(R, t)


def fine_tune_with_bbox(
    T_init: torch.Tensor,           # (4, 4) camera-from-object
    dims: torch.Tensor,             # (3,) full extents, object x, y, z
    det_bbox_xywh: torch.Tensor,    # (4,) detected box
    fx: float, fy: float, cx: float, cy: float,
    n_iters: int = 12,
    optimize_yaw: bool = False,
    damping: float = 1e-3,
) -> torch.Tensor:
    """Gauss-Newton alignment of the projected cuboid to the detected box
    over the translation (optionally + yaw), n_iters fixed iterations."""
    n_dof = 4 if optimize_yaw else 3
    T = T_init

    def residual(params, T):
        # a leading axis of one: forward-mode AD gives a 0-dim intermediate
        # a float64 tangent where a Python float divides it
        return bbox_residual(_apply(T, params[None]), dims, det_bbox_xywh,
                             fx, fy, cx, cy)[0]

    eye = torch.eye(n_dof, dtype=T.dtype, device=T.device)
    p0 = torch.zeros(n_dof, dtype=T.dtype, device=T.device)
    for _ in range(n_iters):
        r = residual(p0, T)
        J = torch.func.jacfwd(residual)(p0, T)               # (4, n_dof)
        H = J.T @ J + damping * eye
        dp = -torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]
        T = _apply(T[None], dp[None])[0]
    return T
