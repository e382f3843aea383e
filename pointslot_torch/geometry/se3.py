"""Batched SO(3)/SE(3) operations in PyTorch.

Port of ``pointslot_tpu/geometry/se3.py`` (the pieces the ported slices
use: the exp and log maps, the quaternion pivot, inverse and retraction).
Same conventions: poses are 4x4 matrices T mapping points FROM the
world/source frame TO the camera/target frame; tangent vectors are
``[upsilon, omega]`` (translation first). Every function takes arbitrary
leading batch dimensions, and the small-angle Taylor branches switch at the
same threshold as the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrices."""
    wx, wy, wz = omega.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor fallback: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    use_taylor = theta2 < _EPS
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = hat(omega)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(omega): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    use_taylor = theta2 < _EPS
    theta2_safe = torch.where(use_taylor, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(use_taylor, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    W = hat(omega)
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    use_taylor = theta2 < _EPS
    theta2_safe = torch.where(use_taylor, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    cot = torch.where(
        use_taylor, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / theta2_safe)
    W = hat(omega)
    return _eye3(W) - 0.5 * W + cot[..., None, None] * (W @ W)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [x, y, z, w], w >= 0: of the four
    constructions, the one with the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = root(1.0 + trace)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)
    pivots = torch.stack([trace, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    choice = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)                   # (..., 4, 4)
    q = torch.gather(qs, -2, choice[..., None, None].expand(choice.shape + (1, 4)))[..., 0, :]
    return torch.where(q[..., 3:4] < 0, -q, q)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) -> (..., 3), through the pivot-selected (pi-safe)
    quaternion: omega = 2 atan2(|q_v|, q_w) q_v / |q_v|, with a Taylor
    branch at q_v -> 0."""
    q = rot_to_quat(R)
    qv, qw = q[..., :3], q[..., 3]
    nv2 = torch.sum(qv * qv, dim=-1)
    small = nv2 < 1e-12
    nv_safe = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    theta = 2.0 * torch.atan2(nv_safe, qw)
    scale = torch.where(small, 2.0 + nv2 * (2.0 / 3.0), theta / nv_safe)
    return scale[..., None] * qv


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (..., 4, 4) -> (..., 6) [upsilon, omega]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    omega = so3_log(R)
    upsilon = torch.einsum("...ij,...j->...i", _left_jacobian_inv(omega), t)
    return torch.cat([upsilon, omega], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    # the identity's last row, made on the device (a tensor from host data
    # would be a synchronising copy); built without in-place writes, so
    # torch.func transforms pass through
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exp: tangent (..., 6) [upsilon, omega] -> (..., 4, 4)."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(omega), upsilon)
    return rt_to_mat(R, t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction exp(xi) * T."""
    return se3_exp(xi) @ T
