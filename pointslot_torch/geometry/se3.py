"""Batched SO(3)/SE(3) operations in PyTorch.

Port of ``pointslot_tpu/geometry/se3.py`` (the pieces the per-frame step
uses). Same conventions: poses are 4x4 matrices T mapping points FROM the
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


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    out = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


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
