"""Camera distortion model (radial-tangential, OpenCV convention).

Port of ``pointslot_tpu/geometry/camera.py``. The reference undistorts
keypoints when the calibration carries distortion (Frame::
UndistortKeyPoints via cv::undistortPoints; a no-op on rectified KITTI
where mDistCoef(0) == 0, reference src/Frame.cc). The System applies
``undistort_points`` to the frame's keypoints when k1, k2, p1 or p2 is
nonzero, on the System's device, in float32 like the reference.
"""

from __future__ import annotations

import torch


def distort_normalized(xn: torch.Tensor, k1: float, k2: float,
                       p1: float, p2: float) -> torch.Tensor:
    """Forward radial-tangential model on normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(xy: torch.Tensor, fx: float, fy: float,
                     cx: float, cy: float, k1: float, k2: float,
                     p1: float, p2: float, iters: int = 8) -> torch.Tensor:
    """Pixel coords (..., 2) on the distorted image -> undistorted pixel
    coords: a fixed number of fixed-point steps inverting the distortion
    model (the standard cv::undistortPoints iteration)."""
    xd = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], dim=-1)
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_normalized(xn, k1, k2, p1, p2) - xn)
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)
