"""The yardstick of the kernels' rooflines: the H100's peaks and the bytes of
the patch gather.

Peaks: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, NVIDIA's data
sheet (dense rates): 3.35 TB/s of HBM. A copy of the program's figures, kept
with the benchmark so that the yardstick does not move with the program.
"""

from __future__ import annotations

from typing import Sequence

import torch

HBM_BYTES_PER_S = 3.35e12
PATCH = 48                  # the gather's window, centred at the keypoint
HALF = PATCH // 2


def gather_bytes(plane_shapes: Sequence[tuple], xyl: torch.Tensor) -> int:
    """Bytes the gather of one launch needs at the least: K patches of
    48 x 48 float32 written, 12 bytes of coordinates per patch, and each
    distinct source pixel that a window covers inside its plane, read once.

    `plane_shapes` are the source planes, (h, w) or (G, h, w) for G images
    (image g's level l is row g * L + l); `xyl` (K, 3) holds each window's
    level column and row (x, y: the window's centre in level pixels) and its
    row of planes, clamped into range as the kernel clamps it."""
    L = len(plane_shapes)
    G = plane_shapes[0][0] if len(plane_shapes[0]) == 3 else 1
    dev = xyl.device
    x, y = xyl[:, 0].long(), xyl[:, 1].long()
    row = xyl[:, 2].long()
    row = torch.where(row < 0, row + G * L, row).clamp(0, G * L - 1)
    g, lvl = row // L, row % L
    hw = torch.tensor([tuple(s[-2:]) for s in plane_shapes], device=dev)[lvl]
    ar = torch.arange(PATCH, device=dev) - HALF
    r = y[:, None] + ar                      # (K, 48) plane rows
    c = x[:, None] + ar
    inside = ((r >= 0) & (r < hw[:, :1]))[:, :, None] & ((c >= 0) & (c < hw[:, 1:]))[:, None, :]
    Hm, Wm = int(hw[:, 0].max()) if len(hw) else 1, int(hw[:, 1].max()) if len(hw) else 1
    flat = ((row[:, None, None] * Hm + r[:, :, None].clamp(0, Hm - 1)) * Wm
            + c[:, None, :].clamp(0, Wm - 1))
    distinct = int(torch.unique(flat[inside]).numel())
    K = xyl.shape[0]
    return 4 * distinct + 12 * K + 4 * K * PATCH * PATCH
