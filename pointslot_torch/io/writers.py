"""Trajectory export in the KITTI odometry format.

A copy of ``write_trajectory_kitti`` / ``read_trajectory_kitti`` from
``pointslot_tpu/io/writers.py``: 12 floats per row, the top 3x4 of T_wc,
byte-compatible with the reference's System::SaveTrajectoryKITTI, so
external evaluation tools (evo, the KITTI devkit) read it unchanged.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def write_trajectory_kitti(path: str, trajectory: Iterable[Tuple[int, np.ndarray, bool]]):
    """trajectory: iterable of (frame_id, T_cw, lost)."""
    lines = []
    for _, T_cw, _ in trajectory:
        T_wc = np.linalg.inv(T_cw)
        r = T_wc[:3, :4].reshape(-1)
        lines.append(" ".join(f"{v:.9f}" for v in r))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_trajectory_kitti(path: str) -> np.ndarray:
    """Returns (N, 4, 4) camera-to-world poses."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out
