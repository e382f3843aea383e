"""Trajectory and object export in the KITTI formats.

A copy of ``pointslot_tpu/io/writers.py``, byte-compatible with the
reference's savers, so external evaluation tools (evo, the KITTI devkit)
read them unchanged:

- ``write_trajectory_kitti`` / ``read_trajectory_kitti``: 12 floats per
  row, the top 3x4 of T_wc (System::SaveTrajectoryKITTI);
- ``write_object_detections_kitti``: one %06d.txt per frame in the KITTI
  3D-detection label format, type trunc occ alpha bbox(l t r b) h w l
  x y z ry score, with the reference's y += h/2 bottom-centre convention
  (System::SaveObjectDetectionKITTI, src/System.cc:409-473).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

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


def write_object_detections_kitti(out_dir: str, detections, n_frames: int):
    """detections: list of dicts with keys frame_id, bbox (x, y, w, h), dims
    (l, h, w), t_co (3,), pitch, truncated, occluded, alpha. Every frame
    gets a file, possibly empty, as the reference writes them."""
    os.makedirs(out_dir, exist_ok=True)
    per_frame: List[List[str]] = [[] for _ in range(n_frames)]
    for det in detections:
        f = det["frame_id"]
        if not (0 <= f < n_frames):
            continue
        x, y, w, h = det["bbox"]
        length, height, width = det["dims"]
        t = det["t_co"]
        line = (
            f"Car {det.get('truncated', 0.0):g} {det.get('occluded', 0.0):g} "
            f"{det.get('alpha', 0.0):g} "
            f"{x:g} {y:g} {x + w:g} {y + h:g} "
            f"{height:g} {width:g} {length:g} "
            f"{t[0]:g} {t[1] + height / 2:g} {t[2]:g} "
            f"{det.get('pitch', 0.0):g} 1"
        )
        per_frame[f].append(line)
    for f in range(n_frames):
        with open(os.path.join(out_dir, f"{f:06d}.txt"), "w") as fh:
            if per_frame[f]:
                fh.write("\n".join(per_frame[f]) + "\n")


def read_trajectory_kitti(path: str) -> np.ndarray:
    """Returns (N, 4, 4) camera-to-world poses."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out
