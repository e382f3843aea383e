"""The scene's ground truth, to hold the trajectory and the objects to what
the System guarantees.

- Camera tracking: the absolute trajectory error (ATE), the root mean square
  over the frames of the distance between the estimated and the true camera
  positions, as a share of the path driven. The System's world is the camera
  of the frame it started on, so the truth is taken relative to the first
  frame it tracked; nothing is aligned. The port's own end-to-end test holds a drive to an ATE under
  2 % of its path.
- Object tracking: which cars the offline detections show on the window's
  frames, and on how many of those frames the car's track holds a pose (the
  object system keeps a detection's track id); a car shown on enough frames
  has to hold one.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


def ate_share(T_wc_est: Dict[int, np.ndarray], T_wc_gt: np.ndarray, last: int) -> float:
    """RMS position error of the estimated frames up to `last` over the
    length of the true path from the first of them to `last`; inf without
    two estimates."""
    frames = sorted(f for f in T_wc_est if f <= last)
    if len(frames) < 2:
        return float("inf")
    first = frames[0]
    base = np.linalg.inv(T_wc_gt[first])
    gt = np.einsum("ij,fjk->fik", base, T_wc_gt[first:last + 1])[:, :3, 3]
    est = np.stack([T_wc_est[f][:3, 3] for f in frames])
    err = np.linalg.norm(est - gt[[f - first for f in frames]], axis=1)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return float(np.sqrt(np.mean(err ** 2)) / path)


def car_coverage(poses: Dict[Tuple[int, int], np.ndarray], rows: List[np.ndarray],
                 window: Iterable[int]) -> Dict[int, List[Tuple[int, float, bool]]]:
    """{track id: [(frame, distance ahead in m, has a pose)]} of every car
    the `window`'s detection rows show (column 1 the track id, column 14
    the centre's depth); `poses` keyed (track id, frame)."""
    seen: Dict[int, List[Tuple[int, float, bool]]] = {}
    for f in window:
        for r in np.asarray(rows[f]):
            t = int(r[1])
            seen.setdefault(t, []).append((f, float(r[14]), (t, f) in poses))
    return seen


def untracked_cars(coverage: Dict[int, List[Tuple[int, float, bool]]], near_m: float,
                   min_frames: int) -> List[int]:
    """The cars shown within `near_m` on `min_frames` or more frames, with a
    pose on none of those frames."""
    out = []
    for t, seen in sorted(coverage.items()):
        near = [posed for _, z, posed in seen if z <= near_m]
        if len(near) >= min_frames and not any(near):
            out.append(t)
    return out


def frames_near_before_pose(seen: List[Tuple[int, float, bool]], near_m: float) -> int:
    """Of one car's (frame, distance, has a pose) in frame order: the frames
    it is shown within `near_m` before its first pose there (all of them if
    it has none)."""
    n = 0
    for _, z, posed in seen:
        if z <= near_m:
            if posed:
                break
            n += 1
    return n
