"""Offline visualization: 2D frame overlays + top-down map renders.

A copy of ``pointslot_tpu/viz/render.py`` for the port's System (the
cuboid corners from the port's ``solvers.object_factors``). It draws
through PIL, as the JAX module does: without PIL each function raises the
ImportError, and the runner's ``--viz`` and ``--live`` stop before the
first frame with its message.

The JAX module's description follows.

Replaces the reference's Pangolin viewer stack (reference src/Viewer.cc
render loop, src/FrameDrawer.cc keypoint/box overlays, src/MapDrawer.cc 3D
map points / keyframes / object cuboids / trajectories :128-:322) with a
headless renderer producing PNG frames — the right shape for a remote TPU
host (no GL); stitch the outputs into a video offline.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

_COLORS = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
]


def draw_frame(
    img: np.ndarray,
    keypoints: Optional[np.ndarray] = None,
    kp_valid: Optional[np.ndarray] = None,
    kp_bound: Optional[np.ndarray] = None,
    boxes: Optional[List[Tuple[np.ndarray, int]]] = None,
    status_text: str = "",
) -> np.ndarray:
    """FrameDrawer analog: keypoints (green = map-bound, blue = unbound),
    object boxes colored by track id. Returns an RGB uint8 image."""
    from PIL import Image, ImageDraw

    rgb = Image.fromarray(np.stack([img] * 3, axis=-1).astype(np.uint8))
    d = ImageDraw.Draw(rgb)
    if keypoints is not None:
        n = len(keypoints)
        valid = kp_valid if kp_valid is not None else np.ones(n, bool)
        bound = kp_bound if kp_bound is not None else np.zeros(n, bool)
        for (x, y), v, b in zip(keypoints, valid, bound):
            if not v:
                continue
            color = (0, 230, 60) if b else (70, 130, 255)
            d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=color)
    if boxes:
        for bbox, tid in boxes:
            x, y, w, h = bbox
            c = _COLORS[tid % len(_COLORS)]
            d.rectangle([x, y, x + w, y + h], outline=c, width=2)
            d.text((x + 3, y + 3), str(tid), fill=c)
    if status_text:
        d.text((8, 8), status_text, fill=(255, 255, 0))
    return np.asarray(rgb)


# the 12 cuboid wireframe edges over the (-,+)^3 corner ordering of
# object_factors.cuboid_corners (index bit k = sign of axis k)
_CUBOID_EDGES = [
    (a, b) for a in range(8) for b in range(a + 1, 8)
    if bin(a ^ b).count("1") == 1
]


def draw_frame_cuboids(
    img: np.ndarray,
    objects: List[Tuple[np.ndarray, np.ndarray, int]],
    fx: float, fy: float, cx: float, cy: float,
) -> np.ndarray:
    """Projected 3D cuboid wireframes of tracked objects, colored by track
    id (MapDrawer::DrawMapObjectsInCurrentFrame analog, reference
    src/MapDrawer.cc:322, projection per ObjectState::projectOntoImageBbox).

    objects: list of (T_co (4,4) camera-from-object pose, dims (3,) full
    extents, track_id)."""
    from PIL import Image, ImageDraw

    import torch

    from pointslot_torch.solvers.object_factors import cuboid_corners

    rgb = img if img.ndim == 3 else np.stack([img] * 3, axis=-1)
    im = Image.fromarray(rgb.astype(np.uint8))
    d = ImageDraw.Draw(im)
    H, W = rgb.shape[:2]
    for T_co, dims, tid in objects:
        corners = cuboid_corners(torch.from_numpy(np.asarray(dims, np.float32))).numpy()
        pc = corners @ np.asarray(T_co)[:3, :3].T + np.asarray(T_co)[:3, 3]
        if (pc[:, 2] <= 0.1).any():
            continue
        u = fx * pc[:, 0] / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        if (u < -W).all() or (u > 2 * W).all():
            continue
        c = _COLORS[tid % len(_COLORS)]
        for a, b in _CUBOID_EDGES:
            d.line([float(u[a]), float(v[a]), float(u[b]), float(v[b])],
                   fill=c, width=2)
        d.text((float(u.min()) + 3, float(v.min()) + 3), str(tid), fill=c)
    return np.asarray(im)


class MapSnapshot(NamedTuple):
    """The arrays a top-down map is drawn from."""

    points: np.ndarray          # (N, 3) valid map points, world frame
    keyframe_poses: np.ndarray  # (M, 4, 4) keyframe T_cw
    trajectory: np.ndarray      # (F, 4, 4) camera T_cw per tracked frame
    object_paths: list          # [(track_id, (n, 3) world positions by frame)]


def _read_map(system) -> MapSnapshot:
    m = system.map
    traj = system.camera_trajectory()
    paths = []
    if system._object_system is not None:
        for track in system._object_system.all_tracks:
            paths.append((track.track_id, np.array(
                [track.poses_world[f][:3, 3] for f in sorted(track.poses_world)]
            ).reshape(-1, 3)))
    return MapSnapshot(
        points=m.pt_pos[m.pt_valid],
        keyframe_poses=np.array([m.kf_pose[k] for k in m.keyframe_ids()]).reshape(-1, 4, 4),
        trajectory=np.array([T for _, T, _ in traj]).reshape(-1, 4, 4),
        object_paths=paths)


def map_snapshot(system) -> MapSnapshot:
    """The map's arrays, copied while ``system.map_lock`` is held (and the
    object system's lock, inside it). The mapping worker and the GBA's merge
    write them under that lock, so a drawing made from the copy, outside
    the lock, is never torn and never stalls the worker."""
    objs = system._object_system
    with system.map_lock, (objs._obj_lock if objs is not None else contextlib.nullcontext()):
        return _read_map(system)


def draw_map_topdown(
    system,
    size: int = 800,
    gt_trajectory: Optional[np.ndarray] = None,
) -> np.ndarray:
    """MapDrawer analog: map points, keyframes, camera trajectory and object
    trajectories projected to the x-z plane. Reads `system` as it stands;
    a System that async mapping writes is drawn as
    ``draw_map(map_snapshot(system))``."""
    return draw_map(_read_map(system), size, gt_trajectory)


def draw_map(
    snap: MapSnapshot,
    size: int = 800,
    gt_trajectory: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The top-down map of ``draw_map_topdown`` from a MapSnapshot."""
    from PIL import Image, ImageDraw

    pts = snap.points
    cam_xy = np.array(
        [np.linalg.inv(T)[:3, 3] for T in snap.trajectory]
    ) if len(snap.trajectory) else np.zeros((0, 3))

    xs, zs = [], []
    if len(pts):
        xs.append(pts[:, 0]); zs.append(pts[:, 2])
    if len(cam_xy):
        xs.append(cam_xy[:, 0]); zs.append(cam_xy[:, 2])
    if not xs:
        return np.zeros((size, size, 3), np.uint8)
    x_all = np.concatenate(xs); z_all = np.concatenate(zs)
    x0, x1 = np.percentile(x_all, [1, 99])
    z0, z1 = np.percentile(z_all, [1, 99])
    span = max(x1 - x0, z1 - z0, 1.0) * 1.15
    cx, cz = (x0 + x1) / 2, (z0 + z1) / 2

    def to_px(x, z):
        u = (x - cx) / span * size + size / 2
        v = size / 2 - (z - cz) / span * size
        return u, v

    img = Image.new("RGB", (size, size), (18, 18, 24))
    d = ImageDraw.Draw(img)
    if len(pts):
        u, v = to_px(pts[:, 0], pts[:, 2])
        for uu, vv in zip(u, v):
            if 0 <= uu < size and 0 <= vv < size:
                d.point((uu, vv), fill=(120, 120, 130))
    if gt_trajectory is not None and len(gt_trajectory):
        u, v = to_px(gt_trajectory[:, 0], gt_trajectory[:, 2])
        d.line(list(zip(u, v)), fill=(90, 90, 90), width=1)
    if len(cam_xy) > 1:
        u, v = to_px(cam_xy[:, 0], cam_xy[:, 2])
        d.line(list(zip(u, v)), fill=(0, 220, 90), width=2)
    for T_cw in snap.keyframe_poses:
        T_wc = np.linalg.inv(T_cw)
        u, v = to_px(T_wc[0, 3], T_wc[2, 3])
        d.rectangle([u - 2, v - 2, u + 2, v + 2], outline=(60, 160, 255))
    for track_id, positions in snap.object_paths:
        c = _COLORS[track_id % len(_COLORS)]
        path = [to_px(p[0], p[2]) for p in positions]
        if len(path) > 1:
            d.line(path, fill=c, width=2)
    return np.asarray(img)


def save_png(path: str, img: np.ndarray):
    from PIL import Image

    Image.fromarray(img).save(path)
