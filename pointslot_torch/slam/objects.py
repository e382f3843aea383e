"""Object-layer data model: detections, persistent object tracks, object
keyframes and object-frame landmarks.

A copy of ``pointslot_tpu/slam/objects.py`` (host numpy code), with the
SE(3) log and exp of a multi-frame velocity taken from the port's
``geometry/se3.py`` on the host. It replaces the reference's object data
classes with SoA tables + light host records:

- DetectionObject (reference src/DetectionObject.cc, include/DetectionObject.h:32-67):
  per-frame 2D/3D detection record -> :class:`Detection`.
- MapObject (reference src/MapObject.cc, include/MapObject.h): persistent
  track with per-frame camera-frame states, velocity, dynamic-flag
  hysteresis, relative-pose log -> :class:`ObjectTrack`.
- MapObjectPoint (reference src/MapObjectPoint.cc): landmark in the OBJECT
  frame -> rows of the per-track point table.
- ObjectKeyFrame (reference src/ObjectKeyFrame.cpp): per-object snapshot of
  one frame's features + pose, with its own covisibility ->
  :class:`ObjectKeyFrameRec` + derived covisibility from the per-track
  observation matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pointslot_torch.geometry import se3


@dataclass
class Detection:
    """One 2D/3D detection in one frame (the reference's 1x24 row,
    src/Tracking.cc:574-610)."""

    frame_id: int
    track_id: int
    bbox: np.ndarray                 # (4,) x, y, w, h
    dims: np.ndarray                 # (3,) length, height, width (KITTI h/w/l order normalized)
    location_cam: np.ndarray         # (3,) object center in camera frame (GT/detector)
    rotation_y: float
    mask_value: int                  # pixel value in the instance mask
    score: float = 1.0
    truncated: float = 0.0
    occluded: float = 0.0
    alpha: float = 0.0
    is_moving: bool = True

    @classmethod
    def from_row24(cls, row: np.ndarray, mask_value: int) -> "Detection":
        return cls(
            frame_id=int(row[0]),
            track_id=int(row[1]),
            truncated=float(row[2]),
            occluded=float(row[3]),
            alpha=float(row[4]),
            bbox=np.asarray(row[5:9], np.float64),
            dims=np.asarray(row[9:12], np.float64),
            location_cam=np.asarray(row[12:15], np.float64),
            rotation_y=float(row[15]),
            score=float(row[16]),
            is_moving=bool(row[18]),
            mask_value=mask_value,
        )


@dataclass
class ObjectKeyFrameRec:
    """Snapshot of one object's features in one frame (reference
    ObjectKeyFrame ctor src/ObjectKeyFrame.cpp:18-66)."""

    obj_kf_id: int                   # per-object sequential id (mnObjId analog)
    frame_id: int
    T_co: np.ndarray                 # (4, 4) object -> camera at this frame
    T_cw: np.ndarray                 # camera pose of the frame (for export)
    xy: np.ndarray                   # (F, 2) feature positions
    level: np.ndarray
    desc: np.ndarray                 # (F, 8)
    angle: np.ndarray
    depth: np.ndarray
    u_right: np.ndarray
    point_idx: np.ndarray            # (F,) object-point row or -1
    bbox: np.ndarray = None


@dataclass
class ObjectTrack:
    """Persistent rigid-object track (MapObject analog)."""

    track_id: int
    dims: np.ndarray
    max_points: int = 512

    # object-frame landmark table
    pt_pos: np.ndarray = None        # (P, 3) in OBJECT frame
    pt_desc: np.ndarray = None       # (P, 8) uint32
    pt_valid: np.ndarray = None
    pt_found: np.ndarray = None
    pt_visible: np.ndarray = None
    pt_first_okf: np.ndarray = None
    # last observed pixel of each point + the frame it was seen in — the
    # anchor for offline-optical-flow warping (the reference reads the
    # last frame's keypoint positions directly, src/ORBmatcher.cc:2257)
    pt_last_xy: np.ndarray = None    # (P, 2) float32
    pt_last_angle: np.ndarray = None  # (P,) float32 keypoint orientation
    pt_last_frame: np.ndarray = None  # (P,) int64, -1 = never

    keyframes: List[ObjectKeyFrameRec] = field(default_factory=list)
    obs: np.ndarray = None           # (P, MAX_OKF) point-in-objkf incidence

    # per-frame state maps (MapObject::mmCFAllFsObjStates analog)
    poses_cf: Dict[int, np.ndarray] = field(default_factory=dict)     # frame -> T_co
    poses_world: Dict[int, np.ndarray] = field(default_factory=dict)  # frame -> T_wo
    detections: Dict[int, Detection] = field(default_factory=dict)
    rel_pose_log: Dict[int, tuple] = field(default_factory=dict)      # frame -> (okf_idx, T_rel)

    velocity_world: Optional[np.ndarray] = None   # (4,4) per-dt world-frame motion
    last_seen_frame: int = -1
    last_seen_time: float = -1.0
    dynamic: bool = False
    dyn_votes: int = 0               # consecutive same-direction votes
    track_ok: bool = False
    n_inliers: int = 0
    flow_tracked_frames: int = 0     # frames matched via offline-flow warp
    # bumped on wholesale table resets (re-init) so an in-flight async BA
    # solve built against the old tables is discarded at write-back
    epoch: int = 0
    MAX_OKF: int = 128

    def __post_init__(self):
        P = self.max_points
        self.pt_pos = np.zeros((P, 3), np.float64)
        self.pt_desc = np.zeros((P, 8), np.uint32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_found = np.zeros(P, np.int32)
        self.pt_visible = np.zeros(P, np.int32)
        self.pt_first_okf = np.full(P, -1, np.int32)
        self.pt_last_xy = np.zeros((P, 2), np.float32)
        self.pt_last_angle = np.zeros(P, np.float32)
        self.pt_last_frame = np.full(P, -1, np.int64)
        self.obs = np.zeros((P, self.MAX_OKF), bool)

    # ------------------------------------------------------------------
    def alloc_points(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.pt_valid)[0][:n]
        self.pt_valid[free] = True
        return free

    def cull_points(self, idx: np.ndarray):
        idx = np.atleast_1d(idx)
        if len(idx) == 0:
            return
        self.pt_valid[idx] = False
        self.obs[idx, :] = False
        for okf in self.keyframes:
            sel = np.isin(okf.point_idx, idx)
            okf.point_idx[sel] = -1

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def remove_keyframes(self, idxs) -> None:
        """Drop culled object keyframes and compact every structure keyed
        by okf index (the SoA form of ObjectKeyFrame::SetBadFlag +
        erase-from-map, reference src/ObjectKeyFrame.cpp): `obs` columns,
        `pt_first_okf`, the obj_kf_id == list-index invariant, and
        `rel_pose_log` anchors (entries anchored on a removed KF are
        rebased onto the nearest surviving KF by frame id). Points whose
        every observation was in removed KFs are culled."""
        n = len(self.keyframes)
        removed = {int(i) for i in np.atleast_1d(idxs)
                   if 0 < int(i) < n}
        if not removed:
            return
        keep = [i for i in range(n) if i not in removed]
        old2new = np.full(n, -1, np.int64)
        old2new[keep] = np.arange(len(keep))
        old_T = [kf.T_co.copy() for kf in self.keyframes]
        surv_fids = np.array([self.keyframes[i].frame_id for i in keep])

        for f, (okf_id, T_rel) in list(self.rel_pose_log.items()):
            if okf_id >= n:
                continue
            if okf_id in removed:
                a = int(np.argmin(np.abs(
                    surv_fids - self.keyframes[okf_id].frame_id)))
                T_new = T_rel @ old_T[okf_id] @ np.linalg.inv(old_T[keep[a]])
                self.rel_pose_log[f] = (a, T_new)
            else:
                self.rel_pose_log[f] = (int(old2new[okf_id]), T_rel)

        self.keyframes = [self.keyframes[i] for i in keep]
        for nw, okf in enumerate(self.keyframes):
            okf.obj_kf_id = nw
        new_obs = np.zeros_like(self.obs)
        new_obs[:, : len(keep)] = self.obs[:, keep]
        self.obs = new_obs

        # first-observer fell away -> earliest surviving observation
        first = self.pt_first_okf
        has = first >= 0
        mapped = np.where(has, old2new[np.clip(first, 0, n - 1)], -1)
        any_obs = self.obs[:, : len(keep)].any(axis=1)
        earliest = np.argmax(self.obs[:, : len(keep)], axis=1)
        orphan = has & (mapped < 0)
        self.pt_first_okf = np.where(
            orphan & any_obs, earliest, mapped
        ).astype(np.int32)
        dead = self.pt_valid & ~any_obs
        if dead.any():
            self.cull_points(np.nonzero(dead)[0])

    # ------------------------------------------------------------------
    def covisibility_weights(self, okf_idx: int) -> np.ndarray:
        """Shared-point counts between object-KF okf_idx and all others."""
        okf = self.keyframes[okf_idx]
        pts = okf.point_idx[okf.point_idx >= 0]
        if len(pts) == 0:
            return np.zeros(len(self.keyframes), np.int32)
        w = self.obs[pts, : len(self.keyframes)].sum(axis=0).astype(np.int32)
        w[okf_idx] = 0
        return w

    def covisible_keyframes(self, okf_idx: int, min_weight: int = 5,
                            max_n: Optional[int] = None) -> np.ndarray:
        w = self.covisibility_weights(okf_idx)
        ids = np.nonzero(w >= min_weight)[0]
        ids = ids[np.argsort(-w[ids])]
        return ids[:max_n] if max_n is not None else ids

    # ------------------------------------------------------------------
    def update_velocity(self, frame_a: int, frame_b: int, dt_frames: int = 1):
        """Finite-difference world-frame velocity between two frames
        (MapObject::UpdateVelocity analog, reference src/MapObject.cc:179-226)."""
        if frame_a not in self.poses_world or frame_b not in self.poses_world:
            return
        Ta = self.poses_world[frame_a]
        Tb = self.poses_world[frame_b]
        gap = max(frame_b - frame_a, 1)
        M = Tb @ np.linalg.inv(Ta)
        if gap > 1:
            # per-frame motion: M^(1/gap) via log/exp, in float32 on the host
            xi = se3.se3_log(torch.from_numpy(M.astype(np.float32))) / gap
            M = se3.se3_exp(xi).numpy()
        self.velocity_world = M.astype(np.float64)

    def predict_pose_cf(self, frame_id: int, T_cw: np.ndarray) -> Optional[np.ndarray]:
        """Constant-velocity camera-frame pose prediction
        (ObjectState::UsingVelocitySetPredictPos analog,
        reference src/g2o_Object.cc:58)."""
        if self.last_seen_frame < 0 or self.last_seen_frame not in self.poses_world:
            return None
        T_wo = self.poses_world[self.last_seen_frame]
        gap = frame_id - self.last_seen_frame
        if self.velocity_world is not None:
            V = np.linalg.matrix_power(self.velocity_world, max(gap, 1))
            T_wo = V @ T_wo
        return (T_cw @ T_wo).astype(np.float64)

    # ------------------------------------------------------------------
    def vote_dynamic(self, is_dynamic_now: bool, hysteresis: int = 4) -> None:
        """4-consecutive-consistent-votes flag flip
        (MapObject::DynamicDetection, reference src/MapObject.cc:414-448)."""
        if is_dynamic_now != self.dynamic:
            self.dyn_votes += 1
            if self.dyn_votes >= hysteresis:
                self.dynamic = is_dynamic_now
                self.dyn_votes = 0
        else:
            self.dyn_votes = 0

    def update_point_stats(self, pt_idx: np.ndarray):
        """Representative descriptor refresh from object-KF observations."""
        for p in np.atleast_1d(pt_idx):
            descs = []
            for i, okf in enumerate(self.keyframes):
                if not self.obs[p, i]:
                    continue
                f = np.nonzero(okf.point_idx == p)[0]
                if len(f):
                    descs.append(okf.desc[f[0]])
            if len(descs) > 1:
                D = np.stack(descs)
                bits = np.unpackbits(D.view(np.uint8), axis=1)
                ham = (bits[:, None, :] != bits[None, :, :]).sum(-1)
                self.pt_desc[p] = D[np.argmin(np.median(ham, axis=1))]
