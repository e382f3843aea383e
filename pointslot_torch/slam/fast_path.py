"""Device-resident camera tracking fast path.

Port of ``pointslot_tpu/slam/fast_path.py::DeviceTrackingPath``: the fused
per-frame step (``ops/fused_track.FusedTrackStep``: frontend + two
projection-match / pose-LM stages) inside the System. The local-map tables
live on the device and are refreshed at keyframe rate, the pose and
velocity chain device to device, and per frame the host copies only the
pose, the bindings, the levels and the depths, in one transfer. The full
feature arrays come to the host only when a keyframe needs them.

The host tracker (slam/tracking.py) keeps initialization, the LOST path
and every frame the fast path rejects, as the reference falls back from
TrackWithMotionModel to TrackReferenceKeyFrame (src/Tracking.cc:1148-1163).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointslot_torch import convert
from pointslot_torch.config import SystemConfig
from pointslot_torch.ops.fused_track import FusedTrackStep
from pointslot_torch.slam.tracking import FrameRecord, TrackingState
from pointslot_torch.utils.profiling import PROFILER

M_CAP = 2048


class DeviceTrackingPath:
    """Owns the fused step, the device map tables and the device pose/
    velocity chain. One instance per System; it shares the System's
    frontend and device."""

    def __init__(self, cfg: SystemConfig, frontend):
        self.cfg = cfg
        self.step = FusedTrackStep(cfg, frontend=frontend)
        self.device = self.step.device
        self.table_pts: Optional[np.ndarray] = None  # row -> map point id
        self._tables = None                          # device (pos, desc, lvl, valid)
        self._T_dev = None                           # chained device pose
        self._vel_dev = None
        self._last_res = None

    # ------------------------------------------------------------------
    def invalidate(self):
        self.table_pts = None
        self._tables = None
        self._T_dev = None
        self._vel_dev = None

    def refresh(self, m, ref_kf: int):
        """Rebuild the device local-map tables around ref_kf's covisibility
        neighborhood (keyframe-rate work, like the reference's local map
        update, src/Tracking.cc:3395)."""
        if ref_kf < 0 or not m.kf_valid[ref_kf]:
            self.invalidate()
            return
        kfs = list(m.covisible_keyframes(
            ref_kf, min_weight=1,
            max_n=self.cfg.tracking.max_local_keyframes,
        ))
        kfs.append(ref_kf)
        pts = m.points_of_keyframes(np.asarray(kfs, np.int64))
        if len(pts) == 0:
            self.invalidate()
            return
        if len(pts) > M_CAP:
            PROFILER.count("fast_path_table_truncated", len(pts) - M_CAP)
            pts = pts[:M_CAP]
        pos = np.zeros((M_CAP, 3), np.float32)
        desc = np.zeros((M_CAP, 8), np.uint32)
        lvl = np.zeros(M_CAP, np.int32)
        val = np.zeros(M_CAP, bool)
        pos[: len(pts)] = m.pt_pos[pts]
        desc[: len(pts)] = m.pt_desc[pts]
        Tcw = m.kf_pose[ref_kf]
        cam_center = -Tcw[:3, :3].T @ Tcw[:3, 3]
        dists = np.linalg.norm(m.pt_pos[pts] - cam_center, axis=1)
        lvl[: len(pts)] = m.predict_scale(dists, pts)
        val[: len(pts)] = True
        self.table_pts = pts
        # uint32 descriptor words become the port's int32 words
        self._tables = convert.map_tables(pos, desc, lvl, val, self.device)

    # ------------------------------------------------------------------
    def ready(self, tracker) -> bool:
        return (
            self._tables is not None
            and tracker.state == TrackingState.OK
            and tracker.velocity is not None
            and tracker.last_frame is not None
            and tracker.last_frame.T_cw is not None
        )

    def track(self, tracker, left, right, frame_id: int, gate=None):
        """One fused-step frame. Returns the (light) FrameRecord on
        success, or None to signal the caller to run the host tracker
        (full-feature fallback frame available via `fallback_frame`)."""
        m = tracker.map
        d = self.device
        T_prev = (self._T_dev if self._T_dev is not None
                  else convert.to_tensor(tracker.last_frame.T_cw, torch.float32, d))
        vel = (self._vel_dev if self._vel_dev is not None
               else convert.to_tensor(tracker.velocity, torch.float32, d))
        res = self.step(left, right, T_prev, vel, *self._tables, gate=gate)
        self._last_res = res
        # ONE device->host transfer for everything the light frame needs
        pf, level, depth, valid, T_cw, velocity, n_inl = convert.host(
            res.point_for_feature, res.level, res.depth, res.valid,
            res.T_cw, res.velocity, res.n_inliers,
        )
        n_inl = int(n_inl)
        if n_inl < self.cfg.tracking.min_inliers_local_map:
            # reject: host tracker re-runs this frame from the same features
            self._T_dev = None
            self._vel_dev = None
            PROFILER.count("fast_path_rejected")
            return None
        # accept: light host copy — pose, bindings, depth; features stay
        # on the device until a keyframe needs them
        frame = FrameRecord(
            frame_id=frame_id,
            xy=None, desc=None, angle=None,
            # level ships with the light frame: the host motion-model
            # fallback reads last_frame.level (tracking.py)
            level=level,
            depth=depth,
            u_right=None,
            valid=valid,
            point_idx=np.where(pf >= 0, self.table_pts[
                np.clip(pf, 0, len(self.table_pts) - 1)
            ], -1),
            T_cw=T_cw,
        )
        self._T_dev = res.T_cw
        self._vel_dev = res.velocity

        # map bookkeeping the host tracker does per frame: visibility for
        # every projected table point, found for the bound ones, ref-KF
        # re-election by observation votes
        m.pt_visible[self.table_pts] += 1
        bound = frame.point_idx[frame.point_idx >= 0]
        m.pt_found[bound] += 1
        if len(bound):
            votes = m.obs[bound].sum(axis=0)
            votes[~m.kf_valid] = 0
            best = int(np.argmax(votes))
            if votes[best] > 0:
                tracker.ref_kf = best
        tracker.n_matches_inliers = n_inl
        tracker.velocity = velocity
        PROFILER.count("frames_tracked_fast")
        PROFILER.count("inliers_total", n_inl)
        return frame

    def materialize(self, frame: FrameRecord) -> FrameRecord:
        """Copy the full feature arrays of the last fused step into `frame`
        (keyframe creation needs them), in one transfer."""
        res = self._last_res
        frame.xy, frame.level, desc, frame.angle, frame.u_right = convert.host(
            res.xy, res.level, res.desc, res.angle, res.u_right)
        frame.desc = desc.view(np.uint32)
        return frame

    def fallback_frame(self, frame_id: int) -> FrameRecord:
        """Full FrameRecord from the last fused step's features, with no
        bindings — the host tracker's input when the fast path rejects."""
        return convert.frame_record(self._last_res, frame_id)
