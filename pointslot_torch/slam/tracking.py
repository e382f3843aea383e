"""Camera tracking state machine (host orchestration over device solvers).

Port of ``pointslot_tpu/slam/tracking.py``: ``TrackingState``,
``FrameRecord``, ``TrajectoryEntry`` and ``CameraTracker`` (the reference's
StereoInitialization, TrackWithMotionModel, TrackReferenceKeyFrame,
TrackLocalMap, NeedNewKeyFrame and CreateNewKeyFrame, src/Tracking.cc).

Control flow (keyframe policy, fallbacks, state transitions) is host
Python over the numpy tables of MapState, as in the reference; projection
matching, descriptor matching and the pose solves run on the tracker's
device and come back in one transfer each. The reference pads the point
count to a power of two only to bound XLA recompiles; padded rows match
nothing, so the port passes the real count. The pose solve keeps the
reference's cap of 1500 edges, which decides which edges are solved.
A LOST frame goes to ``relocalizer`` (slam/loop_closing.py's
Relocalizer, set by the System when loop closing is on); without one, or
when it fails on a small map, the tracker takes the reset path, as the
reference does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from pointslot_torch.config import SystemConfig
from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.slam import matchers
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.solvers import pose_opt
from pointslot_torch.utils.profiling import PROFILER

POSE_EDGE_CAP = 1500


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class FrameRecord:
    """Host copy of one frame's features + tracking results."""

    frame_id: int
    xy: np.ndarray
    level: np.ndarray
    desc: np.ndarray           # (N, 8) uint32
    angle: np.ndarray
    depth: np.ndarray
    u_right: np.ndarray
    valid: np.ndarray
    point_idx: np.ndarray      # (N,) bound map point per feature (-1)
    T_cw: np.ndarray = None    # (4, 4)


@dataclass
class TrajectoryEntry:
    frame_id: int
    ref_kf: int
    ref_uid: int               # uid of the ref KF (slots recycle; uid doesn't)
    T_rel: np.ndarray          # T_cw_frame @ inv(T_cw_refkf)
    lost: bool = False


class CameraTracker:
    def __init__(self, config: SystemConfig, map_state: Optional[MapState] = None,
                 device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.map = map_state or MapState()
        self.state = TrackingState.NOT_INITIALIZED
        self.last_frame: Optional[FrameRecord] = None
        self.velocity: Optional[np.ndarray] = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -10 ** 9
        self.trajectory: List[TrajectoryEntry] = []
        self.n_matches_inliers = 0
        cam = config.camera
        scales = np.asarray(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)], np.float32)
        self._inv_sigma2 = 1.0 / scales ** 2
        self._scales = torch.from_numpy(scales).to(self.device)
        self._proj = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                          cy=float(cam.cy), width=cam.width, height=cam.height)
        self._cam = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                         cy=float(cam.cy), bf=float(cam.bf))
        self._feats = (None, None)   # (frame, its features on the device)
        self.new_kf_callback = None  # set by System to trigger local mapping
        self.relocalizer = None      # set by System (LOST recovery)
        self.reset_callback = None   # set by System (full map reset)
        self.n_lost_frames = 0

    # ------------------------------------------------------------------
    def track(self, frame: FrameRecord) -> FrameRecord:
        """Main per-frame entry (camera half of Tracking::Track)."""
        if self.state == TrackingState.NOT_INITIALIZED:
            self._stereo_initialization(frame)
        else:
            if self.state == TrackingState.LOST:
                # full reset when lost with a small map or no relocalizer
                # (src/Tracking.cc:1308)
                ok = bool(self.relocalizer and self.relocalizer.relocalize(frame))
                if not ok and (
                    self.map.n_keyframes() <= self.cfg.tracking.reset_max_kfs_when_lost
                    or self.relocalizer is None
                ) and self.n_lost_frames > 3:
                    if self.reset_callback:
                        self.reset_callback()
                        return frame
            elif self.velocity is None:
                # no velocity estimate yet -> window-free reference-KF tracking
                ok = self._track_reference_keyframe(frame)
                if not ok:
                    ok = self._track_with_motion_model(frame)
            else:
                ok = self._track_with_motion_model(frame)
                if not ok:
                    ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            if ok:
                was_lost = self.state == TrackingState.LOST
                self.state = TrackingState.OK
                self.n_lost_frames = 0
                if (
                    not was_lost
                    and self.last_frame is not None
                    and self.last_frame.T_cw is not None
                ):
                    self.velocity = frame.T_cw @ np.linalg.inv(self.last_frame.T_cw)
                if self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
            else:
                self.state = TrackingState.LOST
                self.n_lost_frames += 1
                frame.T_cw = (
                    self.last_frame.T_cw.copy()
                    if self.last_frame is not None
                    else np.eye(4, dtype=np.float32)
                )
                self.velocity = None

        self.commit_frame(frame)
        return frame

    def commit_frame(self, frame: FrameRecord):
        """Shared per-frame tail: relative-pose trajectory log + last-frame
        hand-off (also used by the device-resident fast path)."""
        if frame.T_cw is not None and self.ref_kf >= 0:
            T_ref = self.map.kf_pose[self.ref_kf]
            self.trajectory.append(
                TrajectoryEntry(
                    frame_id=frame.frame_id,
                    ref_kf=self.ref_kf,
                    ref_uid=int(self.map.kf_uid[self.ref_kf]),
                    T_rel=frame.T_cw @ np.linalg.inv(T_ref),
                    lost=self.state == TrackingState.LOST,
                )
            )
        self.last_frame = frame

    # ------------------------------------------------------------------
    def on_keyframe_removed(self, kf: int):
        """Re-parent trajectory entries referencing a culled keyframe onto
        its strongest covisible neighbor (src/System.cc:380-388)."""
        uid = int(self.map.kf_uid[kf])
        affected = [e for e in self.trajectory if e.ref_uid == uid]
        if not affected:
            return
        neighbors = self.map.covisible_keyframes(kf, min_weight=1, max_n=1)
        if len(neighbors) == 0:
            valid = self.map.keyframe_ids()
            valid = valid[valid != kf]
            if len(valid) == 0:
                return
            neighbors = [valid[0]]
        parent = int(neighbors[0])
        T_kf = self.map.kf_pose[kf]
        T_parent = self.map.kf_pose[parent]
        T_bridge = T_kf @ np.linalg.inv(T_parent)
        for e in affected:
            e.T_rel = e.T_rel @ T_bridge
            e.ref_kf = parent
            e.ref_uid = int(self.map.kf_uid[parent])

    # ------------------------------------------------------------------
    def reset(self):
        """Full tracking reset: map cleared, state machine back to init
        (reference Tracking::Reset src/Tracking.cc:3665)."""
        self.map.reset()
        self.state = TrackingState.NOT_INITIALIZED
        self.last_frame = None
        self.velocity = None
        self.ref_kf = -1
        self.last_kf_frame_id = -10 ** 9
        self.n_lost_frames = 0

    # ------------------------------------------------------------------
    def _stereo_initialization(self, frame: FrameRecord):
        n_stereo = int(((frame.depth > 0) & frame.valid).sum())
        if n_stereo < self.cfg.tracking.min_init_stereo_features:
            return
        frame.T_cw = np.eye(4, dtype=np.float32)
        kf = self._store_keyframe(frame)
        # create map points from every stereo feature
        fidx = np.nonzero((frame.depth > 0) & frame.valid)[0]
        self._create_points_from_stereo(frame, kf, fidx)
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        if self.new_kf_callback:
            self.new_kf_callback(kf)

    # ------------------------------------------------------------------
    def _frame_features(self, frame: FrameRecord):
        """(xy, level, desc, valid) of the frame on the device, uploaded
        once per frame."""
        if self._feats[0] is not frame:
            d = self.device
            self._feats = (frame, (
                to_tensor(frame.xy, torch.float32, d), to_tensor(frame.level, torch.int32, d),
                to_tensor(frame.desc, torch.int32, d), to_tensor(frame.valid, torch.bool, d)))
        return self._feats[1]

    def _bound_points_of_last_frame(self):
        lf = self.last_frame
        sel = np.nonzero((lf.point_idx >= 0))[0]
        pts = lf.point_idx[sel]
        ok = self.map.pt_valid[pts]
        return sel[ok], pts[ok]

    def _match_and_optimize(
        self, frame: FrameRecord, pt_idx: np.ndarray, T_init: np.ndarray,
        radius: float, pred_level: np.ndarray, th_desc: int,
        keep_existing: bool = False, level_window: int = 2,
    ) -> int:
        """Project the given map points into the frame, associate, solve pose.
        Returns inlier count; writes frame.T_cw and frame.point_idx."""
        m = self.map
        if len(pt_idx) < 10:
            return 0
        d = self.device
        res = matchers.project_and_match(
            to_tensor(m.pt_pos[pt_idx].astype(np.float32), None, d)[None],
            to_tensor(m.pt_desc[pt_idx], torch.int32, d)[None],
            to_tensor(m.pt_valid[pt_idx], None, d)[None],
            to_tensor(np.asarray(T_init, np.float32), None, d)[None],
            *self._frame_features(frame), radius, self._scales,
            to_tensor(pred_level.astype(np.int32), None, d)[None],
            th_desc=th_desc, level_window=level_window, **self._proj,
        )
        pf, = host(res.point_for_feature[0])
        matched_feats = np.nonzero(pf >= 0)[0]
        bind = np.full(len(frame.xy), -1, np.int64)
        bind[matched_feats] = pt_idx[pf[matched_feats]]
        if keep_existing:
            existing = frame.point_idx >= 0
            bind[existing] = frame.point_idx[existing]
        frame.point_idx = bind
        return self._optimize_pose(frame, T_init)

    def _optimize_pose(self, frame: FrameRecord, T_init: np.ndarray) -> int:
        """Motion-only pose solve over the frame's current point bindings;
        unbinds outliers. Returns inlier count."""
        m = self.map
        bind = frame.point_idx
        fsel = np.nonzero(bind >= 0)[0]
        if len(fsel) < 10:
            return 0
        if len(fsel) > POSE_EDGE_CAP:
            PROFILER.count("pose_opt_edges_dropped", len(fsel) - POSE_EDGE_CAP)
            fsel = fsel[:POSE_EDGE_CAP]
        obs = np.stack(
            [frame.xy[fsel, 0], frame.xy[fsel, 1], frame.u_right[fsel]], axis=1
        ).astype(np.float32)
        edges = dict(
            pts=m.pt_pos[bind[fsel]].astype(np.float32), obs=obs,
            is_stereo=frame.depth[fsel] > 0,
            inv_sigma2=self._inv_sigma2[frame.level[fsel]],
            valid=np.ones(len(fsel), bool),
        )
        d = self.device
        result = pose_opt.pose_optimize(
            to_tensor(np.asarray(T_init, np.float32), None, d)[None],
            **{k: to_tensor(v, None, d)[None] for k, v in edges.items()}, **self._cam,
        )
        T_cw, inl = host(result.T[0], result.inliers[0])
        frame.T_cw = T_cw
        bind[fsel[~inl]] = -1
        frame.point_idx = bind
        return int(inl.sum())

    def _track_with_motion_model(self, frame: FrameRecord) -> bool:
        if self.last_frame is None or self.last_frame.T_cw is None:
            return False
        T_pred = (
            self.velocity @ self.last_frame.T_cw
            if self.velocity is not None
            else self.last_frame.T_cw
        ).astype(np.float32)
        fsel, pts = self._bound_points_of_last_frame()
        if len(pts) < 20:
            return False
        pred_level = self.last_frame.level[fsel]
        n = self._match_and_optimize(
            frame, pts, T_pred, radius=7.0, pred_level=pred_level,
            th_desc=matchers.TH_HIGH,
        )
        if n < self.cfg.tracking.min_matches_motion_model:
            # widen the window once (reference retries with 2x radius)
            frame.point_idx = np.full(len(frame.xy), -1, np.int64)
            n = self._match_and_optimize(
                frame, pts, T_pred, radius=14.0, pred_level=pred_level,
                th_desc=matchers.TH_HIGH,
            )
        self.n_matches_inliers = n
        return n >= self.cfg.tracking.min_matches_motion_model

    def _track_reference_keyframe(self, frame: FrameRecord) -> bool:
        if self.ref_kf < 0:
            return False
        m = self.map
        kf = self.ref_kf
        d = self.device
        _, _, desc, valid = self._frame_features(frame)
        res = matchers.brute_match(
            desc, to_tensor(frame.angle, torch.float32, d), valid,
            to_tensor(m.kf_desc[kf], torch.int32, d), to_tensor(m.kf_angle[kf], None, d),
            to_tensor(m.kf_feat_valid[kf] & (m.kf_point_idx[kf] >= 0), None, d),
            nn_ratio=0.7, th_desc=matchers.TH_LOW, check_rotation=True,
        )
        idx_b, = host(res.idx_b_for_a)
        matched = np.nonzero(idx_b >= 0)[0]
        if len(matched) < self.cfg.tracking.min_matches_ref_kf:
            return False
        bind = np.full(len(frame.xy), -1, np.int64)
        bind[matched] = m.kf_point_idx[kf, idx_b[matched]]
        frame.point_idx = bind
        T_init = (
            self.last_frame.T_cw
            if self.last_frame is not None and self.last_frame.T_cw is not None
            else m.kf_pose[kf]
        ).astype(np.float32)
        n = self._optimize_pose(frame, T_init)
        self.n_matches_inliers = n
        return n >= self.cfg.tracking.min_matches_ref_kf

    def _track_local_map(self, frame: FrameRecord) -> bool:
        m = self.map
        # local keyframes: those observing currently-bound points (+covisible)
        bound = frame.point_idx[frame.point_idx >= 0]
        if len(bound) == 0:
            return False
        votes = m.obs[bound].sum(axis=0)
        votes[~m.kf_valid] = 0
        local_kfs = np.nonzero(votes > 0)[0]
        order = np.argsort(-votes[local_kfs])
        local_kfs = local_kfs[order][: self.cfg.tracking.max_local_keyframes]
        self.ref_kf = int(local_kfs[0]) if len(local_kfs) else self.ref_kf

        local_pts = m.points_of_keyframes(local_kfs)
        # exclude already-bound
        local_pts = local_pts[~np.isin(local_pts, bound)]
        if len(local_pts) > 0:
            # predicted octave from distance
            Tcw = frame.T_cw
            cam_center = -Tcw[:3, :3].T @ Tcw[:3, 3]
            dists = np.linalg.norm(m.pt_pos[local_pts] - cam_center, axis=1)
            pred_level = m.predict_scale(dists, local_pts)
            m.pt_visible[local_pts] += 1  # frustum check happens on the device
            n = self._match_and_optimize(
                frame, local_pts, frame.T_cw, radius=4.0, pred_level=pred_level,
                th_desc=matchers.TH_HIGH, keep_existing=True,
            )
        else:
            n = self.n_matches_inliers
        found = frame.point_idx[frame.point_idx >= 0]
        m.pt_found[found] += 1
        # visible was already counted for the projected local points; only
        # add it for points bound in the earlier motion-model stage
        not_counted = found[~np.isin(found, local_pts)]
        m.pt_visible[not_counted] += 1
        self.n_matches_inliers = n
        PROFILER.count("frames_tracked")
        PROFILER.count("inliers_total", n)
        return n >= self.cfg.tracking.min_inliers_local_map

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: FrameRecord) -> bool:
        cfg = self.cfg.tracking
        m = self.map
        if self.ref_kf < 0:
            return False
        frames_since = frame.frame_id - self.last_kf_frame_id
        close = (frame.depth > 0) & (frame.depth < self.cfg.camera.depth_threshold)
        tracked_close = int((close & (frame.point_idx >= 0)).sum())
        nontracked_close = int((close & (frame.point_idx < 0)).sum())
        need_close = (tracked_close < cfg.min_tracked_close) and (
            nontracked_close > cfg.max_nontracked_close
        )
        # only ref-KF points with >= nMinObs observations count
        # (KeyFrame::TrackedMapPoints(3), src/Tracking.cc:3156)
        n_min_obs = 3 if m.n_keyframes() > 2 else 2
        ref_bound = m.kf_point_idx[self.ref_kf]
        ref_pts = ref_bound[ref_bound >= 0]
        obs_count = m.obs[ref_pts].sum(axis=1)
        ref_matches = int((obs_count >= n_min_obs).sum())
        ratio = cfg.kf_ref_ratio_many_close if need_close else cfg.kf_ref_ratio
        c1 = frames_since >= cfg.max_frames_between_kf
        c2 = need_close
        c3 = self.n_matches_inliers < ref_matches * ratio or need_close
        ok_matches = self.n_matches_inliers > 15
        return ok_matches and (c1 or c2 or (c3 and frames_since >= cfg.min_frames_between_kf))

    def _store_keyframe(self, frame: FrameRecord) -> int:
        m = self.map
        kf = m.alloc_keyframe()
        N = min(len(frame.xy), m.feats_per_kf)
        m.kf_pose[kf] = frame.T_cw
        m.kf_frame_id[kf] = frame.frame_id
        # spanning-tree parent = the tracking reference at creation
        m.kf_parent[kf] = self.ref_kf if self.ref_kf != kf else -1
        m.kf_xy[kf, :N] = frame.xy[:N]
        m.kf_level[kf, :N] = frame.level[:N]
        m.kf_desc[kf, :N] = frame.desc[:N]
        m.kf_angle[kf, :N] = frame.angle[:N]
        m.kf_depth[kf, :N] = frame.depth[:N]
        m.kf_uright[kf, :N] = frame.u_right[:N]
        m.kf_feat_valid[kf, :N] = frame.valid[:N]
        m.kf_point_idx[kf, :] = -1
        bound = np.nonzero(frame.point_idx[:N] >= 0)[0]
        if len(bound):
            m.bind(kf, bound, frame.point_idx[bound])
        return kf

    def _create_points_from_stereo(self, frame: FrameRecord, kf: int, fidx: np.ndarray):
        """UnprojectStereo for the selected features and register new points."""
        m = self.map
        cam = self.cfg.camera
        if len(fidx) == 0:
            return np.array([], np.int64)
        T_wc = np.linalg.inv(frame.T_cw)
        pts = m.alloc_points(len(fidx))
        fidx = fidx[: len(pts)]  # table may be near capacity
        if len(fidx) == 0:
            return pts
        z = frame.depth[fidx]
        x = (frame.xy[fidx, 0] - cam.cx) * z / cam.fx
        y = (frame.xy[fidx, 1] - cam.cy) * z / cam.fy
        pc = np.stack([x, y, z], axis=1)
        pw = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
        m.pt_pos[pts] = pw
        m.pt_desc[pts] = frame.desc[fidx]
        m.pt_first_kf[pts] = kf
        m.pt_found[pts] = 1
        m.pt_visible[pts] = 1
        cam_center = T_wc[:3, 3]
        d = pw - cam_center
        dn = np.linalg.norm(d, axis=1, keepdims=True)
        m.pt_normal[pts] = d / np.maximum(dn, 1e-9)
        scale = self.cfg.orb.scale_factor ** frame.level[fidx]
        m.pt_max_dist[pts] = dn[:, 0] * scale
        m.pt_min_dist[pts] = m.pt_max_dist[pts] / (
            self.cfg.orb.scale_factor ** (self.cfg.orb.n_levels - 1)
        )
        m.bind(kf, fidx, pts)
        frame.point_idx[fidx] = pts
        return pts

    def _create_keyframe(self, frame: FrameRecord):
        kf = self._store_keyframe(frame)
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        # create close points for unbound stereo features (all closer than
        # th_depth, or the 100 closest, src/Tracking.cc:3227)
        close_unbound = np.nonzero(
            frame.valid & (frame.depth > 0) & (frame.point_idx < 0)
        )[0]
        if len(close_unbound):
            order = np.argsort(frame.depth[close_unbound])
            depth_sorted = close_unbound[order]
            keep = frame.depth[depth_sorted] < self.cfg.camera.depth_threshold
            n_keep = max(int(keep.sum()), min(100, len(depth_sorted)))
            sel = depth_sorted[:n_keep]
            self._create_points_from_stereo(frame, kf, sel)
        if self.new_kf_callback:
            self.new_kf_callback(kf)
            # mapping may have refined this keyframe's pose; the frame IS
            # the keyframe, so adopt it
            frame.T_cw = self.map.kf_pose[kf].copy()

    # ------------------------------------------------------------------
    def camera_trajectory(self):
        """Per-frame poses from the final (BA-refined) keyframe poses."""
        out = []
        for entry in self.trajectory:
            T_ref = self.map.kf_pose[entry.ref_kf]
            out.append((entry.frame_id, entry.T_rel @ T_ref, entry.lost))
        return out
