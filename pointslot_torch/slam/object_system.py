"""Per-frame object-SLOT pipeline of SLOT mode 4 (offline detections).

Port of ``pointslot_tpu/slam/object_system.py``: the object half of the
reference's Tracking thread plus its ObjectLocalMapping thread.

- object feature extraction: a second stereo frontend (the gaussian BRIEF
  table by default) gated to the union of the detections' instance masks,
  with the right image gated to the mask dilated over the disparity range;
- init and re-init of a track (InitializeCurrentObjPose with
  ``fine_tune_with_bbox``, MapObjectInit / MapObjectReInit);
- batched object tracking: for every live object of the frame at once, a
  brute descriptor match, a projection match through the velocity
  prediction, the pose LM with the detection's translation prior, a second
  projection match and LM (the reference's TrackLastFrameObjectPoint and
  TrackObjectLocalMap, src/Tracking.cc:2288-2712);
- dynamic/static discrimination with hysteresis (:2058-2202);
- object mapping: point and keyframe culling, neighbour fuse, the windowed
  object BA (roll and pitch frozen by the dof mask) with optional motion
  priors, and the write-back; ``process_object_tasks`` solves the queued
  objects' BAs in one ``bundle_adjust_batched`` call;
- ``export_detections`` for the KITTI saver.

Host logic is the reference's numpy code. The device work (the frontend,
the matches, the LMs, ``fine_tune_with_bbox``, the BA) runs on the
System's device, the object axis written out as a leading batch axis where
the reference uses ``jax.vmap``; its results reach the host in one transfer
per stage. The reference pads the object axis to a power of two only to
bound recompiles; lanes are independent, so the port passes the real count.

Two options of the reference's object tracking: ``objects.use_offline_flow``
(a ``flow`` map of the previous frame warps each point's last observation,
and ``guided_match`` over every object at once takes over an object's
bindings when it finds 5 pairs or more) and ``objects.use_gms`` (the
rotation histogram off, then ``gms_filter`` drops the bindings whose cell
pairs the grid statistics do not support, every object filtered in one
batched call with one transfer).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from pointslot_torch.config import SystemConfig
from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops.frontend import StereoFrontend, dilate_mask_left
from pointslot_torch.ops.gms import gms_filter
from pointslot_torch.slam import matchers
from pointslot_torch.slam.objects import Detection, ObjectKeyFrameRec, ObjectTrack
from pointslot_torch.solvers import local_ba, pose_opt
from pointslot_torch.solvers.object_factors import fine_tune_with_bbox
from pointslot_torch.utils.profiling import PROFILER

EDGE_CAP = 512
F_CAP = 512  # per-detection feature capacity (static shape for the kernels)
TRANS_PRIOR_WEIGHT = 50.0   # the reference's EdgeTransConstraintFromDetction info


def _rotation_y_matrix(ry: float) -> np.ndarray:
    """Rotation about the camera y-axis (vehicle heading in KITTI)."""
    c, s = np.cos(ry), np.sin(ry)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def heading_y(R: np.ndarray) -> float:
    return float(np.arctan2(R[0, 2], R[2, 2]))


def _pose_bucket(n: int, cap: int) -> int:
    """Next power-of-two pose capacity (>=16) for a window of n poses."""
    b = 16
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


@dataclass
class ObjectFrameFeatures:
    """Object-region features of the current frame, with detection labels."""

    xy: np.ndarray
    level: np.ndarray
    desc: np.ndarray         # (N, 8) uint32
    angle: np.ndarray
    depth: np.ndarray
    u_right: np.ndarray
    valid: np.ndarray
    det_index: np.ndarray    # (N,) index into the frame's detection list, -1 none


class ObjectSystem:
    def __init__(self, config: SystemConfig, system=None, device="cuda"):
        """`system`: the owning System, whose device, frontend and mapping
        queue the object pipeline shares; without one it runs on `device`
        with its own frontend and maps synchronously."""
        self.cfg = config
        self.system = system
        self.device = system.device if system is not None else resolve_device(device)
        self.tracks: Dict[int, ObjectTrack] = {}
        self.all_tracks: List[ObjectTrack] = []
        # object-map concurrency (the reference's ObjectLocalMapping thread
        # owns its queue + per-object gate, src/ObjectLocalMapping.cpp:32-55):
        # track tables are guarded by _obj_lock; the BA solve runs outside
        # the lock on the mapping worker so tracking never stalls on it
        self._obj_lock = threading.RLock()
        self._pending_okfs: Dict[int, int] = {}
        self.ba_threads: set = set()  # thread idents that ran an object BA
        cam = config.camera
        self._cam_args = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                              cy=float(cam.cy), bf=float(cam.bf))
        self._cam_args_nobf = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                                   cy=float(cam.cy))
        self._proj = dict(self._cam_args_nobf, width=cam.width, height=cam.height)
        self._scales = np.asarray(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)], np.float32)
        self._scales_dev = torch.from_numpy(self._scales).to(self.device)
        self.ba_calls = 0
        # the object feature engine (the reference's second extractor, dense
        # ORB on object masks, src/Frame.cc:2623-2665): shares the camera
        # frontend unless the object BRIEF pattern differs
        self._frontend = system.frontend if system is not None else None
        if self._frontend is None or config.objects.brief_pattern != config.orb.brief_pattern:
            orb = config.orb.__class__(**{**config.orb.__dict__,
                                          "brief_pattern": config.objects.brief_pattern})
            self._frontend = StereoFrontend(cam.height, cam.width, cam.fx, cam.bf, orb,
                                            device=self.device)

    # ------------------------------------------------------------------
    def process_frame(self, frame, left, right, detections, instance_mask,
                      timestamp, flow=None):
        """One frame's object work after camera tracking: extraction, then
        tracking of the live objects, re-init of the lost ones and init of
        the new ones. `flow`: the (H, W, 2) forward optical flow of the
        previous frame (pixel displacement last -> current, Virtual KITTI's
        offline maps); it switches point tracking to the flow-guided
        matcher (the reference's SearchByOfflineOpticalFlowTracking)."""
        if not detections:
            return
        dets = [d for d in detections if d.track_id >= 0]
        if self.cfg.objects.select_tracked_obj_id >= 0:
            dets = [d for d in dets
                    if d.track_id == self.cfg.objects.select_tracked_obj_id]
        if not dets or instance_mask is None:
            return

        with PROFILER.timer("obj_extract"):
            feats = self._extract_object_features(left, right, instance_mask, dets)
        T_cw = frame.T_cw.astype(np.float64)

        with self._obj_lock:
            to_init, to_track = [], []
            for di, det in enumerate(dets):
                fsel = np.nonzero(feats.det_index == di)[0]
                track = self.tracks.get(det.track_id)
                if track is None or track.n_points() == 0:
                    to_init.append((det, fsel))
                else:
                    to_track.append((det, fsel, track))

            with PROFILER.timer("obj_track"):
                failed = self._track_objects_batched(to_track, feats, T_cw, timestamp,
                                                     flow=flow)
            for det, fsel, track in failed:
                missing_t = timestamp - track.last_seen_time
                if missing_t > self.cfg.objects.max_missing_dt:
                    # re-init the object from scratch (MapObjectReInit)
                    self._reinit(track, det, feats, fsel, T_cw, timestamp)
            with PROFILER.timer("obj_init"):
                for det, fsel in to_init:
                    self._try_init(det, feats, fsel, T_cw, timestamp)

    # ------------------------------------------------------------------
    def _extract_object_features(self, left, right, instance_mask, dets):
        gate = instance_mask > 0
        gate_r = dilate_mask_left(gate, max_disparity=128)
        sf = self._frontend(left, right, gate=gate, gate_right=gate_r)
        # one transfer for the whole feature set
        xy, level, desc, angle, depth, u_right, valid = host(
            sf.xy, sf.level, sf.desc, sf.angle, sf.depth, sf.u_right, sf.valid)
        H, W = instance_mask.shape
        xi = np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)
        yi = np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1)
        mask_vals = instance_mask[yi, xi]
        det_index = np.full(len(xy), -1, np.int32)
        for di, det in enumerate(dets):
            det_index[(mask_vals == det.mask_value) & valid] = di
        return ObjectFrameFeatures(xy=xy, level=level, desc=desc.view(np.uint32), angle=angle,
                                   depth=depth, u_right=u_right, valid=valid,
                                   det_index=det_index)

    # ------------------------------------------------------------------
    def _init_pose_from_detection(self, det: Detection, feats, fsel) -> Optional[np.ndarray]:
        """InitializeCurrentObjPose: rotation from detection yaw; translation
        from the trimmed centroid of stereo points (reference
        src/Tracking.cc:1640-1703) or the detection location."""
        R = _rotation_y_matrix(det.rotation_y)
        if self.cfg.objects.set_init_position_by_points:
            stereo = fsel[feats.depth[fsel] > 0]
            if len(stereo) >= 3:
                z = feats.depth[stereo]
                cam = self.cfg.camera
                x = (feats.xy[stereo, 0] - cam.cx) * z / cam.fx
                y = (feats.xy[stereo, 1] - cam.cy) * z / cam.fy
                pc = np.stack([x, y, z], axis=1)
                # trimmed centroid: drop depth outliers beyond 1 sigma-ish
                med = np.median(pc, axis=0)
                d = np.linalg.norm(pc - med, axis=1)
                keep = d < max(np.median(d) * 2.5, 1.0)
                t = pc[keep].mean(axis=0) if keep.sum() >= 3 else med
            else:
                t = det.location_cam
        else:
            t = det.location_cam
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        if self.cfg.objects.set_init_position_by_points:
            # refine the centroid init against the detected 2D box
            # (Tracking::FineTuningUsing2dBox, src/Tracking.cc:1704-1786)
            d = self.device
            T = fine_tune_with_bbox(
                to_tensor(T, torch.float32, d),
                to_tensor(det.dims[::-1].copy(), torch.float32, d),  # (l,h,w) -> xyz extents
                to_tensor(det.bbox, torch.float32, d),
                **self._cam_args_nobf,
            ).cpu().numpy().astype(np.float64)
        return T

    def _point_max_dist(self, det: Detection) -> float:
        if self.cfg.objects.manual_point_max_distance:
            return self.cfg.objects.in_obj_frame_point_max_distance
        return float(np.linalg.norm(np.asarray(det.dims) / 2.0))

    def _unproject(self, feats, fsel):
        cam = self.cfg.camera
        z = feats.depth[fsel]
        x = (feats.xy[fsel, 0] - cam.cx) * z / cam.fx
        y = (feats.xy[fsel, 1] - cam.cy) * z / cam.fy
        return np.stack([x, y, z], axis=1)

    # ------------------------------------------------------------------
    def _try_init(self, det, feats, fsel, T_cw, timestamp):
        stereo = fsel[(feats.depth[fsel] > 0)]
        if len(stereo) < self.cfg.objects.init_min_features:
            return
        T_co = self._init_pose_from_detection(det, feats, fsel)
        track = self.tracks.get(det.track_id)
        if track is None:
            track = ObjectTrack(
                track_id=det.track_id,
                dims=np.asarray(det.dims, np.float64),
                max_points=self.cfg.objects.max_object_points,
            )
            self.tracks[det.track_id] = track
            self.all_tracks.append(track)
        self._add_keyframe_with_points(track, det, feats, fsel, T_co, T_cw, timestamp)
        if track.n_points() >= self.cfg.objects.init_min_map_points:
            track.track_ok = True
        self._record_state(track, det, T_co, T_cw, timestamp)

    def _reinit(self, track, det, feats, fsel, T_cw, timestamp):
        track.epoch += 1
        track.pt_valid[:] = False
        track.obs[:, :] = False
        track.keyframes.clear()
        track.velocity_world = None
        self._try_init(det, feats, fsel, T_cw, timestamp)

    # ------------------------------------------------------------------
    def _add_keyframe_with_points(self, track, det, feats, fsel, T_co, T_cw,
                                  timestamp, bind: Optional[np.ndarray] = None):
        """Create an ObjectKeyFrame; spawn object points from unbound stereo
        features within the scale bound."""
        okf_idx = len(track.keyframes)
        if okf_idx >= track.MAX_OKF:
            return None
        F = len(fsel)
        point_idx = np.full(F, -1, np.int64) if bind is None else bind.copy()
        okf = ObjectKeyFrameRec(
            obj_kf_id=okf_idx,
            frame_id=det.frame_id,
            T_co=np.asarray(T_co, np.float64),
            T_cw=np.asarray(T_cw, np.float64),
            xy=feats.xy[fsel].copy(),
            level=feats.level[fsel].copy(),
            desc=feats.desc[fsel].copy(),
            angle=feats.angle[fsel].copy(),
            depth=feats.depth[fsel].copy(),
            u_right=feats.u_right[fsel].copy(),
            point_idx=point_idx,
            bbox=np.asarray(det.bbox, np.float64),
        )
        # bind existing points' observations
        bound = np.nonzero(point_idx >= 0)[0]
        if len(bound):
            track.obs[point_idx[bound], okf_idx] = True
        # spawn new points from unbound stereo features
        T_oc = np.linalg.inv(okf.T_co)
        new_sel = np.nonzero((point_idx < 0) & (okf.depth > 0))[0]
        if len(new_sel):
            pc = self._unproject_local(okf, new_sel)
            po = pc @ T_oc[:3, :3].T + T_oc[:3, 3]
            in_bound = np.linalg.norm(po, axis=1) <= self._point_max_dist(det)
            new_sel = new_sel[in_bound]
            po = po[in_bound]
            n_free = int((~track.pt_valid).sum())
            if len(new_sel) > n_free:
                new_sel, po = new_sel[:n_free], po[:n_free]
            if len(new_sel):
                rows = track.alloc_points(len(new_sel))
                track.pt_pos[rows] = po
                track.pt_desc[rows] = okf.desc[new_sel]
                track.pt_first_okf[rows] = okf_idx
                track.pt_found[rows] = 1
                track.pt_visible[rows] = 1
                track.pt_last_xy[rows] = okf.xy[new_sel]
                track.pt_last_angle[rows] = okf.angle[new_sel]
                track.pt_last_frame[rows] = okf.frame_id
                okf.point_idx[new_sel] = rows
                track.obs[rows, okf_idx] = True
        track.keyframes.append(okf)
        self._schedule_object_mapping(track, det)
        return okf

    def _schedule_object_mapping(self, track: ObjectTrack, det: Detection):
        """Hand the new object keyframe to the mapping worker when the
        async pipeline is on (reference ObjectLocalMapping::
        InsertOneObjKeyFrame, src/ObjectLocalMapping.cpp:55); inline
        otherwise."""
        sys_ = self.system
        if sys_ is not None and getattr(sys_, "_mapping_thread", None) is not None:
            self._pending_okfs[track.track_id] = (
                self._pending_okfs.get(track.track_id, 0) + 1
            )
            sys_._mapping_queue.put(("object", track.track_id, det))
        else:
            self._map_objects([(track, det)])

    def process_object_tasks(self, items):
        """Batched mapping-worker entry: apply the same-object gate to every
        queued (track_id, det) (while another keyframe of the same object is
        queued, the newest one does the work; reference
        ObjectLocalMapping::CheckTheSameObject, src/ObjectLocalMapping.cpp:
        32-47), then solve every cleared object's windowed BA in one
        batched call per problem shape."""
        ready = []
        with self._obj_lock:
            for track_id, det in items:
                self._pending_okfs[track_id] = self._pending_okfs.get(track_id, 1) - 1
                if self._pending_okfs.get(track_id, 0) > 0:
                    continue
                track = self.tracks.get(track_id)
                if track is None or not track.keyframes:
                    continue
                ready.append((track, det))
        self._map_objects(ready)

    def _map_objects(self, ready):
        """Culling + neighbour fuse + windowed object BA (the
        ObjectLocalMapping thread's work) for each (track, det): culls, fuse
        and problem build under the object lock, one stacked solve per
        problem shape with the lock released (the result on the host before
        it is taken again), epoch-guarded write-backs."""
        built = []
        with self._obj_lock:
            for track, det in ready:
                okf_idx = len(track.keyframes) - 1
                epoch = track.epoch
                self._cull_object_points(track, okf_idx)
                self._fuse_object_neighbors(track, okf_idx)
                n_cov = len(track.covisible_keyframes(okf_idx, min_weight=5))
                ba_inputs = None
                if n_cov > self.cfg.objects.ba_min_covisible_kfs:
                    ba_inputs = self._build_object_ba(track, okf_idx)
                if ba_inputs is not None:
                    built.append((track, epoch, ba_inputs))
                else:
                    # no solve pending for this track -> safe to cull now
                    # (culling between a BA build and its write-back would
                    # shift the okf indices the solve was built against)
                    self._cull_object_keyframes(track)
        if not built:
            return
        # group by problem shape (windows bucket their pose capacity to
        # powers of two); each group solves in one batched call
        groups = defaultdict(list)
        for b in built:
            prob = b[2][0]
            groups[(prob.poses.shape[0], prob.points.shape[0])].append(b)
        for (P_cap, _), grp in groups.items():
            probs = local_ba.stack_problems([b[2][0] for b in grp])
            pri_list = [b[2][3] for b in grp]
            priors = None
            if any(p is not None for p in pri_list):
                priors = local_ba.stack_problems([
                    p if p is not None
                    else local_ba.empty_motion_priors(R_cap=P_cap, device=self.device)
                    for p in pri_list
                ])
            results = local_ba.bundle_adjust_batched(probs, **self._cam_args, priors=priors)
            # on the host before the lock is taken, in one transfer
            results = host(*results)
            self.ba_calls += len(grp)
            self.ba_threads.add(threading.get_ident())
            with self._obj_lock:
                for bi, (track, epoch, (prob, slot_edge, meta, _)) in enumerate(grp):
                    if track.epoch != epoch:
                        continue
                    res = local_ba.BAResult(*(x[bi] for x in results))
                    self._apply_object_ba(track, res, slot_edge, meta)
                    self._cull_object_keyframes(track)

    def _unproject_local(self, okf, sel):
        cam = self.cfg.camera
        z = okf.depth[sel]
        x = (okf.xy[sel, 0] - cam.cx) * z / cam.fx
        y = (okf.xy[sel, 1] - cam.cy) * z / cam.fy
        return np.stack([x, y, z], axis=1)

    # ------------------------------------------------------------------
    def _prior_translation(self, det, feats, fsel) -> np.ndarray:
        """Detection-derived translation prior for the pose solve (the
        reference's EdgeTransConstraintFromDetction anchor): trimmed stereo
        centroid or the offline location."""
        if self.cfg.objects.set_init_position_by_points:
            stereo = fsel[feats.depth[fsel] > 0]
            if len(stereo) >= 3:
                pc = self._unproject(feats, stereo)
                med = np.median(pc, axis=0)
                d = np.linalg.norm(pc - med, axis=1)
                keep = d < max(np.median(d) * 2.5, 1.0)
                return pc[keep].mean(axis=0) if keep.sum() >= 3 else med
        return np.asarray(det.location_cam, np.float64)

    def _build_edges(self, items, binds, feats):
        """Batched pose-LM edges (device tensors) from per-object feature
        bindings."""
        O = len(items)
        pts = np.zeros((O, EDGE_CAP, 3), np.float32)
        obs = np.zeros((O, EDGE_CAP, 3), np.float32)
        stereo = np.zeros((O, EDGE_CAP), bool)
        inv2 = np.ones((O, EDGE_CAP), np.float32)
        valid = np.zeros((O, EDGE_CAP), bool)
        for oi, (det, fsel, track) in enumerate(items):
            bind = binds[oi]
            good = np.nonzero(bind >= 0)[0][:EDGE_CAP]
            n = len(good)
            if n == 0:
                continue
            f = fsel[good]
            pts[oi, :n] = track.pt_pos[bind[good]]
            obs[oi, :n] = np.stack(
                [feats.xy[f, 0], feats.xy[f, 1], feats.u_right[f]], axis=1
            )
            stereo[oi, :n] = feats.depth[f] > 0
            inv2[oi, :n] = (1.0 / self._scales**2)[feats.level[f]]
            valid[oi, :n] = True
        d = self.device
        return dict(pts=to_tensor(pts, None, d), obs=to_tensor(obs, None, d),
                    is_stereo=to_tensor(stereo, None, d), inv_sigma2=to_tensor(inv2, None, d),
                    valid=to_tensor(valid, None, d))

    def _solve(self, T_init: np.ndarray, edges: dict, priors: torch.Tensor):
        """The object pose LMs with the translation prior, all objects in
        one batch; returns (T float64, inliers) on the host."""
        res = pose_opt.pose_optimize(to_tensor(T_init, torch.float32, self.device), **edges,
                                     **self._cam_args, trans_prior=priors,
                                     trans_prior_weight=TRANS_PRIOR_WEIGHT)
        T, inl = host(res.T, res.inliers)
        return T.astype(np.float64), inl

    def _project(self, tables, T: np.ndarray, feats_dev):
        """Batched projection match of every object's points through T."""
        pt_pos, pt_desc, pt_valid = tables
        O, P = pt_pos.shape[:2]
        return matchers.project_and_match(
            pt_pos, pt_desc, pt_valid, to_tensor(T, torch.float32, self.device), *feats_dev,
            6.0, self._scales_dev,
            torch.zeros((O, P), dtype=torch.int32, device=self.device),
            th_desc=matchers.TH_HIGH, **self._proj,
        ).point_for_feature

    def _flow_predictions(self, items, flow):
        """Each anchored point's last observed pixel (seen in the previous
        frame) warped by the previous frame's forward flow: (O, P, 2)
        positions and (O, P) flags, host arrays."""
        P = self.cfg.objects.max_object_points
        H_f, W_f = flow.shape[:2]
        pred_xy = np.zeros((len(items), P, 2), np.float32)
        pred_ok = np.zeros((len(items), P), bool)
        for oi, (det, fsel, track) in enumerate(items):
            anchored = track.pt_valid & (track.pt_last_frame == det.frame_id - 1)
            rows = np.nonzero(anchored)[0]
            if len(rows) == 0:
                continue
            xy = track.pt_last_xy[rows]
            xi = np.clip(np.round(xy[:, 0]).astype(int), 0, W_f - 1)
            yi = np.clip(np.round(xy[:, 1]).astype(int), 0, H_f - 1)
            pred_xy[oi, rows] = xy + flow[yi, xi]
            pred_ok[oi, rows] = True
        return pred_xy, pred_ok

    def _gms_keep(self, items, binds, feats, fsels, T_pred):
        """GMS on the bindings of every object with 20 or more of them, each
        point's projection through the predicted pose as the second view (the
        reference's SearchByBruceMatchingWithGMS role), in one batched call
        and one transfer: {object index: (the bound rows, their keep mask)}."""
        cam = self.cfg.camera
        lanes = []
        for oi, (det, _, track) in enumerate(items):
            good = np.nonzero(binds[oi] >= 0)[0]
            if len(good) < 20:
                continue
            po = track.pt_pos[binds[oi][good]]
            T = T_pred[oi].astype(np.float64)
            pc = po @ T[:3, :3].T + T[:3, 3]
            z = np.maximum(pc[:, 2], 1e-6)
            proj = np.stack([cam.fx * pc[:, 0] / z + cam.cx,
                             cam.fy * pc[:, 1] / z + cam.cy], axis=1)
            lanes.append((oi, good, feats.xy[fsels[oi][good]], proj))
        if not lanes:
            return {}
        xy_a = np.zeros((len(lanes), F_CAP, 2), np.float32)
        xy_b = np.zeros((len(lanes), F_CAP, 2), np.float32)
        vmask = np.zeros((len(lanes), F_CAP), bool)
        for li, (_, good, a, b) in enumerate(lanes):
            xy_a[li, :len(good)] = a
            xy_b[li, :len(good)] = b
            vmask[li, :len(good)] = True
        d = self.device
        keep = host(gms_filter(to_tensor(xy_a, None, d), to_tensor(xy_b, None, d),
                               to_tensor(vmask, None, d), cam.width, cam.height))[0]
        return {oi: (good, keep[li, :len(good)]) for li, (oi, good, _, _) in enumerate(lanes)}

    def _track_objects_batched(self, items, feats, T_cw, timestamp, flow=None):
        """Track every live object of the frame in batched stages: point
        match (brute, and flow-guided when `flow` is given; GMS-filtered
        under ``use_gms``) and projection match -> pose LM -> local-map
        projection -> pose LM. Returns the list of (det, fsel, track) that
        failed."""
        if not items:
            return []
        min_feats = self.cfg.objects.track_min_features // 2
        pre_failed = [it for it in items if len(it[1]) < min_feats]
        for det, fsel, track in pre_failed:
            track.track_ok = False
        items = [it for it in items if len(it[1]) >= min_feats]
        if not items:
            return pre_failed

        O = len(items)
        P = self.cfg.objects.max_object_points
        f_xy = np.zeros((O, F_CAP, 2), np.float32)
        pt_angle = np.zeros((O, P), np.float32)
        f_level = np.zeros((O, F_CAP), np.int32)
        f_desc = np.zeros((O, F_CAP, 8), np.uint32)
        f_angle = np.zeros((O, F_CAP), np.float32)
        f_valid = np.zeros((O, F_CAP), bool)
        pt_pos = np.zeros((O, P, 3), np.float32)
        pt_desc = np.zeros((O, P, 8), np.uint32)
        pt_valid = np.zeros((O, P), bool)
        T_pred = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
        priors = np.zeros((O, 3), np.float32)
        fsels = []
        for oi, (det, fsel, track) in enumerate(items):
            fsel = fsel[:F_CAP]
            fsels.append(fsel)
            n = len(fsel)
            f_xy[oi, :n] = feats.xy[fsel]
            f_level[oi, :n] = feats.level[fsel]
            f_desc[oi, :n] = feats.desc[fsel]
            f_angle[oi, :n] = feats.angle[fsel]
            f_valid[oi, :n] = feats.valid[fsel]
            pt_pos[oi] = track.pt_pos
            pt_desc[oi] = track.pt_desc
            pt_angle[oi] = track.pt_last_angle
            pt_valid[oi] = track.pt_valid
            Tp = track.predict_pose_cf(det.frame_id, T_cw)
            if Tp is None:
                Tp = self._init_pose_from_detection(det, feats, fsel)
            T_pred[oi] = Tp
            priors[oi] = self._prior_translation(det, feats, fsel)

        d = self.device
        tables = (to_tensor(pt_pos, None, d), to_tensor(pt_desc, torch.int32, d),
                  to_tensor(pt_valid, None, d))
        feats_dev = (to_tensor(f_xy, None, d), to_tensor(f_level, None, d),
                     to_tensor(f_desc, torch.int32, d), to_tensor(f_valid, None, d))
        priors_dev = to_tensor(priors, None, d)

        # stage 1: batched brute match (SearchByBruceMatching analog): ratio +
        # rotation histogram (src/ORBmatcher.cc:2043-2155); point angles are
        # their last observed keypoint orientation. Under GMS the histogram
        # is skipped, as the reference's GMS path is ratio-only
        # (TwoFrameObjectPointsBruceMatching, src/ORBmatcher.cc:1982)
        bind_t = matchers.brute_match(
            feats_dev[2], to_tensor(f_angle, None, d), feats_dev[3],
            tables[1], to_tensor(pt_angle, None, d), tables[2],
            nn_ratio=0.9, th_desc=matchers.TH_HIGH,
            check_rotation=not self.cfg.objects.use_gms,
        ).idx_b_for_a
        # the velocity-pose projection supplement and the flow-guided match
        # are independent of the brute result: all come back in one transfer
        pending = [bind_t, self._project(tables, T_pred, feats_dev)]
        if flow is not None:
            pred_xy, pred_ok = self._flow_predictions(items, flow)
            ocfg = self.cfg.objects
            guided = matchers.guided_match(
                to_tensor(pred_xy, None, d), to_tensor(pred_ok, None, d), tables[1],
                feats_dev[0], feats_dev[2], feats_dev[3],
                radius=ocfg.flow_match_radius, th_desc=ocfg.flow_match_th_desc)
            pending += [guided.point_for_feature, guided.n_matches]
        bind_np, pf0_np, *guided_np = host(*pending)
        binds = [bind_np[oi].astype(np.int64)[: len(fsels[oi])] for oi in range(O)]

        if flow is not None:
            # an object keeps the guided bindings when they give >= 5 pairs,
            # else the brute ones (the reference's nMinRansacNum fallback,
            # src/ORBmatcher.cc:2319-2334)
            pf_g, n_g = guided_np
            for oi in range(O):
                if int(n_g[oi]) >= 5:
                    binds[oi] = pf_g[oi].astype(np.int64)[: len(fsels[oi])]
                    items[oi][2].flow_tracked_frames += 1
                    PROFILER.count("obj_flow_takeovers")

        if self.cfg.objects.use_gms:
            for oi, (good, keep) in self._gms_keep(items, binds, feats, fsels, T_pred).items():
                binds[oi][good[~keep]] = -1
                PROFILER.count("obj_gms_dropped", float((~keep).sum()))

        # spatially-gated projection match through the velocity-predicted
        # pose supplements the brute bindings (the reference's dynamic-point
        # SearchByProjection, src/ORBmatcher.cc:157)
        for oi in range(O):
            pf = pf0_np[oi][: len(fsels[oi])]
            bind = binds[oi]
            add = np.nonzero((pf >= 0) & (bind < 0))[0]
            bind[add] = pf[add]

        T1, inl1 = self._solve(T_pred, self._build_edges(items, binds, feats), priors_dev)
        for oi in range(O):
            bind = binds[oi]
            good = np.nonzero(bind >= 0)[0][:EDGE_CAP]
            bad = good[~inl1[oi, : len(good)]]
            bind[bad] = -1

        # stage 2: batched local-map projection through the refined poses
        pf_np = host(self._project(tables, T1, feats_dev))[0]
        for oi in range(O):
            pf = pf_np[oi][: len(fsels[oi])]
            bind = binds[oi]
            add = np.nonzero((pf >= 0) & (bind < 0))[0]
            bind[add] = pf[add]

        T2, inl2 = self._solve(T1, self._build_edges(items, binds, feats), priors_dev)

        failed = list(pre_failed)
        for oi, (det, fsel, track) in enumerate(items):
            bind = binds[oi]
            good = np.nonzero(bind >= 0)[0][:EDGE_CAP]
            inl = inl2[oi, : len(good)]
            bind[good[~inl]] = -1
            n_inl = int(inl.sum())
            track.n_inliers = n_inl
            found = bind[bind >= 0]
            track.pt_found[found] += 1
            track.pt_visible[found] += 1
            # record last observed pixel per point
            fidx = np.nonzero(bind >= 0)[0]
            track.pt_last_xy[bind[fidx]] = feats.xy[fsels[oi][fidx]]
            track.pt_last_angle[bind[fidx]] = feats.angle[fsels[oi][fidx]]
            track.pt_last_frame[bind[fidx]] = det.frame_id
            if n_inl < self.cfg.objects.min_tracked_points:
                track.track_ok = False
                failed.append((det, fsel, track))
                continue
            track.track_ok = True
            fsel_t = fsels[oi]
            self._dynamic_discrimination(track, det, feats, fsel_t, bind, T_cw, T2[oi])
            self._record_state(track, det, T2[oi], T_cw, timestamp)
            last_okf = track.keyframes[-1]
            n_ref = int((last_okf.point_idx >= 0).sum())
            if n_inl < 0.9 * n_ref or det.frame_id - last_okf.frame_id >= 5:
                self._add_keyframe_with_points(
                    track, det, feats, fsel_t, T2[oi], T_cw, timestamp, bind=bind
                )
        return failed

    # ------------------------------------------------------------------
    def _dynamic_discrimination(self, track, det, feats, fsel, bind, T_cw, T_co):
        """Static-hypothesis reprojection test (reference
        src/Tracking.cc:2058-2202; thresholds mono>1 / stereo>2 from
        src/DetectionObject.cc:189)."""
        prev = track.last_seen_frame
        if prev < 0 or prev not in track.poses_world:
            return
        cam = self.cfg.objects
        T_co_static = T_cw @ track.poses_world[prev]     # object frozen in world
        good = np.nonzero(bind >= 0)[0]
        if len(good) < 5:
            return
        po = track.pt_pos[bind[good]]
        pc = po @ T_co_static[:3, :3].T + T_co_static[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        c = self.cfg.camera
        u = c.fx * pc[:, 0] / z + c.cx
        v = c.fy * pc[:, 1] / z + c.cy
        f = fsel[good]
        err = np.sqrt((u - feats.xy[f, 0]) ** 2 + (v - feats.xy[f, 1]) ** 2)
        stereo = feats.depth[f] > 0
        err_ur = np.abs((u - c.bf / z) - feats.u_right[f])
        mono_err = float(np.median(err[~stereo])) if (~stereo).any() else 0.0
        stereo_err = (
            float(np.median(np.maximum(err[stereo], err_ur[stereo])))
            if stereo.any()
            else 0.0
        )
        is_dyn = (mono_err > cam.dyn_mono_err_threshold) or (
            stereo_err > cam.dyn_stereo_err_threshold
        )
        track.vote_dynamic(is_dyn, hysteresis=cam.dyn_hysteresis_votes)

    def _record_state(self, track, det, T_co, T_cw, timestamp):
        f = det.frame_id
        track.poses_cf[f] = np.asarray(T_co, np.float64)
        track.poses_world[f] = np.linalg.inv(T_cw) @ T_co
        track.detections[f] = det
        if track.keyframes:
            okf = track.keyframes[-1]
            track.rel_pose_log[f] = (
                okf.obj_kf_id, T_co @ np.linalg.inv(okf.T_co)
            )
        prev = track.last_seen_frame
        if prev >= 0 and prev != f:
            track.update_velocity(prev, f)
        track.last_seen_frame = f
        track.last_seen_time = timestamp

    # ------------------------------------------------------------------
    def _fuse_object_neighbors(self, track: ObjectTrack, okf_idx: int):
        """Bind the new object-KF's unmatched features to existing object
        points by projection (ObjectLocalMapping::SearchInNeighbors two-level
        fuse, reference src/ObjectLocalMapping.cpp:153-267)."""
        okf = track.keyframes[okf_idx]
        unbound = okf.point_idx < 0
        if unbound.sum() < 5 or track.n_points() == 0:
            return
        F = len(okf.xy)

        def fpad(a, fill=0):
            out = np.full((F_CAP,) + a.shape[1:], fill, a.dtype)
            out[: min(F, F_CAP)] = a[:F_CAP]
            return out

        d = self.device
        res = matchers.project_and_match(
            to_tensor(track.pt_pos[None], torch.float32, d),
            to_tensor(track.pt_desc[None], torch.int32, d),
            to_tensor(track.pt_valid[None], None, d),
            to_tensor(okf.T_co[None], torch.float32, d),
            to_tensor(fpad(okf.xy.astype(np.float32)), None, d),
            to_tensor(fpad(okf.level.astype(np.int32)), None, d),
            to_tensor(fpad(okf.desc), torch.int32, d),
            to_tensor(fpad(unbound, False), None, d),
            4.0, self._scales_dev,
            torch.zeros((1, track.max_points), dtype=torch.int32, device=d),
            th_desc=matchers.TH_LOW, **self._proj,
        )
        pf = host(res.point_for_feature)[0][0][:F]
        feats = np.nonzero(pf >= 0)[0]
        if len(feats):
            okf.point_idx[feats] = pf[feats]
            track.obs[pf[feats], okf_idx] = True
            track.update_point_stats(pf[feats])

    def _cull_object_points(self, track: ObjectTrack, okf_idx: int):
        """found/visible < 0.25 or <3 obs shortly after creation
        (reference src/ObjectLocalMapping.cpp:107-151)."""
        valid = np.nonzero(track.pt_valid)[0]
        if len(valid) == 0:
            return
        ratio = track.pt_found[valid] / np.maximum(track.pt_visible[valid], 1)
        age = okf_idx - track.pt_first_okf[valid]
        obs_n = track.obs[valid].sum(axis=1)
        cull = (ratio < 0.25) & (age >= 2)
        cull |= (age >= 2) & (obs_n < 2)
        if cull.any():
            track.cull_points(valid[cull])

    def _cull_object_keyframes(self, track: ObjectTrack) -> None:
        """90%-redundancy object-keyframe culling (reference
        ObjectLocalMapping::KeyFrameCulling, src/ObjectLocalMapping.cpp:
        269-323): a covisible object KF dies when >90% of its close-depth
        points are observed by >=3 OTHER object KFs at scale <= level+1.
        KF 0 (the object's first observation) is never culled. Runs with the
        object lock held; must not run between a BA build and its
        write-back (indices would shift)."""
        cfg = self.cfg.objects
        if not cfg.kf_culling or len(track.keyframes) < 3:
            return
        okf_idx = len(track.keyframes) - 1
        cand = [int(i)
                for i in track.covisible_keyframes(okf_idx, min_weight=5)
                if int(i) not in (0, okf_idx)]
        if not cand:
            return
        n = len(track.keyframes)
        P = track.max_points
        # per-KF point -> observation octave (127 = not observed)
        lvl = np.full((n, P), 127, np.int16)
        for j, okf in enumerate(track.keyframes):
            b = okf.point_idx >= 0
            lvl[j, okf.point_idx[b]] = okf.level[b]
        observed = lvl < 127                               # (n, P)
        th_depth = self.cfg.camera.depth_threshold
        remove = []
        for c in cand:
            okf = track.keyframes[c]
            b = np.nonzero(okf.point_idx >= 0)[0]
            rows = okf.point_idx[b]
            good = (track.pt_valid[rows]
                    & (okf.depth[b] > 0) & (okf.depth[b] <= th_depth))
            rows, b = rows[good], b[good]
            if len(rows) == 0:
                continue
            total_obs = observed[:, rows].sum(axis=0)
            scale_ok = (observed[:, rows]
                        & (lvl[:, rows] <= okf.level[b][None, :] + 1))
            others = scale_ok.sum(axis=0) - scale_ok[c]
            redundant = (total_obs > 3) & (others >= 3)
            if redundant.sum() > cfg.kf_cull_redundancy * len(rows):
                remove.append(c)
        if remove:
            track.remove_keyframes(remove)
            PROFILER.count("object_kf_culled", len(remove))

    def _build_object_ba(self, track: ObjectTrack, okf_idx: int):
        """Assemble the windowed object BA problem: covisible object KFs
        within the 120-id window with roll/pitch frozen (reference
        Optimizer::ObjectLocalBundleAdjustment, window src/Optimizer.cc:47,
        VertexSE3Fix :836-838). Called with the object lock held; returns
        (prob, slot_edge, meta, priors) for the lock-free solve, or None.
        The pose capacity is the next power-of-two bucket of the live
        window size (ceiling ObjectConfig.ba_window_pose_cap); the batched
        solver groups problems by this shape."""
        window_all = sorted(set([okf_idx] + [
            int(i)
            for i in track.covisible_keyframes(okf_idx, min_weight=5)
            if okf_idx - int(i) <= self.cfg.objects.ba_window_kf_ids
        ]))
        P_cap = _pose_bucket(len(window_all), self.cfg.objects.ba_window_pose_cap)
        window_ids = window_all[-P_cap:]
        if len(window_all) > len(window_ids):
            PROFILER.count("object_ba_window_truncated", len(window_all) - len(window_ids))
        kfs = [track.keyframes[i] for i in window_ids]
        L_cap = track.max_points

        pts = np.nonzero(track.pt_valid)[0]
        pt_row = np.full(track.max_points, -1, np.int64)
        pt_row[pts] = np.arange(len(pts))

        e_pose, e_point, e_obs, e_stereo, e_inv2 = [], [], [], [], []
        for ri, okf in enumerate(kfs):
            bound = np.nonzero(okf.point_idx >= 0)[0]
            p = okf.point_idx[bound]
            sel = pt_row[p] >= 0
            bound, p = bound[sel], p[sel]
            e_pose.append(np.full(len(bound), ri))
            e_point.append(pt_row[p])
            e_obs.append(
                np.stack([okf.xy[bound, 0], okf.xy[bound, 1], okf.u_right[bound]], 1)
            )
            e_stereo.append(okf.depth[bound] > 0)
            e_inv2.append(1.0 / self._scales[okf.level[bound]] ** 2)
        e_pose = np.concatenate(e_pose)
        e_point = np.concatenate(e_point)
        e_obs = np.concatenate(e_obs)
        e_stereo = np.concatenate(e_stereo)
        e_inv2 = np.concatenate(e_inv2)
        E = len(e_pose)
        if E < 30:
            return None

        # dof mask: translations + yaw (omega_y) free; roll/pitch frozen
        dof = np.zeros((P_cap, 6), np.float32)
        dof[:, :3] = 1.0
        dof[:, 4] = 1.0
        fixed = [i == 0 for i in range(len(kfs))]

        prob, slot_edge = local_ba.build_problem(
            poses=np.stack([k.T_co for k in kfs]).astype(np.float32),
            pose_fixed=np.asarray(fixed),
            points=track.pt_pos[pts].astype(np.float32),
            e_pose=e_pose, e_point=e_point, e_obs=e_obs, e_stereo=e_stereo,
            e_inv_sigma2=e_inv2,
            P_cap=P_cap, L_cap=L_cap, K=self.cfg.ba.max_obs_per_point,
            dof_mask=dof, device=self.device,
        )
        priors = self._build_motion_priors(track, kfs, R_cap=P_cap)
        meta = dict(kfs=kfs, fixed=fixed, pts=pts, window_ids=window_ids,
                    e_pose=e_pose, e_point=e_point)
        return prob, slot_edge, meta, priors

    def _build_motion_priors(self, track: ObjectTrack, kfs, R_cap: int = 32):
        """Constant-velocity SE(3) priors between consecutive window KFs:
        predicted T_co(j) = T_cw(j) V^gap T_wo(i), weighted by
        objects.ba_motion_prior_weight. None at weight 0, the reference's
        live surface."""
        w = self.cfg.objects.ba_motion_prior_weight
        if w <= 0 or track.velocity_world is None or len(kfs) < 2:
            return None
        idx, T_rel, weights = [], [], []
        for ri in range(1, len(kfs)):
            a, b = kfs[ri - 1], kfs[ri]
            gap = max(int(b.frame_id - a.frame_id), 1)
            V = np.linalg.matrix_power(track.velocity_world, gap)
            T_rel.append(b.T_cw @ V @ np.linalg.inv(a.T_cw))
            idx.append([ri - 1, ri])
            weights.append(w / gap)
        return local_ba.build_motion_priors(
            idx=np.asarray(idx), T_rel=np.stack(T_rel).astype(np.float32),
            weight=np.asarray(weights), R_cap=R_cap, device=self.device,
        )

    def _apply_object_ba(self, track: ObjectTrack, result, slot_edge, meta):
        """Write the solve (host arrays) back onto the track tables (object
        lock held)."""
        kfs, fixed, pts = meta["kfs"], meta["fixed"], meta["pts"]
        window_ids, e_pose, e_point = (
            meta["window_ids"], meta["e_pose"], meta["e_point"]
        )
        new_poses = np.asarray(result.poses, np.float64)
        for ri, okf in enumerate(kfs):
            if not fixed[ri]:
                okf.T_co = new_poses[ri]
        still = track.pt_valid[pts]  # points culled since build stay culled
        track.pt_pos[pts[still]] = np.asarray(
            result.points, np.float64)[: len(pts)][still]
        # drop outlier observations
        inl = np.asarray(result.obs_inlier)
        for b in slot_edge[(slot_edge >= 0) & ~inl]:
            okf = kfs[int(e_pose[b])]
            p = pts[int(e_point[b])]
            featsel = np.nonzero(okf.point_idx == p)[0]
            if len(featsel):
                okf.point_idx[featsel] = -1
                track.obs[p, window_ids[int(e_pose[b])]] = False

    # ------------------------------------------------------------------
    def export_detections(self) -> List[dict]:
        """Per-frame object states in the writer's schema, recovered from the
        relative-pose log against (BA-refined) object keyframes: the
        reference's SaveObjectDetectionKITTI recovery (src/System.cc:409-473)."""
        out = []
        for track in self.all_tracks:
            for f, (okf_id, T_rel) in sorted(track.rel_pose_log.items()):
                if okf_id >= len(track.keyframes):
                    continue
                okf = track.keyframes[okf_id]
                T_co = T_rel @ okf.T_co
                det = track.detections.get(f)
                if det is None:
                    continue
                out.append(
                    dict(
                        frame_id=f,
                        track_id=track.track_id,
                        bbox=np.asarray(det.bbox),
                        dims=np.asarray(det.dims),
                        t_co=T_co[:3, 3],
                        pitch=heading_y(T_co[:3, :3]),
                        truncated=det.truncated,
                        occluded=det.occluded,
                        alpha=det.alpha,
                        dynamic=track.dynamic,
                    )
                )
        return out
