"""System facade in every SLOT mode: the one object a user drives.

Port of ``pointslot_tpu/slam/system.py`` (the reference's System:
TrackStereo, SaveTrajectoryKITTI, SaveObjectDetectionKITTI and the object
savers, Shutdown): the stereo frontend and camera tracking run inline on
``device`` (the card by default), local mapping runs per keyframe,
synchronously or on a worker thread (``RuntimeConfig.async_mapping``, the
reference's LocalMapping and ObjectLocalMapping threads), and
``RuntimeConfig.device_resident_tracking`` tracks healthy frames through
the fused step (slam/fast_path.py).

The SLOT modes:
- 0, stereo SLAM;
- 1, dynamic SLAM: the instance mask's objects are cut from the camera's
  features; with ``dynaslam_mode=1`` a frame without a mask takes one
  carried by the ROI tracker (detect/tracker2d.py) from the last mask;
- 2, manual ROIs: boxes registered with ``select_rois`` are carried by the
  ROI tracker and become the frame's detections;
- 3, online: the YOLO detector (detect/yolo.py), then DeepSORT with the
  ReID network (detect/deepsort.py, detect/reid.py) give the frame's
  detections, unless the caller passes its own;
- 4, offline detections and instance masks, given per frame.
In modes 2-4 the detections' mask becomes the camera's background gate,
except for objects settled as static, whose features go back to camera
tracking (StaticPointRecoveryFromObj, src/Tracking.cc:2204-2254); then the
ObjectSystem (slam/object_system.py) tracks and maps the objects. The
async worker takes object keyframes too and solves up to 8 consecutive
ones in one batched BA, never deferring a camera keyframe behind them.

With ``LoopConfig.enabled`` (the default) each keyframe then goes to the
loop closer (slam/loop_closing.py: detection, verification, correction and
the global BA, on a thread of its own by default), under the map lock, and
the tracker relocalizes a LOST frame against the keyframe database; the
object side does not touch loop closing.

The options run too: the objects' GMS filter and offline-flow matching
(``objects.use_gms``, ``objects.use_offline_flow``: ``track_stereo`` hands
the previous frame's ``flow`` to the object system), a DBoW2 vocabulary
file and the tree vocabulary with its sparse database
(``loop.vocab_path``, ``loop.vocab_as_tree``), and a distorted camera (the
frame record's keypoints undistorted; the fast path stays off, as in the
reference). ``slam/checkpoint.py`` saves and restores a System. A frame
the batched frontend extracted ahead (``track_stereo(precomputed=...)``,
the runner's ``--dp``) stands in for the frontend on an ungated frame.

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP
item: pipeline stages (item 15).
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from pointslot_torch import convert
from pointslot_torch.config import SLOTMode, SystemConfig
from pointslot_torch.detect.deepsort import DeepSort
from pointslot_torch.detect.reid import ReIDEmbedder
from pointslot_torch.detect.tracker2d import MultiTracker2D
from pointslot_torch.detect.yolo import Detector
from pointslot_torch.device import resolve_device
from pointslot_torch.geometry.camera import undistort_points
from pointslot_torch.io.writers import write_object_detections_kitti, write_trajectory_kitti
from pointslot_torch.ops.frontend import StereoFrame, StereoFrontend
from pointslot_torch.slam.fast_path import DeviceTrackingPath
from pointslot_torch.slam.local_mapping import LocalMapper
from pointslot_torch.slam.loop_closing import LoopCloser, Relocalizer
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.slam.object_system import ObjectSystem
from pointslot_torch.slam.objects import Detection
from pointslot_torch.slam.tracking import CameraTracker
from pointslot_torch.utils.profiling import PROFILER
from pointslot_torch.vocab.bow import load_vocab, train_default_vocab


def _unported(cfg: SystemConfig) -> Optional[str]:
    """What of `cfg` the port does not run yet, with its ROADMAP item."""
    if cfg.runtime.pipeline_stages:
        return "pipeline_stages (ROADMAP item 15)"
    return None


class System:
    def __init__(self, config: Optional[SystemConfig] = None, device="cuda"):
        self.cfg = config or SystemConfig()
        missing = _unported(self.cfg)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.device = resolve_device(device)
        cam = self.cfg.camera
        self.frontend = StereoFrontend(cam.height, cam.width, cam.fx, cam.bf,
                                       self.cfg.orb, device=self.device)
        self.map = MapState(
            max_kfs=self.cfg.runtime.map_max_kfs,
            max_points=self.cfg.runtime.map_max_points,
        )
        self.tracker = CameraTracker(self.cfg, self.map, device=self.device)
        self.local_mapper = LocalMapper(self.cfg, self.map, device=self.device)
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.reset_callback = self._on_reset
        self.loop_closer = None
        self._fast = None
        self._fast_frames = 0
        if self.cfg.runtime.device_resident_tracking:
            self._fast = DeviceTrackingPath(self.cfg, self.frontend)
        if self.cfg.loop.enabled:
            if self.cfg.loop.vocab_path:
                vocab = load_vocab(self.cfg.loop.vocab_path, as_tree=self.cfg.loop.vocab_as_tree,
                                   device=self.device)
            else:
                vocab = train_default_vocab(device=self.device)
            self.loop_closer = LoopCloser(self.cfg, self.map, vocab, device=self.device)
            self.loop_closer.on_loop_closed = self._on_loop_closed
            self.tracker.relocalizer = Relocalizer(self.cfg, self.map, self.loop_closer.db,
                                                   device=self.device)
        self.map.on_remove_keyframe = self._on_keyframe_removed
        self._object_system = None
        if self.cfg.slot_mode in (SLOTMode.MANUAL_TRACKING, SLOTMode.AUTONOMOUS_DRIVING,
                                  SLOTMode.OFFLINE):
            self._object_system = ObjectSystem(self.cfg, self)
        # mode 3: the online detector and DeepSORT with the ReID network
        self.detector = None
        self.mot = None
        if self.cfg.slot_mode == SLOTMode.AUTONOMOUS_DRIVING:
            self._build_detection()
        # mode 2: manual-ROI template tracking; mode 1 with dynaslam_mode 1
        # carries the dynamic regions' masks with the same tracker
        # (reference src/Tracking.cc:127-139)
        self.roi_tracker = None
        if self.cfg.slot_mode == SLOTMode.MANUAL_TRACKING or (
                self.cfg.slot_mode == SLOTMode.DYNAMIC_SLAM and self.cfg.dynaslam_mode == 1):
            self.roi_tracker = MultiTracker2D(device=self.device)
        # tracking holds map_lock for its whole frame; the mapper takes it
        # per phase and runs its device work outside it
        self.map_lock = threading.RLock()
        self.local_mapper.lock = self.map_lock
        if self.loop_closer is not None:
            # the GBA merge-back must exclude tracking/mapping map access
            self.loop_closer.map_lock = self.map_lock
        self._mapping_queue = queue.Queue()
        self._mapping_thread = None
        self._ba_skips = 0   # consecutive InterruptBA skips (capped at 2)
        self._pending_cam_kfs = 0          # camera KFs waiting in the queue
        self._pending_cam_lock = threading.Lock()
        # what the async worker caught, as (what it was mapping, exception);
        # raised by wait_for_mapping and shutdown
        self.mapping_errors = []
        if self.cfg.runtime.async_mapping:
            self._mapping_thread = threading.Thread(target=self._mapping_worker, daemon=True)
            self._mapping_thread.start()
        self.frame_times = []
        self.timestamps = []
        self._prev_flow = None   # the last frame's forward flow (offline-flow mode)
        self.profiler = PROFILER
        self.profiler.enabled = self.cfg.runtime.profile

    def _build_detection(self):
        det_cfg = self.cfg.detector
        self.detector = Detector(
            input_size=det_cfg.input_size, conf=det_cfg.conf_threshold,
            iou=det_cfg.iou_threshold, keep_classes=det_cfg.keep_classes,
            width=det_cfg.network_width, device=self.device)
        if det_cfg.weights_path:
            self.detector.load_npz(det_cfg.weights_path)
        embedder = ReIDEmbedder(feature_dim=det_cfg.reid_feature_dim, device=self.device)
        reid_path = det_cfg.reid_weights_path or ReIDEmbedder.bundled_weights_path()
        if reid_path:
            embedder.load_npz(reid_path)
        self.mot = DeepSort(det_cfg, embedder=embedder)

    # ------------------------------------------------------------------
    def _on_new_keyframe(self, kf: int):
        if self._mapping_thread is not None:
            with self._pending_cam_lock:
                self._pending_cam_kfs += 1
            self._mapping_queue.put(("camera", kf))
        else:
            self._process_keyframe_sync(kf)
        if self._fast is not None:
            # keyframe-rate device-table refresh (sync mapping has already
            # run BA here; async updates land via the periodic refresh)
            self._fast.refresh(self.map, self.tracker.ref_kf)

    def _process_keyframe_sync(self, kf: int):
        # When another camera keyframe is already queued, the windowed BA
        # is skipped for this one (the reference's InterruptBA /
        # CheckNewKeyFrames gate, src/LocalMapping.cc:219); at most two
        # consecutive keyframes skip, so every third always solves.
        if self._mapping_thread is not None:
            with self._pending_cam_lock:
                self._pending_cam_kfs -= 1
                pending = self._pending_cam_kfs >= 1
        else:
            pending = False
        skip = pending and self._ba_skips < 2
        self._ba_skips = self._ba_skips + 1 if skip else 0
        with self.profiler.timer("mapping"):
            self.local_mapper.process_keyframe(kf, skip_ba=skip)
            if self.loop_closer is not None:
                # loop closing locks for the whole event, like the
                # reference's CorrectLoop under mMutexMapUpdate
                with self.map_lock:
                    self.loop_closer.on_keyframe(kf)

    def _mapping_worker(self):
        """Async mapping thread (the reference's LocalMapping and
        ObjectLocalMapping threads, src/System.cc:106-118). Camera work
        shares MapState with tracking under map_lock; object work locks per
        the ObjectSystem's own lock; device work runs unlocked and its
        results are on the host before they are merged. Consecutive queued
        object keyframes (up to 8) are drained into one batched object BA;
        the drain stops at the first other item, so a camera keyframe is
        never deferred behind an object batch. Work that fails is recorded
        and the worker goes on with the next item."""
        while True:
            item = self._mapping_queue.get()
            if item is None:
                self._mapping_queue.task_done()
                return
            drained = 0
            try:
                if item[0] == "camera":
                    self._process_keyframe_sync(item[1])
                else:
                    batch = [(item[1], item[2])]
                    extra = ()   # () = no follow-up item drained
                    while len(batch) < 8:
                        try:
                            nxt = self._mapping_queue.get_nowait()
                        except queue.Empty:
                            break
                        drained += 1
                        if nxt is not None and nxt[0] == "object":
                            batch.append((nxt[1], nxt[2]))
                        else:
                            extra = nxt
                            break
                    try:
                        self._object_system.process_object_tasks(batch)
                    finally:
                        # the drained follow-up item survives a failed batch
                        if extra is None:
                            self._mapping_queue.put(None)   # re-arm the sentinel
                        elif extra != ():
                            self._process_keyframe_sync(extra[1])
            except Exception as e:
                traceback.print_exc()
                what = (f"keyframe {item[1]}" if item[0] == "camera"
                        else f"a keyframe of object track {item[1]}")
                self.mapping_errors.append((what, e))
            finally:
                for _ in range(1 + drained):
                    self._mapping_queue.task_done()

    def _on_loop_closed(self, corrections):
        # pose landscape changed under the tracker: drop the velocity model
        # so the next frame re-anchors on the corrected reference keyframe
        self.tracker.velocity = None
        if self.tracker.last_frame is not None and self.tracker.ref_kf >= 0:
            # re-express the last frame pose against the corrected ref KF
            ref = self.tracker.ref_kf
            if ref in corrections:
                T_old, T_new = corrections[ref]
                rel = self.tracker.last_frame.T_cw @ np.linalg.inv(T_old.astype(np.float32))
                self.tracker.last_frame.T_cw = (rel @ T_new).astype(np.float32)
        if self._fast is not None:
            self._fast.invalidate()

    def _on_keyframe_removed(self, kf: int):
        self.tracker.on_keyframe_removed(kf)
        if self.loop_closer is not None:
            self.loop_closer.db.remove(kf)

    def _on_reset(self):
        self.tracker.reset()
        self.local_mapper.recent_points.clear()
        if self.loop_closer is not None:
            self.loop_closer.db.clear()
            self.loop_closer.abort_gba()  # an in-flight GBA is now stale
        if self._fast is not None:
            self._fast.invalidate()

    # ------------------------------------------------------------------
    def track_stereo(self, left, right, timestamp: float, frame_id: int,
                     detections=None, instance_mask=None, flow=None,
                     precomputed=None):
        """Per-frame entry point (reference System::TrackStereo).
        `detections` (a list of slam.objects.Detection) and `instance_mask`
        (an (H, W) int mask, 0 = background, else a detection's
        mask_value) feed the object pipeline in modes 2-4 (mode 2 and 3
        make their own when none are given); mode 1 cuts the mask's
        regions from the camera's features; mode 0 reads neither. `flow`
        is this frame's (H, W, 2) forward optical flow (Virtual KITTI's
        offline maps): under ``objects.use_offline_flow`` the next frame's
        object tracking warps its point anchors through it (the reference
        stores it on the Frame, src/Frame.cc:700, and reads LastFrame's,
        src/ORBmatcher.cc:2268). `precomputed` is this pair's StereoFrame
        from the batched frontend (``StereoFrontend.batch``, tensors or
        numpy arrays): it stands in for the frontend when the frame has no
        gate, and keeps the fast path off for the frame."""
        t0 = time.perf_counter()
        left = np.asarray(left)
        right = np.asarray(right)
        detections, instance_mask = self._frame_objects(left, frame_id, detections,
                                                        instance_mask)
        gate = self._background_gate(detections, instance_mask)

        # device-resident fast path: the fused step when tracking is
        # healthy and the camera needs no undistortion; the host tracker
        # takes init, LOST and rejected frames
        fast_ok = (precomputed is None and self._fast is not None
                   and not self.cfg.camera.distorted and self._fast.ready(self.tracker))
        if fast_ok:
            with self.profiler.timer("tracking"), self.map_lock:
                # probe again under the lock: a loop closure landing between
                # the lock-free probe and here drops the velocity model
                # (_on_loop_closed)
                fast_ok = self._fast.ready(self.tracker)
                frame = None
                if fast_ok:
                    frame = self._fast.track(self.tracker, left, right, frame_id, gate=gate)
                if frame is not None:
                    self._fast_frames += 1
                    if self._fast_frames % self.cfg.runtime.fast_refresh_every == 0:
                        self._fast.refresh(self.map, self.tracker.ref_kf)
                    if self.tracker._need_new_keyframe(frame):
                        with self.profiler.timer("kf_create"):
                            self._fast.materialize(frame)
                            self.tracker._create_keyframe(frame)
                    self.tracker.commit_frame(frame)
                    if self._object_system is not None:
                        # the frame record carries its features in mode 4,
                        # as the reference's does
                        self._fast.materialize(frame)
                elif fast_ok:
                    # rejected: the host tracker re-runs the frame from the
                    # same extracted (and gate-checked) features
                    # (src/Tracking.cc:1148-1163)
                    frame = self._fast.fallback_frame(frame_id)
                    self.tracker.track(frame)
        if not fast_ok:
            if precomputed is not None and gate is None:
                sf = StereoFrame(*[convert.to_tensor(x, None, self.device) for x in precomputed])
            else:
                with self.profiler.timer("frontend"):
                    sf = self.frontend(left, right, gate=gate)
            frame = self._frame_record(sf, gate, frame_id)
            with self.profiler.timer("tracking"), self.map_lock:
                self.tracker.track(frame)
        self.timestamps.append(timestamp)

        if self._object_system is not None and frame.T_cw is not None:
            with self.profiler.timer("objects"):
                self._object_system.process_frame(
                    frame, left, right, detections, instance_mask, timestamp,
                    flow=self._prev_flow if self.cfg.objects.use_offline_flow else None)
        self._prev_flow = flow
        self.frame_times.append(time.perf_counter() - t0)
        return frame

    def _frame_objects(self, left, frame_id: int, detections, instance_mask):
        """The frame's detections and instance mask in modes 1-3: mode 3
        runs the detector and DeepSORT, mode 2 carries the ROIs, mode 1
        with ``dynaslam_mode=1`` reseeds the ROI tracker from a mask or
        carries the last one's regions."""
        mode = self.cfg.slot_mode
        if mode == SLOTMode.AUTONOMOUS_DRIVING and detections is None and self.detector is not None:
            with self.profiler.timer("detector"):
                raw = self.detector.run(left)
            with self.profiler.timer("mot"):
                tracks = self.mot.update(raw, left)
            detections = self._tracks_to_detections(tracks, frame_id)
            instance_mask = self._mask_from_detections(detections, left.shape)
        elif mode == SLOTMode.MANUAL_TRACKING and detections is None:
            if self.roi_tracker is not None and self.roi_tracker.tracks:
                with self.profiler.timer("roi_tracker"):
                    live = self.roi_tracker.update(left)
                detections = self._tracks_to_detections(
                    [{"track_id": t.track_id, "bbox": t.bbox, "class_id": 2} for t in live],
                    frame_id)
                instance_mask = self._mask_from_detections(detections, left.shape)
        if mode == SLOTMode.DYNAMIC_SLAM and self.cfg.dynaslam_mode == 1:
            if instance_mask is not None and np.any(instance_mask):
                # (re)seed the 2D trackers from the mask's component boxes
                self.roi_tracker.tracks.clear()
                for v in np.unique(instance_mask):
                    if v == 0:
                        continue
                    ys, xs = np.nonzero(instance_mask == v)
                    bbox = (xs.min(), ys.min(), xs.max() - xs.min() + 1,
                            ys.max() - ys.min() + 1)
                    self.roi_tracker.add(left, bbox)
            elif self.roi_tracker.tracks:
                with self.profiler.timer("roi_tracker"):
                    live = self.roi_tracker.update(left)
                mask = np.zeros(left.shape[:2], np.int32)
                for k, t in enumerate(live):
                    x, y, w, h = t.bbox
                    x0, y0 = int(max(x, 0)), int(max(y, 0))
                    x1 = int(min(x + w, mask.shape[1]))
                    y1 = int(min(y + h, mask.shape[0]))
                    if x1 > x0 and y1 > y0:
                        mask[y0:y1, x0:x1] = k + 1
                instance_mask = mask
        return detections, instance_mask

    def _background_gate(self, detections, instance_mask) -> Optional[np.ndarray]:
        """The camera's allowed region: in mode 1 the background of the
        instance mask; in modes 2-4 that plus the objects the discriminator
        has settled as static (StaticPointRecoveryFromObj,
        src/Tracking.cc:2204-2254); None without a mask or in mode 0."""
        if instance_mask is None or self.cfg.slot_mode == SLOTMode.SLAM:
            return None
        instance_mask = np.asarray(instance_mask)
        gate = instance_mask == 0
        if self._object_system is None:
            return gate
        for det in detections or ():
            tr = self._object_system.tracks.get(det.track_id)
            if (tr is not None and not tr.dynamic and tr.track_ok
                    and len(tr.poses_cf) >= self.cfg.objects.dyn_hysteresis_votes):
                gate |= instance_mask == det.mask_value
        return gate

    def _frame_record(self, sf, gate, frame_id: int):
        """The frame's host record in one device-to-host transfer. A
        distorted camera's keypoints are undistorted like the reference's
        Frame::UndistortKeyPoints (a no-op on rectified KITTI): the right
        match shifts through the same model at the left row (left and right
        share the intrinsics, like the reference's single mDistCoef), and
        the depth is re-derived from the undistorted disparity. Under a
        gate, each feature is checked against the mask at its rounded
        level-0 pixel of the distorted image, where the mask lives
        (coarse-level gating leaks a few boundary features; the reference's
        AssignFeatures, src/Frame.cc:810-844)."""
        c = self.cfg.camera
        if not c.distorted:
            frame = convert.frame_record(sf, frame_id)
            xy_raw = frame.xy
        else:
            lens = (c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2)
            has_st = sf.u_right >= 0
            ur_xy = torch.stack([torch.where(has_st, sf.u_right, torch.zeros_like(sf.u_right)),
                                 sf.xy[:, 1]], dim=1)
            frame, (xy_und, ur_und) = convert.frame_record_with(
                sf, frame_id, undistort_points(sf.xy, *lens),
                undistort_points(ur_xy, *lens)[:, 0])
            xy_raw = frame.xy
            has_st = frame.u_right >= 0
            frame.u_right = np.where(has_st, ur_und, frame.u_right).astype(frame.u_right.dtype)
            disp = np.maximum(xy_und[:, 0] - frame.u_right, 1e-3)
            frame.depth = np.where(has_st, c.bf / disp, -1.0).astype(np.float32)
            frame.xy = xy_und
        if gate is not None:
            yi = np.clip(np.round(xy_raw[:, 1]).astype(int), 0, gate.shape[0] - 1)
            xi = np.clip(np.round(xy_raw[:, 0]).astype(int), 0, gate.shape[1] - 1)
            frame.valid = frame.valid & gate[yi, xi]
        return frame

    # ------------------------------------------------------------------
    def select_rois(self, img, rois):
        """Mode 2: register user-drawn ROIs (x, y, w, h) on the current
        frame (the reference's cv::selectROIs, src/Frame.cc:1537); returns
        their track ids."""
        if self.roi_tracker is None:
            raise RuntimeError("ROI tracking requires SLOT mode 2")
        return [self.roi_tracker.add(np.asarray(img), r) for r in rois]

    def _tracks_to_detections(self, tracks, frame_id: int):
        """Tracked boxes ({track_id, bbox, ...}) -> Detections with the
        uniform (w, h, l) size prior and no 3D location."""
        w, h, l = self.cfg.objects.uniform_scale
        return [Detection(frame_id=frame_id, track_id=int(t["track_id"]),
                          bbox=np.asarray(t["bbox"], np.float64),
                          dims=np.asarray([l, h, w], np.float64), location_cam=np.zeros(3),
                          rotation_y=0.0, mask_value=k + 1, score=float(t.get("score", 1.0)))
                for k, t in enumerate(tracks)]

    def _mask_from_detections(self, detections, shape):
        """Rectangle instance mask, boxes shrunk by narrow_bbox_px, the
        largest painted first (reference EnNarrowBBoxPixelValue,
        src/Frame.cc:2595-2616)."""
        mask = np.zeros(shape[:2], np.int32)
        n = self.cfg.objects.narrow_bbox_px
        for det in sorted(detections, key=lambda d: d.bbox[2] * d.bbox[3], reverse=True):
            x, y, w, h = det.bbox
            x0, y0 = int(max(x + n, 0)), int(max(y + n, 0))
            x1, y1 = int(min(x + w - n, shape[1])), int(min(y + h - n, shape[0]))
            if x1 > x0 and y1 > y0:
                mask[y0:y1, x0:x1] = det.mask_value
        return mask

    @property
    def tracking_state(self):
        return self.tracker.state

    def camera_trajectory(self):
        return self.tracker.camera_trajectory()

    def save_trajectory_kitti(self, path: str):
        """KITTI odometry format: 12 floats per row = top 3 rows of T_wc
        (reference System::SaveTrajectoryKITTI src/System.cc:346-408)."""
        write_trajectory_kitti(path, self.camera_trajectory())

    def _objects(self) -> ObjectSystem:
        if self._object_system is None:
            raise RuntimeError("object pipeline inactive in this SLOT mode")
        return self._object_system

    def save_object_detections_kitti(self, out_dir: str):
        """One KITTI 3D-detection label file per frame (reference
        System::SaveObjectDetectionKITTI, src/System.cc:409-473)."""
        write_object_detections_kitti(out_dir, self._objects().export_detections(),
                                      len(self.timestamps))

    def save_object_poses_camera_frame(self, path: str):
        """Per-frame object poses in the CAMERA frame, one line per (frame,
        track): `frame_id track_id r00 ... t2` (12-float T_co rows), the
        reference's SaveObjectDetectionResultsInCameraFrame
        (src/System.cc:474-543)."""
        lines = []
        for track in self._objects().all_tracks:
            for f in sorted(track.poses_cf):
                vals = " ".join(f"{v:.9f}" for v in track.poses_cf[f][:3, :4].reshape(-1))
                lines.append(f"{f} {track.track_id} {vals}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def save_trajectory_camera_and_objects(self, camera_path: str,
                                           object_path_prefix: Optional[str] = None):
        """Camera trajectory + per-object trajectories in KITTI rows (reference
        System::SaveTrajectoryKITTICameraAndObject src/System.cc:544-631:
        each row the object-from-world T_co @ T_cw of its frame; the
        reference writes only the first object, this one file per track,
        `<prefix>_<track_id>.txt`)."""
        traj = self.camera_trajectory()
        write_trajectory_kitti(camera_path, traj)
        if self._object_system is None:
            return
        prefix = object_path_prefix or (os.path.splitext(camera_path)[0] + "_object")
        pose_by_frame = {f: T for f, T, _ in traj}
        for track in self._object_system.all_tracks:
            rows = [(f, track.poses_cf[f] @ pose_by_frame[f], False)
                    for f in sorted(track.poses_cf) if f in pose_by_frame]
            if rows:
                write_trajectory_kitti(f"{prefix}_{track.track_id}.txt", rows)

    def wait_for_mapping(self):
        """Block until the async mapping queue is drained AND the in-flight
        task (if any) has finished; raise if the worker failed on a keyframe."""
        if self._mapping_thread is not None:
            self._mapping_queue.join()
        self._raise_mapping_errors()

    def _raise_mapping_errors(self):
        if self.mapping_errors:
            what, first = self.mapping_errors[0]
            raise RuntimeError(
                f"async mapping failed on {len(self.mapping_errors)} keyframe(s), "
                f"the first on {what}") from first

    def shutdown(self):
        """Drain the mapping queue, wait for the global BA, stop the worker;
        raise what the mapping worker or the GBA thread failed on."""
        if self._mapping_thread is not None:
            self._mapping_queue.join()
        try:
            if self.loop_closer is not None:
                self.loop_closer.wait_for_gba()
        finally:
            if self._mapping_thread is not None:
                self._mapping_queue.put(None)
                self._mapping_thread.join(timeout=10)
                self._mapping_thread = None
        self._raise_mapping_errors()
        med = float(np.median(self.frame_times)) if self.frame_times else 0.0
        mean = float(np.mean(self.frame_times)) if self.frame_times else 0.0
        out = {"median_track_s": med, "mean_track_s": mean,
               "n_keyframes": self.map.n_keyframes(),
               "n_points": self.map.n_points()}
        if self.profiler.enabled:
            out["profile"] = self.profiler.summary()
        return out
