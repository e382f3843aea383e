"""System facade in SLOT mode 0: the one object a user drives.

Port of the mode-0 part of ``pointslot_tpu/slam/system.py`` (the
reference's System: TrackStereo, SaveTrajectoryKITTI, Shutdown): the
stereo frontend and camera tracking run inline on ``device`` (the card by
default), local mapping runs per keyframe, synchronously or on a worker
thread (``RuntimeConfig.async_mapping``, the reference's LocalMapping
thread), and ``RuntimeConfig.device_resident_tracking`` tracks healthy
frames through the fused step (slam/fast_path.py).

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: SLOT modes 1-4 (items 12 and 14), loop closing and
relocalization (``loop.enabled``, item 13), lens distortion (item 14),
pipeline stages (item 15) and a precomputed frame (the batched frontend,
item 10b).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np

from pointslot_torch import convert
from pointslot_torch.config import SLOTMode, SystemConfig
from pointslot_torch.device import resolve_device
from pointslot_torch.io.writers import write_trajectory_kitti
from pointslot_torch.ops.frontend import StereoFrontend
from pointslot_torch.slam.fast_path import DeviceTrackingPath
from pointslot_torch.slam.local_mapping import LocalMapper
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.slam.tracking import CameraTracker
from pointslot_torch.utils.profiling import PROFILER


def _unported(cfg: SystemConfig) -> Optional[str]:
    """What of `cfg` the port does not run yet, with its ROADMAP item."""
    if cfg.slot_mode != SLOTMode.SLAM:
        return (f"slot_mode {cfg.slot_mode}: only mode 0 is ported (objects and "
                f"mode 4 are ROADMAP item 12, modes 1-3 item 14)")
    if cfg.loop.enabled:
        return ("loop closing and relocalization (ROADMAP item 13); pass "
                "loop=LoopConfig(enabled=False)")
    if cfg.runtime.pipeline_stages:
        return "pipeline_stages (ROADMAP item 15)"
    if cfg.camera.distorted:
        return "lens distortion (geometry/camera.py, ROADMAP item 14)"
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
        self._fast = None
        self._fast_frames = 0
        if self.cfg.runtime.device_resident_tracking:
            self._fast = DeviceTrackingPath(self.cfg, self.frontend)
        self.map.on_remove_keyframe = self._on_keyframe_removed
        # tracking holds map_lock for its whole frame; the mapper takes it
        # per phase and runs its device work outside it
        self.map_lock = threading.RLock()
        self.local_mapper.lock = self.map_lock
        self._mapping_queue = queue.Queue()
        self._mapping_thread = None
        self._ba_skips = 0   # consecutive InterruptBA skips (capped at 2)
        self._pending_cam_kfs = 0          # camera KFs waiting in the queue
        self._pending_cam_lock = threading.Lock()
        # what the async worker caught, as (keyframe, exception); raised by
        # wait_for_mapping and shutdown
        self.mapping_errors = []
        if self.cfg.runtime.async_mapping:
            self._mapping_thread = threading.Thread(target=self._mapping_worker, daemon=True)
            self._mapping_thread.start()
        self.frame_times = []
        self.timestamps = []
        self.profiler = PROFILER
        self.profiler.enabled = self.cfg.runtime.profile

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

    def _mapping_worker(self):
        """Async mapping thread (the reference's LocalMapping thread,
        src/System.cc:106-118). Camera work shares MapState with tracking
        under map_lock; the mapper's device work runs unlocked and its
        results are on the host before it merges them. A keyframe that
        fails is recorded and the worker goes on with the next one."""
        while True:
            item = self._mapping_queue.get()
            try:
                if item is None:
                    return
                self._process_keyframe_sync(item[1])
            except Exception as e:
                traceback.print_exc()
                self.mapping_errors.append((item[1], e))
            finally:
                self._mapping_queue.task_done()

    def _on_keyframe_removed(self, kf: int):
        self.tracker.on_keyframe_removed(kf)

    def _on_reset(self):
        self.tracker.reset()
        self.local_mapper.recent_points.clear()
        if self._fast is not None:
            self._fast.invalidate()

    # ------------------------------------------------------------------
    def track_stereo(self, left, right, timestamp: float, frame_id: int,
                     detections=None, instance_mask=None, flow=None,
                     precomputed=None):
        """Per-frame entry point (reference System::TrackStereo). In mode 0
        `detections`, `instance_mask` and `flow` are not read, as in the
        reference; `precomputed` (a frame from the batched frontend) is not
        ported (ROADMAP item 10b)."""
        if precomputed is not None:
            raise NotImplementedError(
                "not ported yet: precomputed frames (batched frontend, ROADMAP item 10b)")
        t0 = time.perf_counter()
        left = np.asarray(left)
        right = np.asarray(right)

        # device-resident fast path: the fused step when tracking is
        # healthy; the host tracker takes init, LOST and rejected frames
        fast_ok = self._fast is not None and self._fast.ready(self.tracker)
        if fast_ok:
            with self.profiler.timer("tracking"), self.map_lock:
                frame = self._fast.track(self.tracker, left, right, frame_id)
                if frame is not None:
                    self._fast_frames += 1
                    if self._fast_frames % self.cfg.runtime.fast_refresh_every == 0:
                        self._fast.refresh(self.map, self.tracker.ref_kf)
                    if self.tracker._need_new_keyframe(frame):
                        with self.profiler.timer("kf_create"):
                            self._fast.materialize(frame)
                            self.tracker._create_keyframe(frame)
                    self.tracker.commit_frame(frame)
                else:
                    # rejected: the host tracker re-runs the frame from the
                    # same extracted features (src/Tracking.cc:1148-1163)
                    frame = self._fast.fallback_frame(frame_id)
                    self.tracker.track(frame)
        else:
            with self.profiler.timer("frontend"):
                sf = self.frontend(left, right)
            # one device-to-host transfer (the reference's undistortion of
            # the keypoints is not ported)
            frame = convert.frame_record(sf, frame_id)
            with self.profiler.timer("tracking"), self.map_lock:
                self.tracker.track(frame)
        self.timestamps.append(timestamp)
        self.frame_times.append(time.perf_counter() - t0)
        return frame

    # ------------------------------------------------------------------
    @property
    def tracking_state(self):
        return self.tracker.state

    def camera_trajectory(self):
        return self.tracker.camera_trajectory()

    def save_trajectory_kitti(self, path: str):
        """KITTI odometry format: 12 floats per row = top 3 rows of T_wc
        (reference System::SaveTrajectoryKITTI src/System.cc:346-408)."""
        write_trajectory_kitti(path, self.camera_trajectory())

    def wait_for_mapping(self):
        """Block until the async mapping queue is drained AND the in-flight
        task (if any) has finished; raise if the worker failed on a keyframe."""
        if self._mapping_thread is not None:
            self._mapping_queue.join()
        self._raise_mapping_errors()

    def _raise_mapping_errors(self):
        if self.mapping_errors:
            kf, first = self.mapping_errors[0]
            raise RuntimeError(
                f"async mapping failed on {len(self.mapping_errors)} keyframe(s), "
                f"the first on keyframe {kf}") from first

    def shutdown(self):
        if self._mapping_thread is not None:
            self._mapping_queue.join()
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
