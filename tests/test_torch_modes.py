"""SLOT modes 1-3 of the port's System against the JAX package's, on the CPU.

pointslot_torch's System (device="cpu") beside pointslot_tpu's (JAX on the
CPU), frame by frame, at the SLOT settings of tests/test_modes.py (its
object and tracking overrides) on its scene (seed 61, one object,
0.7 m/frame), at a reduced camera (512x256) with the camera BA caps cut to
8 keyframes / 1024 points and loop closing off, as in
tests/test_torch_object_system.py. The trained-detector case runs
tests/test_modes.py:108's scene as it is (1242x375, seed 205, 6 frames).

Cases:
- mode 1 with the true instance mask on every frame;
- mode 1 with ``dynaslam_mode=1`` and masks on frames 0 and 4 only, the
  ROI tracker carrying the regions in between;
- mode 2 from ``select_rois`` on frame 0 (the offline box);
- mode 3 with tests/test_modes.py's OracleDetector (boxes without ids),
  so that DeepSORT and the ReID network run for real;
- mode 3 with the bundled trained detector (width 8, input 320, conf 0.3).

Each case must give, on every frame, the same tracking state, the camera
translation within 5e-3 m (tests/test_torch_object_system.py:66), the same
object track ids and pose frames with translations within 1e-2 m, the
same DeepSORT ids and the same ROI-tracker boxes within 1e-3 px (mode 1 and
2: the tracker sees the same images); and tests/test_modes.py's own gates.
The JAX side runs its single-device branches (its mesh would take the
loop-closing engines, off here).
"""

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config
from pointslot_torch.datasets import synthetic
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 8
DYNA_MASK_FRAMES = (0, 4)
MAX_CAM_GAP_M = 5e-3
MAX_OBJ_GAP_M = 1e-2
MAX_BOX_GAP_PX = 1e-3
W8 = "pointslot_tpu/detect/weights/synthetic_yolo_w8.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, mode, camera=True, **fields):
    """tests/test_modes.py's _slot_cfg in either package, reduced."""
    extra = dict(camera=pkg.CameraConfig(**CAM)) if camera else {}
    return pkg.SystemConfig(
        slot_mode=mode,
        objects=pkg.ObjectConfig(init_min_features=10, init_min_map_points=8,
                                 min_tracked_points=8, track_min_features=10),
        tracking=pkg.TrackingConfig(min_init_stereo_features=350),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        loop=pkg.LoopConfig(enabled=False), **extra, **fields)


class OracleDetector:
    """tests/test_modes.py's stand-in for the network in mode 3: the true
    boxes without ids (DeepSORT assigns them)."""

    def __init__(self, rows):
        self.rows = rows
        self.frame = 0

    def run(self, img):
        out = []
        for r in self.rows[(self.rows[:, 0] == self.frame) & (self.rows[:, 1] >= 0)]:
            out.append({"bbox": r[5:9].copy(), "score": 0.9, "class_id": 2})
        self.frame += 1
        return out


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(n_frames=N, n_objects=1, seed=61, forward_speed=0.7,
                              camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    return sc, [renderer.render(i) for i in range(N)], synthetic.offline_detection_rows(sc)


@pytest.fixture(scope="module", autouse=True)
def single_device_reference():
    from pointslot_tpu.parallel import runtime as jruntime

    mp = pytest.MonkeyPatch()
    mp.setattr(jruntime, "default_mesh", lambda min_devices=2: None)
    yield
    mp.undo()


def _record(system, frames, rows, case):
    """Drive `system` over the frames; per frame (state, T_cw, {track id:
    (sorted pose frames, translation at this frame)}, DeepSORT ids, ROI
    boxes)."""
    ids = []
    if system.mot is not None:
        update = system.mot.update

        def recorded(dets, image=None):
            out = update(dets, image)
            ids.append(sorted(t["track_id"] for t in out))
            return out

        system.mot.update = recorded
    out = []
    for i, (left, right, inst) in enumerate(frames):
        mask = None
        if case == "mode1" or (case == "mode1_dyna" and i in DYNA_MASK_FRAMES):
            mask = inst
        if case == "mode2" and i == 0:
            r0 = rows[(rows[:, 0] == 0) & (rows[:, 1] >= 0)][0]
            system.select_rois(left, [tuple(r0[5:9])])
        frame = system.track_stereo(left, right, i * 0.1, i, instance_mask=mask)
        objs = {}
        if system._object_system is not None:
            for t in system._object_system.all_tracks:
                objs[t.track_id] = (sorted(t.poses_cf),
                                    t.poses_cf[i][:3, 3].copy() if i in t.poses_cf else None)
        boxes = ([t.bbox.copy() for t in system.roi_tracker.tracks if t.alive]
                 if system.roi_tracker is not None else [])
        valid_in_mask = None
        if mask is not None:
            xy = frame.xy[frame.valid]
            mv = inst[np.clip(np.round(xy[:, 1]).astype(int), 0, inst.shape[0] - 1),
                      np.clip(np.round(xy[:, 0]).astype(int), 0, inst.shape[1] - 1)]
            valid_in_mask = float((mv != 0).mean())
        out.append(dict(state=system.tracking_state, T_cw=np.array(frame.T_cw), objs=objs,
                        ids=ids[-1] if system.mot is not None else None, boxes=boxes,
                        in_mask=valid_in_mask))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for f, (g, w) in enumerate(zip(got, want)):
        assert g["state"] == w["state"], f
        cg = np.linalg.inv(g["T_cw"])[:3, 3]
        cw = np.linalg.inv(w["T_cw"])[:3, 3]
        assert np.abs(cg - cw).max() <= MAX_CAM_GAP_M, (f, np.abs(cg - cw).max())
        assert sorted(g["objs"]) == sorted(w["objs"]), f
        for tid, (frames_w, t_w) in w["objs"].items():
            frames_g, t_g = g["objs"][tid]
            assert frames_g == frames_w, (f, tid)
            if t_w is not None:
                assert np.abs(t_g - t_w).max() <= MAX_OBJ_GAP_M, (f, tid)
        assert g["ids"] == w["ids"], f
        assert len(g["boxes"]) == len(w["boxes"]), f
        for bg, bw in zip(g["boxes"], w["boxes"]):
            np.testing.assert_allclose(bg, bw, rtol=0, atol=MAX_BOX_GAP_PX)


def _run_both(case, frames, rows, jcfg, cfg, detector=None):
    ref = jsystem.System(jcfg)
    port = System(cfg, device="cpu")
    if detector is not None:
        ref.detector, port.detector = detector(), detector()
    return _record(port, frames, rows, case), _record(ref, frames, rows, case), port


@pytest.mark.parametrize("case", ["mode1", "mode1_dyna"])
def test_mode1_matches_reference(scene, case):
    _, frames, rows = scene
    fields = {"dynaslam_mode": 1} if case == "mode1_dyna" else {}
    got, want, port = _run_both(case, frames, rows,
                                _configs(jconfig, jconfig.SLOTMode.DYNAMIC_SLAM, **fields),
                                _configs(config, config.SLOTMode.DYNAMIC_SLAM, **fields))
    _assert_same(got, want)
    assert port.tracking_state == TrackingState.OK
    if case == "mode1_dyna":
        assert any(r["boxes"] for r in got), "the ROI tracker carried nothing"
    # tests/test_modes.py:62-66 on every frame that has a mask
    shares = [r["in_mask"] for r in got if r["in_mask"] is not None]
    assert shares and max(shares) < 0.02, shares


def test_mode2_matches_reference(scene):
    _, frames, rows = scene
    got, want, port = _run_both("mode2", frames, rows,
                                _configs(jconfig, jconfig.SLOTMode.MANUAL_TRACKING),
                                _configs(config, config.SLOTMode.MANUAL_TRACKING))
    _assert_same(got, want)
    objsys = port._object_system
    assert len(objsys.all_tracks) >= 1, "manual ROI produced no object track"
    best = max(objsys.all_tracks, key=lambda t: len(t.poses_cf))
    assert len(best.poses_cf) >= N // 2


def test_mode3_oracle_matches_reference(scene):
    _, frames, rows = scene
    got, want, port = _run_both("mode3", frames, rows,
                                _configs(jconfig, jconfig.SLOTMode.AUTONOMOUS_DRIVING),
                                _configs(config, config.SLOTMode.AUTONOMOUS_DRIVING),
                                detector=lambda: OracleDetector(rows))
    _assert_same(got, want)
    assert port.tracking_state == TrackingState.OK
    objsys = port._object_system
    assert len(objsys.all_tracks) >= 1, "online pipeline produced no track"
    assert max(len(t.poses_cf) for t in objsys.all_tracks) >= 3
    assert any(r["ids"] for r in got)


def test_mode3_trained_detector_matches_reference():
    """tests/test_modes.py:108-130: the trained width-8 detector, DeepSORT
    and the ReID network in the loop, on the scene as it is."""
    sc = synthetic.make_scene(n_frames=6, n_objects=2, seed=205, forward_speed=0.8)
    renderer = synthetic.SyntheticRenderer(sc)
    frames = [renderer.render(i) for i in range(6)]

    def cfg(pkg):
        c = _configs(pkg, pkg.SLOTMode.AUTONOMOUS_DRIVING, camera=False)
        return c.replace(detector=pkg.DetectorConfig(
            weights_path=W8, input_size=320, network_width=8, conf_threshold=0.3))

    got, want, port = _run_both("mode3", frames, None, cfg(jconfig), cfg(config))
    _assert_same(got, want)
    assert port.tracking_state == TrackingState.OK
    assert len(port._object_system.all_tracks) >= 1, "online network produced no SLOT track"
