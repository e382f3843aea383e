"""The mode-4 object path with offline flow and GMS, the port against the
JAX package on the CPU.

The scene and configuration of tests/test_torch_object_system.py (512x256,
8 frames of the two-object scene, seed 31, that file's object overrides,
loop closing off, camera BA caps 8 / 1024) with ``use_offline_flow`` and
``use_gms`` on. Each frame carries the forward flow to the next frame,
computed from the renderer's depth and the true camera and object motion
(tests/test_flow_tracking.py:144-172); the System hands the previous
frame's flow to the object system.

- The step test runs the port's ObjectSystem beside the JAX one inside the
  JAX System: at each frame it starts from a copy of the JAX state, is
  given the same features' frame, detections and flow, and processes the
  frame first. It must give the same tracks, keyframes and
  ``flow_tracked_frames``, and the frame's object poses within 1e-3 m (the
  step bound of tests/test_torch_object_system.py). The flow-guided
  takeovers and the GMS drops of each step are counted and must both occur.
  The step turns the port's PROFILER on for itself and restores its flag:
  a port System built earlier in the process (with ``runtime.profile``
  off) must not silence the counts. A replay of the busy steps after such
  a System counts what the run counted.
- The port's own System over the 8 frames meets tests/test_flow_tracking.py's
  gates (a track with flow_tracked_frames >= 3, object position RMSE under
  0.5 m) and keeps the JAX System's tracks.

Measured at about 70 s alone, on one torch thread; the JAX System's
compiles are a third of it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import objects as jobjects
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.slam import objects
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from pointslot_torch.utils.profiling import PROFILER

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 8
OBJECTS = dict(init_min_features=10, init_min_map_points=8, min_tracked_points=8,
               track_min_features=10, set_init_position_by_points=False,
               ba_min_covisible_kfs=2, use_offline_flow=True, use_gms=True)
MAX_STEP_GAP_M = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg):
    return pkg.SystemConfig(
        slot_mode=pkg.SLOTMode.OFFLINE,
        camera=pkg.CameraConfig(**CAM),
        objects=pkg.ObjectConfig(**OBJECTS),
        tracking=pkg.TrackingConfig(min_init_stereo_features=350),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        loop=pkg.LoopConfig(enabled=False),
        runtime=pkg.RuntimeConfig(profile=True),
    )


def gt_forward_flow(scene, renderer, i):
    """Dense forward flow frame i -> i+1 from the rendered depth and the
    true camera and object poses (tests/test_flow_tracking.py:144-172)."""
    left, right, inst, depth = renderer.render_with_depth(i)
    H, W = depth.shape
    cam = scene.camera
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    z = depth.astype(np.float64)
    valid = z < 1e8
    pc = np.stack([(us - cam.cx) * z / cam.fx, (vs - cam.cy) * z / cam.fy, z], -1)
    T_wc = scene.poses_world[i]
    T_cw_next = np.linalg.inv(scene.poses_world[i + 1])
    pw = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
    pw_next = pw.copy()
    for obj in scene.objects:
        m = inst == (obj.track_id + 1)
        if not m.any():
            continue
        T_rel = obj.poses_world[i + 1] @ np.linalg.inv(obj.poses_world[i])
        pw_next[m] = pw[m] @ T_rel[:3, :3].T + T_rel[:3, 3]
    pc2 = pw_next @ T_cw_next[:3, :3].T + T_cw_next[:3, 3]
    z2 = np.maximum(pc2[..., 2], 1e-6)
    flow = np.stack([cam.fx * pc2[..., 0] / z2 + cam.cx - us,
                     cam.fy * pc2[..., 1] / z2 + cam.cy - vs], -1).astype(np.float32)
    flow[~valid] = 0.0
    return flow


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(n_frames=N + 1, n_points=2500, n_objects=2, seed=31,
                              forward_speed=0.8, camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    rows = synthetic.offline_detection_rows(sc)
    frames = [renderer.render(i) + (gt_forward_flow(sc, renderer, i),) for i in range(N)]
    return sc, frames, rows


def _drive(system, scene, detection_cls):
    _, frames, rows = scene
    for i, (left, right, inst, flow) in enumerate(frames):
        fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
        dets = [detection_cls.from_row24(r, mask_value=int(r[1]) + 1) for r in fr]
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i,
                            detections=dets, instance_mask=inst, flow=flow)
    system.wait_for_mapping()
    return system


def _port_step(state, cfg, inputs):
    """One port process_frame from a copy of `state` (an ObjectSystem of
    either package), with the port's PROFILER on for the step and its flag
    restored after, so that the counters do not hang on which System the
    process built last; returns (port ObjectSystem, the step's counters)."""
    frame, left, right, detections, instance_mask, timestamp, flow = inputs
    port = convert.object_system_from_arrays(state, cfg, device="cpu")
    enabled = PROFILER.enabled
    PROFILER.enabled = True
    try:
        PROFILER.reset()
        port.process_frame(SimpleNamespace(T_cw=np.array(frame.T_cw)), left, right,
                           convert.copy_object_state(detections), instance_mask, timestamp,
                           flow=flow)
        counters = dict(PROFILER.counters)
    finally:
        PROFILER.enabled = enabled
    return port, counters


class _StepMirror:
    """The port's ObjectSystem from a copy of the JAX one's state, one
    process_frame per frame with the same inputs (flow included), before
    the JAX one; records (frame, port, JAX copy, port counters, had flow)
    and, for a replay, each frame's state before the step and its inputs."""

    def __init__(self, jobj):
        self.steps = []
        self.replays = []
        self.cfg = cfg = _configs(config)
        jprocess = jobj.process_frame

        def process_frame(frame, left, right, detections, instance_mask, timestamp, flow=None):
            inputs = (SimpleNamespace(T_cw=np.array(frame.T_cw)), left, right,
                      convert.copy_object_state(detections), instance_mask, timestamp, flow)
            before = convert.object_system_from_arrays(jobj, cfg, device="cpu")
            port, counters = _port_step(jobj, cfg, inputs)
            jprocess(frame, left, right, detections, instance_mask, timestamp, flow=flow)
            self.steps.append((frame.frame_id, port, convert.object_system_from_arrays(
                jobj, cfg, device="cpu"), counters, flow is not None))
            self.replays.append((before, inputs))

        jobj.process_frame = process_frame


@pytest.fixture(scope="module")
def runs(scene):
    ref = jsystem.System(_configs(jconfig))
    mirror = _StepMirror(ref._object_system)
    _drive(ref, scene, jobjects.Detection)
    port = _drive(System(_configs(config), device="cpu"), scene, objects.Detection)
    return port, ref, mirror


def test_flow_gms_step_from_reference_state(runs):
    """One process_frame of each package from the same state, every frame."""
    _, _, mirror = runs
    assert [f for f, *_ in mirror.steps] == list(range(N))
    assert [had_flow for *_, had_flow in mirror.steps] == [False] + [True] * (N - 1)
    for f, got, want, _, _ in mirror.steps:
        assert [t.track_id for t in got.all_tracks] == [t.track_id for t in want.all_tracks]
        for g, w in zip(got.all_tracks, want.all_tracks):
            assert sorted(g.poses_cf) == sorted(w.poses_cf), (f, g.track_id)
            assert len(g.keyframes) == len(w.keyframes), (f, g.track_id)
            assert g.flow_tracked_frames == w.flow_tracked_frames, (f, g.track_id)
            assert g.track_ok == w.track_ok and g.dynamic == w.dynamic, (f, g.track_id)
            if f in w.poses_cf:
                gap = np.abs(g.poses_cf[f][:3, 3] - w.poses_cf[f][:3, 3]).max()
                assert gap <= MAX_STEP_GAP_M, (f, g.track_id, gap)
        assert got.ba_calls == want.ba_calls
    takeovers = sum(c.get("obj_flow_takeovers", 0) for *_, c, _ in mirror.steps)
    dropped = sum(c.get("obj_gms_dropped", 0) for *_, c, _ in mirror.steps)
    assert takeovers >= 2 * 3 and dropped >= 1, (takeovers, dropped)


def test_port_flow_system_meets_flow_gates(scene, runs):
    """tests/test_flow_tracking.py:212-239's gates on the port's System."""
    sc = scene[0]
    port, ref, _ = runs
    assert port.tracking_state == TrackingState.OK
    objsys = port._object_system
    assert [t.track_id for t in objsys.all_tracks] == [
        t.track_id for t in ref._object_system.all_tracks]
    best = max(objsys.all_tracks, key=lambda t: t.flow_tracked_frames)
    assert best.flow_tracked_frames >= 3
    gt = {o.track_id: o for o in sc.objects}
    errs = [np.linalg.norm(T_wo[:3, 3] - gt[t.track_id].poses_world[f][:3, 3])
            for t in objsys.all_tracks for f, T_wo in t.poses_world.items()]
    assert errs and float(np.sqrt(np.mean(np.square(errs)))) < 0.5


def test_step_counters_do_not_hang_on_an_earlier_system(runs):
    """The mirror's counters after a port System built with profile=False
    (the order of tests/test_torch_object_system.py then this file in one
    process): the replayed steps count what they counted in the run."""
    _, _, mirror = runs
    System(_configs(config).replace(runtime=config.RuntimeConfig(profile=False)),
           device="cpu")
    assert not PROFILER.enabled
    busy = [k for k, (*_, c, _) in enumerate(mirror.steps)
            if c.get("obj_flow_takeovers", 0) or c.get("obj_gms_dropped", 0)]
    assert busy
    for k in busy[:2]:
        before, inputs = mirror.replays[k]
        _, counters = _port_step(before, mirror.cfg, inputs)
        want = mirror.steps[k][3]
        for name in ("obj_flow_takeovers", "obj_gms_dropped"):
            assert counters.get(name, 0) == want.get(name, 0), (k, name)
    assert not PROFILER.enabled
