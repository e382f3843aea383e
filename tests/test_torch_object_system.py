"""The mode-4 System of the port against the JAX package's, on the CPU.

pointslot_torch's System in SLOT mode 4 (offline detections, device="cpu")
beside pointslot_tpu's (JAX on the CPU) at a reduced camera (512x256) on
8 frames of tests/test_object_slot.py's two-object scene (seed 31,
0.8 m/frame), with that file's object overrides (lines 29-36: small-object
thresholds, the object origin at the offline centre), loop closing off,
the camera BA caps cut to 8 keyframes / 1024 points as in
tests/test_torch_system.py, and ba_min_covisible_kfs 2 (the default 8
would start the object BA only after 9 object keyframes, past 8 frames).

Bounds and why:
- the same camera keyframes and camera translations within 5e-3 m
  (tests/test_torch_system.py's bounds and reasons);
- the same track ids, the same set of (frame, track) poses, the same
  dynamic flags: host logic over inlier counts and reprojection medians,
  which agree;
- object translations within 1e-2 m and yaw within 1e-3 rad: float32 pose
  LMs and object BAs whose sums run in another order, on features that
  may differ at FAST-cell ties, compounded over the frames;
- object point counts within 5 %: culling and fuse decisions on float
  thresholds that an ulp can flip for a point or two of a few hundred.
The step test starts the port's ObjectSystem from a copy of the JAX one's
state at every frame of the JAX run and compares one process_frame: the
same tracks, keyframes and point counts, and the frame's object poses
within 1e-3 m (the fused step's object bound, tests/test_torch_fused.py).
The batched object mapping (process_object_tasks given two items: cull,
fuse, one batched BA, write-back) is held to the object bounds above:
keyframe translations within 1e-2 m, rotation entries within 1e-3, and
points within 1e-2 m except at most 1 % of them, none beyond 5e-2 m. An
object window (a few hundred points within metres of the object, seen
over a short baseline) is weakly held, and a point whose depth rests on
monocular rays slides along them at almost no cost. On the final windows
of this run the reference itself moves a keyframe by 1.9e-4 between its
single and its batched solve of the same problem; the two packages put
keyframes up to 2e-3 m apart and 2 of 312 points 1.2-1.7e-2 m apart.

Measured at about 110 s alone, on one torch thread of an 8-core Xeon
shared with other work; the JAX System's compiles are a third of it.
"""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import objects as jobjects
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.io.writers import read_trajectory_kitti
from pointslot_torch.slam import objects
from pointslot_torch.slam.object_system import heading_y
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 8
OBJECTS = dict(init_min_features=10, init_min_map_points=8, min_tracked_points=8,
               track_min_features=10, set_init_position_by_points=False,
               ba_min_covisible_kfs=2)
MAX_CAM_GAP_M = 5e-3
MAX_OBJ_GAP_M = 1e-2
MAX_YAW_GAP = 1e-3
MAX_POINT_COUNT_GAP = 0.05
MAX_STEP_GAP_M = 1e-3
MAX_SLIDING_POINTS, MAX_SLIDING_GAP_M = 0.01, 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, **runtime):
    """The same reduced mode-4 configuration in either package."""
    return pkg.SystemConfig(
        slot_mode=pkg.SLOTMode.OFFLINE,
        camera=pkg.CameraConfig(**CAM),
        objects=pkg.ObjectConfig(**OBJECTS),
        tracking=pkg.TrackingConfig(min_init_stereo_features=350),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        loop=pkg.LoopConfig(enabled=False),
        runtime=pkg.RuntimeConfig(**runtime),
    )


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(n_frames=N, n_points=2500, n_objects=2, seed=31,
                              forward_speed=0.8, camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    rows = synthetic.offline_detection_rows(sc)
    return sc, [renderer.render(i) for i in range(N)], rows


def _drive(system, scene, detection_cls):
    _, frames, rows = scene
    for i, (left, right, inst) in enumerate(frames):
        fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
        dets = [detection_cls.from_row24(r, mask_value=int(r[1]) + 1) for r in fr]
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i,
                            detections=dets, instance_mask=inst)
    system.wait_for_mapping()
    return system


class _StepMirror:
    """Runs the port's ObjectSystem beside the JAX one inside the JAX
    System: at each frame, a copy of the JAX ObjectSystem's state goes into
    a port ObjectSystem, which processes the frame first; then the JAX one
    does. Records (port, JAX) after each frame."""

    def __init__(self, jobj):
        self.steps = []
        cfg = _configs(config)
        jprocess = jobj.process_frame

        def process_frame(frame, left, right, detections, instance_mask, timestamp, flow=None):
            port = convert.object_system_from_arrays(jobj, cfg, device="cpu")
            port.process_frame(SimpleNamespace(T_cw=np.array(frame.T_cw)), left, right,
                               convert.copy_object_state(detections), instance_mask, timestamp)
            jprocess(frame, left, right, detections, instance_mask, timestamp, flow=flow)
            self.steps.append((frame.frame_id, port, convert.object_system_from_arrays(
                jobj, cfg, device="cpu")))

        jobj.process_frame = process_frame


@pytest.fixture(scope="module")
def systems(scene):
    """The port's sync System, and the JAX one with the step mirror inside
    (the JAX System once per module)."""
    ref = jsystem.System(_configs(jconfig))
    mirror = _StepMirror(ref._object_system)
    _drive(ref, scene, jobjects.Detection)
    return _drive(System(_configs(config), device="cpu"), scene, objects.Detection), ref, mirror


def _translations(traj):
    return {f: np.linalg.inv(T)[:3, 3] for f, T, _ in traj}


def _keyframe_ids(m):
    return sorted(int(m.kf_frame_id[k]) for k in m.keyframe_ids())


def _object_center_errors(sc, objsys):
    errs = []
    for track in objsys.all_tracks:
        gt = next(o for o in sc.objects if o.track_id == track.track_id)
        for f, T_co in track.poses_cf.items():
            gt_T_co = np.linalg.inv(sc.poses_world[f]) @ gt.poses_world[f]
            errs.append(np.linalg.norm(T_co[:3, 3] - gt_T_co[:3, 3]))
    return errs


def _assert_same_objects(got, want):
    """The object bounds of the module docstring."""
    assert [t.track_id for t in got.all_tracks] == [t.track_id for t in want.all_tracks]
    for g, w in zip(got.all_tracks, want.all_tracks):
        assert sorted(g.poses_cf) == sorted(w.poses_cf), g.track_id
        for f in w.poses_cf:
            gap = np.abs(g.poses_cf[f][:3, 3] - w.poses_cf[f][:3, 3]).max()
            assert gap <= MAX_OBJ_GAP_M, (g.track_id, f, gap)
            yaw = abs(heading_y(g.poses_cf[f][:3, :3]) - heading_y(w.poses_cf[f][:3, :3]))
            assert yaw <= MAX_YAW_GAP, (g.track_id, f, yaw)
        assert g.dynamic == w.dynamic, g.track_id
        assert abs(g.n_points() - w.n_points()) <= MAX_POINT_COUNT_GAP * w.n_points()


def test_object_system_matches_reference(scene, systems):
    sc = scene[0]
    port, ref, _ = systems
    assert port.tracking_state == ref.tracking_state == TrackingState.OK
    assert not any(e.lost for e in port.tracker.trajectory)
    assert _keyframe_ids(port.map) == _keyframe_ids(ref.map)
    tg, tw = _translations(port.camera_trajectory()), _translations(ref.camera_trajectory())
    assert sorted(tg) == sorted(tw) == list(range(N))
    gap = max(float(np.abs(tg[f] - tw[f]).max()) for f in tw)
    assert gap <= MAX_CAM_GAP_M, f"camera translation gap {gap:.3e} m"
    _assert_same_objects(port._object_system, ref._object_system)
    assert port._object_system.ba_calls == ref._object_system.ba_calls >= 1
    # tests/test_object_slot.py's accuracy bars
    assert len(port._object_system.all_tracks) == 2
    assert float(np.median(_object_center_errors(sc, port._object_system))) < 0.5
    assert any(t.dynamic for t in port._object_system.all_tracks if len(t.poses_cf) >= 6)


def test_object_step_from_reference_state(systems):
    """One process_frame of each package from the same state, every frame."""
    _, _, mirror = systems
    assert [f for f, _, _ in mirror.steps] == list(range(N))
    for f, got, want in mirror.steps:
        assert [t.track_id for t in got.all_tracks] == [t.track_id for t in want.all_tracks]
        for g, w in zip(got.all_tracks, want.all_tracks):
            assert sorted(g.poses_cf) == sorted(w.poses_cf), (f, g.track_id)
            assert len(g.keyframes) == len(w.keyframes), (f, g.track_id)
            assert g.track_ok == w.track_ok and g.dynamic == w.dynamic, (f, g.track_id)
            assert abs(g.n_points() - w.n_points()) <= MAX_POINT_COUNT_GAP * w.n_points()
            if f in w.poses_cf:
                gap = np.abs(g.poses_cf[f][:3, 3] - w.poses_cf[f][:3, 3]).max()
                assert gap <= MAX_STEP_GAP_M, (f, g.track_id, gap)
        assert got.ba_calls == want.ba_calls


def test_batched_object_mapping_matches_reference(systems):
    """process_object_tasks given two items, one per track, from the same
    state: the port's bundle_adjust_batched against the reference's vmap,
    with the same write-back."""
    _, ref, _ = systems
    jobj = ref._object_system
    saved = jobj.tracks, jobj.all_tracks, jobj.ba_calls
    twins = copy.deepcopy(jobj.all_tracks)
    port = convert.object_system_from_arrays(jobj, _configs(config), device="cpu")
    try:
        jobj.all_tracks = twins
        jobj.tracks = {t.track_id: t for t in twins}
        items = [(t.track_id, t.detections[max(t.detections)]) for t in twins]
        assert len(items) == 2
        jobj.process_object_tasks(items)
        port.process_object_tasks([(i, convert.copy_object_state(d)) for i, d in items])
        assert port.ba_calls - saved[2] == jobj.ba_calls - saved[2] == 2
        for g, w in zip(port.all_tracks, twins):
            assert len(g.keyframes) == len(w.keyframes)
            for gk, wk in zip(g.keyframes, w.keyframes):
                np.testing.assert_allclose(gk.T_co[:3, 3], wk.T_co[:3, 3], rtol=0,
                                           atol=MAX_OBJ_GAP_M)
                np.testing.assert_allclose(gk.T_co[:3, :3], wk.T_co[:3, :3], rtol=0,
                                           atol=MAX_YAW_GAP)
            np.testing.assert_array_equal(g.pt_valid, w.pt_valid)
            gap = np.abs(g.pt_pos[w.pt_valid] - w.pt_pos[w.pt_valid]).max(axis=1)
            assert (gap > MAX_OBJ_GAP_M).sum() <= MAX_SLIDING_POINTS * len(gap), gap.max()
            assert gap.max() <= MAX_SLIDING_GAP_M, gap.max()
    finally:
        jobj.tracks, jobj.all_tracks, jobj.ba_calls = saved


def test_object_savers_match_reference(tmp_path, scene, systems):
    """The three object savers of both Systems (the file checks of
    tests/test_object_slot.py:98-109, then the values)."""
    port, ref, _ = systems
    for name, system in (("port", port), ("ref", ref)):
        system.save_object_detections_kitti(str(tmp_path / name / "det"))
        system.save_object_poses_camera_frame(str(tmp_path / f"{name}_cf.txt"))
        system.save_trajectory_camera_and_objects(str(tmp_path / f"{name}_cam.txt"))
    files = sorted((tmp_path / "port" / "det").glob("*.txt"))
    ref_files = sorted((tmp_path / "ref" / "det").glob("*.txt"))
    assert [f.name for f in files] == [f.name for f in ref_files] and len(files) == N
    nonempty = [f for f in files if f.read_text().strip()]
    assert len(nonempty) >= N // 2
    for f, rf in zip(files, ref_files):
        got, want = f.read_text().split("\n"), rf.read_text().split("\n")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if not w:
                continue
            g, w = g.split(), w.split()
            assert g[0] == w[0] == "Car" and len(g) == len(w) == 16
            np.testing.assert_allclose(np.float64(g[1:]), np.float64(w[1:]), rtol=0,
                                       atol=MAX_OBJ_GAP_M)
    rows = np.loadtxt(tmp_path / "port_cf.txt")
    ref_rows = np.loadtxt(tmp_path / "ref_cf.txt")
    np.testing.assert_array_equal(rows[:, :2], ref_rows[:, :2])
    np.testing.assert_allclose(rows[:, 2:], ref_rows[:, 2:], rtol=0, atol=MAX_OBJ_GAP_M)
    np.testing.assert_allclose(read_trajectory_kitti(str(tmp_path / "port_cam.txt")),
                               read_trajectory_kitti(str(tmp_path / "ref_cam.txt")),
                               rtol=0, atol=MAX_CAM_GAP_M)
    for t in port._object_system.all_tracks:
        path = f"_object_{t.track_id}.txt"
        assert os.path.exists(tmp_path / f"port_cam{path}")
        np.testing.assert_allclose(read_trajectory_kitti(str(tmp_path / f"port_cam{path}")),
                                   read_trajectory_kitti(str(tmp_path / f"ref_cam{path}")),
                                   rtol=0, atol=MAX_OBJ_GAP_M)


def test_async_object_mapping_tracks_ok(scene, systems):
    """The async worker takes the object keyframes and batches them; the
    run stays accurate and close to the sync one."""
    sc = scene[0]
    sync = systems[0]
    system = _drive(System(_configs(config, async_mapping=True), device="cpu"), scene,
                    objects.Detection)
    assert system.mapping_errors == []
    assert system.tracking_state == TrackingState.OK
    objsys = system._object_system
    assert [t.track_id for t in objsys.all_tracks] == [
        t.track_id for t in sync._object_system.all_tracks]
    assert objsys.ba_calls >= 1 and objsys.ba_threads == {system._mapping_thread.ident}
    errs = _object_center_errors(sc, objsys)
    assert float(np.median(errs)) < 0.5
    assert float(np.median(errs)) <= 1.5 * float(
        np.median(_object_center_errors(sc, sync._object_system))) + 0.05
    system.shutdown()
    assert system._mapping_thread is None


def test_mode4_system_on_cuda_without_card_raises():
    """The entry point defaults to the card and does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        System(config.SystemConfig(slot_mode=config.SLOTMode.OFFLINE,
                                   loop=config.LoopConfig(enabled=False)))
