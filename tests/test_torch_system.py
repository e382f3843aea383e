"""The mode-0 System of the port against the JAX package's, on the CPU.

pointslot_torch's CameraTracker + LocalMapper and its whole System
(device="cpu") against pointslot_tpu's (JAX on the CPU), at a reduced
camera (512x256) on 8 frames of tests/test_slam_e2e.py's scene (seed 21,
0.8 m/frame), with the BA caps cut to 8 keyframes / 1024 points in both
configurations and loop closing off in both.

Bounds and why:
- the same keyframes (by frame id): the keyframe policy is host logic over
  inlier counts, which agree;
- camera translations within 5e-3 m per frame: float32 pose and BA solves
  whose sums run in another order, compounded over the sequence;
- map point counts within 2 %: culling and fuse decisions sit on float
  thresholds (reprojection gates, chi2 gates) that a float32 ulp can flip
  for a point or two.
The tracker + mapper pair is fed the same FrameRecords (the port's CPU
frontend); the two Systems, with the host tracker and with the
device-resident fast path, each run their own frontend on the same images,
whose keypoints may differ at FAST-cell ties (tests/test_torch_fused.py).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import local_mapping as jlm
from pointslot_tpu.slam import map_state as jms
from pointslot_tpu.slam import system as jsystem
from pointslot_tpu.slam import tracking as jtracking
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.io.writers import read_trajectory_kitti
from pointslot_torch.ops.frontend import StereoFrame, StereoFrontend
from pointslot_torch.slam.fast_path import DeviceTrackingPath
from pointslot_torch.slam.local_mapping import LocalMapper
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import CameraTracker, FrameRecord, TrackingState

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 8
MAX_TRANS_GAP_M = 5e-3
MAX_POINT_COUNT_GAP = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores
    many times over. The port's CPU runs here take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, **runtime):
    """The same reduced configuration in either package."""
    return pkg.SystemConfig(
        camera=pkg.CameraConfig(**CAM),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        loop=pkg.LoopConfig(enabled=False),
        runtime=pkg.RuntimeConfig(**runtime),
    )


@pytest.fixture(scope="module")
def scene():
    cam = config.CameraConfig(**CAM)
    sc = synthetic.make_scene(n_frames=N, n_points=2500, n_objects=0, seed=21,
                              forward_speed=0.8, camera=cam)
    renderer = synthetic.SyntheticRenderer(sc)
    return sc, [renderer.render(i)[:2] for i in range(N)]


def _translations(traj):
    return {f: np.linalg.inv(T)[:3, 3] for f, T, _ in traj}


def _ate(sc, traj) -> float:
    errs = [np.linalg.norm(np.linalg.inv(T)[:3, 3] - sc.poses_world[f][:3, 3])
            for f, T, _ in traj]
    return float(np.sqrt(np.mean(np.square(errs))))


def _keyframe_ids(m):
    return sorted(int(m.kf_frame_id[k]) for k in m.keyframe_ids())


def _assert_same_run(got_map, got_traj, want_map, want_traj):
    assert _keyframe_ids(got_map) == _keyframe_ids(want_map)
    tg, tw = _translations(got_traj), _translations(want_traj)
    assert sorted(tg) == sorted(tw) == list(range(N))
    gap = max(float(np.abs(tg[f] - tw[f]).max()) for f in tw)
    assert gap <= MAX_TRANS_GAP_M, f"translation gap {gap:.3e} m"
    n_got, n_want = got_map.n_points(), want_map.n_points()
    assert abs(n_got - n_want) <= MAX_POINT_COUNT_GAP * n_want, (n_got, n_want)


def _wire(tracker, mapper, m):
    """What System does for the pair: mapping per keyframe, re-parenting of
    the trajectory when a keyframe is culled."""
    tracker.new_kf_callback = lambda kf: mapper.process_keyframe(kf)
    m.on_remove_keyframe = tracker.on_keyframe_removed


def test_tracker_and_mapper_match_reference(scene):
    """Both trackers and mappers, fed the same FrameRecords."""
    sc, frames = scene
    cfg, jcfg = _configs(config), _configs(jconfig)
    fe = StereoFrontend(CAM["height"], CAM["width"], CAM["fx"], CAM["bf"], device="cpu")
    records = [convert.frame_record(fe(l, r), i) for i, (l, r) in enumerate(frames)]

    m = MapState()
    tracker = CameraTracker(cfg, m, device="cpu")
    mapper = LocalMapper(cfg, m, device="cpu")
    _wire(tracker, mapper, m)
    jm = jms.MapState()
    jtracker = jtracking.CameraTracker(jcfg, jm)
    jmapper = jlm.LocalMapper(jcfg, jm)
    _wire(jtracker, jmapper, jm)
    for rec in records:
        fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(FrameRecord)}
        copy = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in fields.items()}
        tracker.track(FrameRecord(**fields))
        jtracker.track(jtracking.FrameRecord(**copy))
        assert tracker.state == jtracker.state == TrackingState.OK
    assert mapper.ba_calls == jmapper.ba_calls >= 1
    _assert_same_run(m, tracker.camera_trajectory(), jm, jtracker.camera_trajectory())
    assert _ate(sc, tracker.camera_trajectory()) < 0.02 * 0.8 * N


def _drive(system, frames):
    for i, (left, right) in enumerate(frames):
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    system.wait_for_mapping()
    return system


def _run(frames, **runtime):
    return _drive(System(_configs(config, **runtime), device="cpu"), frames)


@pytest.fixture(scope="module")
def systems(scene):
    """The two Systems on the same images (the JAX one once per module)."""
    _, frames = scene
    return _run(frames), _drive(jsystem.System(_configs(jconfig)), frames)


def test_system_matches_reference(scene, systems):
    sc, _ = scene
    port, ref = systems
    assert port.tracking_state == ref.tracking_state == TrackingState.OK
    assert not any(e.lost for e in port.tracker.trajectory)
    assert port.local_mapper.ba_calls == ref.local_mapper.ba_calls >= 1
    _assert_same_run(port.map, port.camera_trajectory(), ref.map, ref.camera_trajectory())
    assert _ate(sc, port.camera_trajectory()) < 0.02 * 0.8 * N


def test_system_trajectory_export(tmp_path, systems):
    """The KITTI writer of the port gives the reference's file format: one
    3x4 T_wc row per frame, the first at the identity."""
    port, ref = systems
    path, ref_path = tmp_path / "port.txt", tmp_path / "ref.txt"
    port.save_trajectory_kitti(str(path))
    ref.save_trajectory_kitti(str(ref_path))
    poses = read_trajectory_kitti(str(path))
    assert poses.shape == (N, 4, 4)
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    np.testing.assert_allclose(poses, read_trajectory_kitti(str(ref_path)), rtol=0,
                               atol=MAX_TRANS_GAP_M)
    stats = port.shutdown()
    assert stats["n_keyframes"] == port.map.n_keyframes() >= 2


class _Mirror:
    """Runs the port's DeviceTrackingPath beside the JAX one inside the JAX
    System: each refresh, fused-step frame and materialize of the JAX path
    is first done by the port's path, from a copy of the same map, tracker
    state and device pose/velocity chain, on the same images and under the
    same gate (mode 4's background mask; None in mode 0)."""

    def __init__(self, jpath, path):
        self.tables, self.frames, self.keyframes, self.gates = [], [], [], []
        jrefresh, jtrack, jmaterialize = jpath.refresh, jpath.track, jpath.materialize

        def refresh(m, ref_kf):
            path.refresh(convert.map_state_from_arrays(m), ref_kf)
            jrefresh(m, ref_kf)
            self.tables.append((path.table_pts, path._tables, jpath.table_pts, jpath._tables))

        def track(tracker, left, right, frame_id, gate=None):
            state = SimpleNamespace(
                map=convert.map_state_from_arrays(tracker.map), ref_kf=tracker.ref_kf,
                last_frame=SimpleNamespace(T_cw=np.array(tracker.last_frame.T_cw)),
                velocity=np.array(tracker.velocity), n_matches_inliers=None)
            path._T_dev, path._vel_dev = (
                None if v is None else torch.from_numpy(np.array(v))
                for v in (jpath._T_dev, jpath._vel_dev))
            self.gates.append(None if gate is None else np.array(gate))
            got = path.track(state, left, right, frame_id, gate=self.gates[-1])
            want = jtrack(tracker, left, right, frame_id, gate=gate)
            # keyframe creation binds new points into the frame later
            self.frames.append((got, state, want, SimpleNamespace(
                point_idx=None if want is None else want.point_idx.copy(),
                T_cw=None if want is None else np.array(want.T_cw),
                ref_kf=tracker.ref_kf, velocity=tracker.velocity,
                n_matches_inliers=tracker.n_matches_inliers,
                pt_visible=tracker.map.pt_visible.copy(),
                pt_found=tracker.map.pt_found.copy())))
            return want

        def materialize(frame):
            got = path.materialize(self.frames[-1][0])
            want = jmaterialize(frame)
            self.keyframes.append((got, want))
            return want

        jpath.refresh, jpath.track, jpath.materialize = refresh, track, materialize


@pytest.fixture(scope="module")
def fast_systems(scene):
    """The port's fast-path System, and the JAX one with the port's
    DeviceTrackingPath mirrored inside it (the JAX System once per module)."""
    _, frames = scene
    ref = jsystem.System(_configs(jconfig, device_resident_tracking=True))
    path = DeviceTrackingPath(_configs(config), StereoFrontend(
        CAM["height"], CAM["width"], CAM["fx"], CAM["bf"], device="cpu"))
    mirror = _Mirror(ref._fast, path)
    _drive(ref, frames)
    return _run(frames, device_resident_tracking=True), ref, mirror


def test_device_tracking_path_matches_reference(fast_systems):
    """DeviceTrackingPath of both packages from the same state, frame by
    frame. Bounds: the device tables equal exactly (the same host code on
    the same map); the same frames accepted; T_cw and the velocity within
    1e-4 (the fused step's bound in tests/test_torch_fused.py: float32 LM
    sums in another order); at most 0.5 % of the bindings differ and
    n_inliers within 2 (a keypoint at a FAST-cell tie, as there); the map's
    visibility counts and the re-elected reference keyframe equal.

    Whole fast-path Systems are not held to the host tracker's bounds
    against each other: the table's predicted octave is
    ceil(log(max_dist / dist) / log 1.2) with dist taken from the reference
    keyframe, and for that keyframe's own points the ratio is exactly
    1.2**level, so an ulp of a point's position (the two frontends' depths
    differ in the fourth decimal) moves the octave by one. On this scene
    that flips the octave of many table rows, and the JAX step itself,
    given the port's tables, lands on the port's pose, centimetres from its
    own."""
    _, ref, mirror = fast_systems
    assert len(mirror.tables) >= 2
    for pts, tables, jpts, jtables in mirror.tables:
        np.testing.assert_array_equal(pts, jpts)
        pos, desc, lvl, val = (t.numpy() for t in tables)
        jpos, jdesc, jlvl, jval = (np.asarray(t) for t in jtables)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(desc.view(np.uint32), jdesc)
        np.testing.assert_array_equal(lvl, jlvl)
        np.testing.assert_array_equal(val, jval)
    assert len(mirror.frames) == ref._fast_frames >= N // 2
    for got, state, want, after in mirror.frames:
        assert (got is None) == (want is None)
        if want is None:
            continue
        np.testing.assert_allclose(got.T_cw, want.T_cw, rtol=0, atol=1e-4)
        np.testing.assert_allclose(state.velocity, after.velocity, rtol=0, atol=1e-4)
        differ = int((got.point_idx != after.point_idx).sum())
        assert differ <= 0.005 * len(after.point_idx), differ
        assert abs(state.n_matches_inliers - after.n_matches_inliers) <= 2
        assert state.ref_kf == after.ref_kf
        np.testing.assert_array_equal(state.map.pt_visible, after.pt_visible)
        assert int(np.abs(state.map.pt_found - after.pt_found).sum()) <= differ
    assert len(mirror.keyframes) >= 1
    for got, want in mirror.keyframes:
        assert (got.xy != want.xy).any(axis=1).sum() <= 0.005 * len(want.xy)
        np.testing.assert_array_equal(got.level, want.level)


def test_fast_path_used_and_agrees_with_host_tracker(scene, systems, fast_systems):
    """tests/test_fast_path.py:36-60 for the port and for the JAX System on
    the same images: the fused step carries most frames, stays accurate and
    close to the host tracker."""
    sc, _ = scene
    fast, ref, _ = fast_systems
    for system, host in ((fast, systems[0]), (ref, systems[1])):
        traj = system.camera_trajectory()
        assert system._fast_frames >= N // 2, system._fast_frames
        assert len(traj) >= N - 2
        assert _ate(sc, traj) < 0.15
        tf, th = _translations(traj), _translations(host.camera_trajectory())
        common = set(tf) & set(th)
        assert len(common) >= N - 3
        assert np.median([np.linalg.norm(tf[f] - th[f]) for f in common]) < 0.1
    assert fast.shutdown()["n_keyframes"] >= 2
    for kf in fast.map.keyframe_ids():   # keyframes carry full features
        assert fast.map.kf_feat_valid[kf].sum() > 100
        assert (fast.map.kf_point_idx[kf] >= 0).sum() > 30


def test_async_mapping_tracks_ok(scene):
    sc, frames = scene
    system = _run(frames, async_mapping=True)
    assert system.mapping_errors == []
    assert system.tracking_state == TrackingState.OK
    assert system.local_mapper.ba_calls >= 1
    traj = system.camera_trajectory()
    stats = system.shutdown()
    assert system._mapping_thread is None
    assert stats["n_keyframes"] >= 2
    assert _ate(sc, traj) < 0.15


def test_async_mapping_failure_is_raised(scene):
    """A keyframe that the mapping worker fails on is raised by
    wait_for_mapping and shutdown, not only printed."""
    _, frames = scene
    system = System(_configs(config, async_mapping=True), device="cpu")

    def fail(kf, skip_ba=False):
        raise ValueError(f"mapping keyframe {kf}")

    system.local_mapper.process_keyframe = fail
    system.track_stereo(*frames[0], timestamp=0.0, frame_id=0)   # the first keyframe
    with pytest.raises(RuntimeError, match="async mapping failed on 1 keyframe") as err:
        system.wait_for_mapping()
    assert isinstance(err.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="async mapping failed"):
        system.shutdown()
    assert system._mapping_thread is None


def test_fast_path_probes_again_under_the_map_lock(scene):
    """A loop closure can land between the fast path's lock-free ready()
    probe and the map lock (it drops the velocity model); the System probes
    again under the lock and hands the frame to the host tracker."""
    _, frames = scene
    system = System(_configs(config, device_resident_tracking=True), device="cpu")
    answers = iter([True, False])
    probes = []

    def ready(tracker):
        probes.append(system.map_lock._is_owned())
        return next(answers)

    system._fast.ready = ready
    system.track_stereo(*frames[0], timestamp=0.0, frame_id=0)
    assert probes == [False, True]   # the second probe holds the lock
    assert system._fast_frames == 0
    assert system.tracking_state == TrackingState.OK   # the host tracker initialised
    system.shutdown()


# The ids are the ones these cases had while every option below raised;
# the options of ROADMAP items 10b, 13b and 14a-14d have since been ported
# and now build.
@pytest.mark.parametrize("change, item", [
    (dict(loop=config.LoopConfig(vocab_path="ORBvoc.txt")), "builds"),
    (dict(loop=config.LoopConfig(vocab_as_tree=True)), "builds"),
    (dict(slot_mode=config.SLOTMode.OFFLINE, objects=config.ObjectConfig(use_gms=True)),
     "builds"),
    (dict(slot_mode=config.SLOTMode.OFFLINE,
          objects=config.ObjectConfig(use_offline_flow=True)), "builds"),
    (dict(slot_mode=config.SLOTMode.MANUAL_TRACKING), "builds"),
    (dict(slot_mode=config.SLOTMode.DYNAMIC_SLAM), "builds"),
    (dict(camera=config.CameraConfig(**CAM, k1=0.01)), "builds"),
    (dict(runtime=config.RuntimeConfig(pipeline_stages=True)), "item 15"),
    (dict(slot_mode=config.SLOTMode.AUTONOMOUS_DRIVING), "builds"),
    (dict(slot_mode=config.SLOTMode.DYNAMIC_SLAM, dynaslam_mode=1), "builds"),
], ids=["change0-item 13b", "change1-item 13b", "change2-item 10b", "change3-item 10b",
        "change4-item 14", "change5-item 14", "change6-item 14", "change7-item 15",
        "change8-item 14d", "change9-item 14b"])
def test_unported_configurations_raise(change, item, tmp_path):
    """What the port does not run yet raises, naming its ROADMAP item,
    instead of running without it; what an item has since ported builds
    (a vocabulary file is written for the vocab_path case)."""
    cfg = _configs(config).replace(**change)
    if item != "builds":
        with pytest.raises(NotImplementedError, match=item):
            System(cfg, device="cpu")
        return
    if cfg.loop.vocab_path:
        from pointslot_torch.vocab.bow import save_orb_vocab_binary

        rng = np.random.default_rng(0)
        path = str(tmp_path / "voc.bin")
        save_orb_vocab_binary(path, np.zeros(16, np.int32),
                              rng.integers(0, 256, (16, 32), dtype=np.uint8),
                              np.ones(16, np.float32), np.ones(16, bool))
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, vocab_path=path))
    system = System(cfg, device="cpu")
    assert system.shutdown()["n_keyframes"] == 0


@pytest.mark.parametrize("slot_mode", [config.SLOTMode.SLAM, config.SLOTMode.OFFLINE])
def test_default_configuration_builds_with_loop_closing(slot_mode):
    """SystemConfig() (loop closing on, the default) builds on the CPU in
    modes 0 and 4, with a loop closer sharing the map lock and a
    relocalizer on the tracker."""
    from pointslot_torch.slam.loop_closing import LoopCloser, Relocalizer

    system = System(config.SystemConfig(slot_mode=slot_mode), device="cpu")
    assert isinstance(system.loop_closer, LoopCloser)
    assert isinstance(system.tracker.relocalizer, Relocalizer)
    assert system.loop_closer.map_lock is system.map_lock
    assert system.tracker.relocalizer.db is system.loop_closer.db
    assert system.shutdown()["n_keyframes"] == 0


def test_precomputed_frame_and_cuda_without_card_raise(scene):
    """A precomputed frame (StereoFrontend.batch's, as the runner's --dp
    hands it over; as device tensors, then as numpy arrays) stands in for
    the frontend, which then never runs, and gives the frame records and
    poses of a System that ran its own frontend. Without a card, the
    default device raises."""
    _, frames = scene
    system = System(_configs(config), device="cpu")
    own = System(_configs(config), device="cpu")
    sf = system.frontend.batch(np.stack([f[0] for f in frames[:2]]),
                               np.stack([f[1] for f in frames[:2]]))
    pre = [StereoFrame(*[x[i] for x in sf]) for i in range(2)]
    pre[1] = convert.to_numpy(pre[1])

    def frontend_ran(*args, **kwargs):
        raise AssertionError("the frontend ran on a precomputed frame")

    system.frontend = frontend_ran
    for i in range(2):
        got = system.track_stereo(*frames[i], 0.1 * i, i, precomputed=pre[i])
        want = own.track_stereo(*frames[i], 0.1 * i, i)
        for name in ("xy", "level", "desc", "angle", "depth", "u_right", "valid", "point_idx",
                     "T_cw"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    system.shutdown()
    own.shutdown()
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        System(_configs(config))
