"""Loop closing and relocalization of the port's System against the JAX
package's, on the CPU.

The JAX System runs with loop closing on a small loop scene at 512x256
(``make_loop_scene(n_frames=32, seed=41, radius=5.0)``, its first 33
frames: the camera is back at its start at frame 32), with the global BA
inline (``background_gba=False``) and the detection policy cut to the
scene (candidates 10 frames old, detection from 6 keyframes), the same
configuration in both packages, and on the JAX package's single-device
branches (the session's 8 virtual CPU devices would send its essential
graph and global BA to the mesh engines, which the port leaves to ROADMAP
item 15). Its LoopCloser's ``on_keyframe`` is
wrapped: at every keyframe the port's LoopCloser runs first from a copy of
the map and the loop state (``convert.copy_loop_state``), with JAX's own
RANSAC draws, and both record what they did.

Bounds and why:
- the loop decision, the candidate and the consistent groups: exact (host
  logic over the same database; the new keyframe's word ids are exact);
- T_lc within 1e-4 (the rigid RANSAC with equal inlier sets, then four
  float32 IRLS Horn solves; tests/test_torch_loop.py);
- the essential graph's poses within 1e-4: 20 float32 Gauss-Newton steps
  summed in another order (tests/test_torch_loop.py's pose-graph bound);
- the points moved with their keyframes within 1e-3 m + 1e-4 relative
  (tests/test_torch_mapping.py's BA bound: a 1e-4 rotation gap moves a
  point 20 m away by 2e-3 m);
- the fused bindings (keyframe feature -> map point, the valid points):
  equal;
- the global BA: the port's solver on the reference's own snapshot, the
  same inlier sets and cost statistics within 1e-3 relative; each pose
  within 1e-3 m + 1e-4 relative or, where the reference's own float32 pose
  lies further than that from the float64 solve of the same problem,
  within twice that distance; the depth-observed points at least as close
  to the float64 solve as the reference's (median, 99th percentile,
  largest; a point seen only monocularly slides along its ray at almost
  no cost and is not held). The GBA fixes one keyframe and its 15 LM
  iterations stop in a shallow valley: on this scene every free pose of
  JAX's solve lies 6-9e-3 from the float64 optimum (the port's 2.6e-3),
  its points a median 8.2e-3 (the port's 2.7e-3), at costs within 1e-5
  relative. The port's GBA from its own corrected map, and the map's
  poses after the event, are held to the same pose bound.
The port's own System on the same images closes the loop, with an ATE at
most 10 % above the JAX run's. Its relocalization after a blackout
follows tests/test_loop_closing.py:46.
"""

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.parallel import runtime as jruntime
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.slam.loop_closing import LoopCloser, gba_pregate
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from pointslot_torch.solvers import local_ba
from pointslot_torch.vocab.bow import train_default_vocab
from test_torch_loop import jax_draws

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N_FRAMES = 33
MAX_POSE_GAP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, **loop):
    """The same reduced configuration in either package."""
    return pkg.SystemConfig(
        camera=pkg.CameraConfig(**CAM),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        tracking=pkg.TrackingConfig(min_init_stereo_features=300),
        loop=pkg.LoopConfig(**{**dict(background_gba=False, min_frame_distance=10,
                                      min_kfs_before_detect=6), **loop}),
    )


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_loop_scene(n_frames=32, seed=41, radius=5.0,
                                   camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    return sc, [renderer.render(i)[:2] for i in range(N_FRAMES)]


def _ate(sc, traj) -> float:
    """Translation RMSE, the estimate's world anchored at its first frame
    (tests/test_loop_closing.py:29)."""
    A = sc.poses_world[traj[0][0]]
    errs = [np.linalg.norm((A @ np.linalg.inv(T))[:3, 3] - sc.poses_world[f][:3, 3])
            for f, T, _ in traj]
    return float(np.sqrt(np.mean(np.square(errs))))


_RECORDED = ("_detect_loop", "_geometric_verification", "_optimize_essential_graph",
             "_gba_snapshot", "_gba_solve")


def _record(closer, log: dict):
    """Wrap the closer's steps so that each call's result lands in `log`."""
    for name in _RECORDED:
        fn = getattr(closer, name)

        def wrapped(*args, _fn=fn, _name=name):
            if _name == "_gba_snapshot":   # the map after correction and fuse
                m = closer.map
                log["pre_gba"] = (m.kf_pose.copy(), m.pt_pos.copy(), m.pt_valid.copy(),
                                  m.kf_point_idx.copy())
            out = _fn(*args)
            log[_name] = out
            if _name == "_detect_loop":
                log["groups"] = [(sorted(g), c) for g, c in closer._consistent_groups]
            return out

        setattr(closer, name, wrapped)


class _LoopMirror:
    """Runs the port's LoopCloser beside the JAX one inside the JAX System:
    at every keyframe, the port's closer is built on a copy of the map and
    the loop state, takes JAX's draws and handles the keyframe first."""

    def __init__(self, ref):
        self.events = []
        jlc = ref.loop_closer
        cfg = _configs(config)
        vocab = train_default_vocab(device="cpu")
        self.jlog = {}
        _record(jlc, self.jlog)
        orig = jlc.on_keyframe

        def on_keyframe(kf):
            port = LoopCloser(cfg, convert.map_state_from_arrays(jlc.map), vocab, device="cpu")
            convert.copy_loop_state(jlc, port)
            port.draw_index_sets = jax_draws
            log = {}
            _record(port, log)
            got = port.on_keyframe(kf)
            self.jlog.clear()
            want = orig(kf)
            self.events.append(dict(kf=kf, got=got, want=want, port=port, log=log,
                                    jlog=dict(self.jlog), jmap=convert.map_state_from_arrays(
                                        jlc.map) if want else None,
                                    jstats=jlc.last_gba_stats))
            return want

        jlc.on_keyframe = on_keyframe


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX System over the scene with the port's LoopCloser mirrored."""
    sc, frames = scene
    ref = jsystem.System(_configs(jconfig))
    mirror = _LoopMirror(ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "default_mesh", lambda min_devices=2: None)
        for i, (left, right) in enumerate(frames):
            ref.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    return ref, mirror


def _loop_events(mirror):
    return [e for e in mirror.events if e["want"]]


def test_loop_detection_matches_reference(jax_run):
    ref, mirror = jax_run
    assert ref.tracker.state == TrackingState.OK
    assert ref.loop_closer.loops_closed >= 1
    assert len(mirror.events) >= 20
    for e in mirror.events:
        assert e["got"] == e["want"], e["kf"]
        assert ("_detect_loop" in e["log"]) == ("_detect_loop" in e["jlog"])
        if "_detect_loop" in e["jlog"]:
            assert e["log"]["_detect_loop"] == e["jlog"]["_detect_loop"], e["kf"]
            assert e["log"]["groups"] == e["jlog"]["groups"], e["kf"]


def _points_close(got, want):
    return np.abs(got - want) <= 1e-3 + 1e-4 * np.abs(want)


def test_loop_correction_matches_reference(jax_run):
    """The first loop event's T_lc, essential graph, moved points and fused
    bindings."""
    _, mirror = jax_run
    e = _loop_events(mirror)[0]
    log, jlog = e["log"], e["jlog"]
    ok, T_lc = log["_geometric_verification"]
    jok, jT_lc = jlog["_geometric_verification"]
    assert ok and jok
    np.testing.assert_allclose(T_lc, jT_lc, rtol=0, atol=MAX_POSE_GAP)
    np.testing.assert_allclose(log["_optimize_essential_graph"],
                               jlog["_optimize_essential_graph"], rtol=0, atol=MAX_POSE_GAP)
    # the map after the correction and the fuse, before the GBA
    pose, pos, valid, bind = log["pre_gba"]
    jpose, jpos, jvalid, jbind = jlog["pre_gba"]
    np.testing.assert_allclose(pose, jpose, rtol=0, atol=MAX_POSE_GAP)
    np.testing.assert_array_equal(bind, jbind)
    np.testing.assert_array_equal(valid, jvalid)
    moved = _points_close(pos[valid], jpos[jvalid])
    assert moved.all(), int((~moved.all(axis=1)).sum())
    assert e["port"].loops_closed == 1


def _port_snapshot(jsnap):
    """The reference's GBA snapshot with its problem in the port's layout
    (real point rows: the reference pads them to a power of two)."""
    prob = jsnap["prob"]
    L = len(jsnap["pts"])
    fields = {}
    for name in local_ba.BAProblem._fields:
        a = np.asarray(getattr(prob, name))
        if name in ("points", "point_valid", "obs_pose", "obs_uvr", "obs_stereo",
                    "obs_inv_sigma2", "obs_valid"):
            a = a[:L]
        fields[name] = convert.to_tensor(a, None, "cpu")
    return dict(jsnap, prob=local_ba.BAProblem(**fields))


def _derived_bound(want, exact):
    """The BA bound of tests/test_torch_mapping.py, 1e-3 m + 1e-4 relative,
    or, where the reference's own float32 solve lies further than that from
    the float64 solve of the same problem, twice that distance; per pose or
    point (its largest element), broadcast back over its elements."""
    axes = tuple(range(1, want.ndim))
    own = np.abs(want - exact).max(axis=axes, keepdims=True)
    return np.maximum(1e-3 + 1e-4 * np.abs(want), 2.0 * own)


def test_global_ba_matches_reference(jax_run):
    """The GBA of the first loop event: the port's solve of the reference's
    own snapshot, and the port's whole GBA from its own corrected map."""
    _, mirror = jax_run
    e = _loop_events(mirror)[0]
    jsnap = e["jlog"]["_gba_snapshot"]
    jres, jstats = e["jlog"]["_gba_solve"]
    L = len(jsnap["pts"])
    snap = _port_snapshot(jsnap)
    cam = e["port"]._cam_args
    res, stats = e["port"]._gba_solve(snap)
    want_poses = np.asarray(jres.poses)
    want_pts = np.asarray(jres.points)[:L]
    prob = gba_pregate(snap["prob"], cam)
    exact = local_ba.bundle_adjust(local_ba.BAProblem(
        *(x.double() if x.is_floating_point() else x for x in prob)), **cam)
    pose_bound = _derived_bound(want_poses, exact.poses.numpy())
    assert (np.abs(res.poses - want_poses) <= pose_bound).all()
    # the depth-observed points: as close to the float64 optimum as the
    # reference's are, at the median, the 99th percentile and the largest
    stereo_in = (res.obs_inlier & prob.obs_stereo.numpy()).any(axis=1)
    got_err = np.abs(res.points - exact.points.numpy()).max(axis=1)[stereo_in]
    want_err = np.abs(want_pts - exact.points.numpy()).max(axis=1)[stereo_in]
    for q in (50, 99, 100):
        assert np.percentile(got_err, q) <= max(1e-3, np.percentile(want_err, q)), q
    np.testing.assert_array_equal(res.obs_inlier, np.asarray(jres.obs_inlier)[:L])
    assert stats["n_obs"] == jstats["n_obs"] and stats["n_kfs"] == jstats["n_kfs"]
    for key in ("cost_before", "cost_after"):
        assert stats[key] == pytest.approx(jstats[key], rel=1e-3)
    assert stats["cost_after"] < stats["cost_before"]
    # the port's own GBA, after its own correction and fuse
    own, own_stats = e["log"]["_gba_solve"]
    assert own_stats["n_kfs"] == jstats["n_kfs"] and own_stats["n_points"] == jstats["n_points"]
    assert (np.abs(own.poses - want_poses) <= pose_bound).all()
    # and the map after the event: keyframe poses as the GBA left them
    m, jm = e["port"].map, e["jmap"]
    kfs = jm.keyframe_ids()
    gap = np.abs(m.kf_pose[kfs] - jm.kf_pose[kfs]).max()
    assert gap <= pose_bound.max(), (gap, pose_bound.max())


@pytest.fixture(scope="module")
def port_run(scene):
    _, frames = scene
    system = System(_configs(config), device="cpu")
    for i, (left, right) in enumerate(frames):
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    system.shutdown()
    return system


def test_port_system_closes_the_loop(scene, jax_run, port_run):
    sc, _ = scene
    ref, _ = jax_run
    system = port_run
    assert system.tracking_state == TrackingState.OK
    assert system.loop_closer.loops_closed >= 1
    assert not any(e.lost for e in system.tracker.trajectory)
    stats = system.loop_closer.last_gba_stats
    assert stats is not None and stats["cost_after"] < stats["cost_before"]
    want = _ate(sc, ref.camera_trajectory())
    got = _ate(sc, system.camera_trajectory())
    assert got <= 1.1 * want, (got, want)


def test_relocalization_after_blackout():
    """tests/test_loop_closing.py:46 at 512x256 on the port's System, with
    the reference's draws for the revisit frame (frame id 13). The outcome
    of one revisit frame is the draw's: on this map the 128 six-point DLT
    hypotheses leave the PnP pose over 0.3 m off for 64 % of the port's
    seeds and 57 % of JAX's (200 seeds each, measured on the CPU), and the
    port's own seed-13 draw has no all-inlier set (best hypothesis 28
    inliers, 0.66 m off after local-map tracking)."""
    cam = config.CameraConfig(**CAM)
    sc = synthetic.make_scene(n_frames=10, n_points=2500, n_objects=0, seed=43,
                              forward_speed=0.6, camera=cam)
    renderer = synthetic.SyntheticRenderer(sc)
    system = System(config.SystemConfig(camera=cam), device="cpu")
    system.tracker.relocalizer.draw_index_sets = jax_draws
    rendered = [renderer.render(i)[:2] for i in range(10)]
    for i, (left, right) in enumerate(rendered):
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    assert system.tracking_state == TrackingState.OK
    pose_at_5 = next(T for f, T, _ in system.camera_trajectory() if f == 5)
    black = np.zeros_like(rendered[0][0])
    for j in range(3):
        system.track_stereo(black, black, timestamp=1.0 + j * 0.1, frame_id=10 + j)
    assert system.tracking_state == TrackingState.LOST
    frame = system.track_stereo(*rendered[5], timestamp=1.4, frame_id=13)
    assert system.tracking_state == TrackingState.OK, "relocalization failed"
    err = np.linalg.norm(frame.T_cw[:3, 3] - pose_at_5[:3, 3])
    assert err < 0.3, f"relocalized pose error {err:.3f} m"
    system.shutdown()


def test_background_gba_failure_is_raised():
    """A global BA that fails on its thread is raised by wait_for_gba and by
    shutdown, not only printed."""
    system = System(_configs(config, background_gba=True), device="cpu")
    lc = system.loop_closer

    def fail(snap):
        raise ValueError("gba solve")

    lc._gba_snapshot = lambda fixed_kf: {}
    lc._gba_solve = fail
    lc._launch_global_ba(0)
    with pytest.raises(RuntimeError, match="global BA failed 1 time") as err:
        lc.wait_for_gba(timeout=60)
    assert isinstance(err.value.__cause__, ValueError)
    assert not lc.gba_running
    with pytest.raises(RuntimeError, match="global BA failed"):
        system.shutdown()
