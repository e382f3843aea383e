"""Checkpoint and resume across the two packages, on the CPU.

tests/test_aux.py:50's setup at 512x256: SLOT mode 4 on 6 frames of a
one-object scene (seed 71, 0.7 m/frame) with that test's object and
tracking overrides and loop closing off, run by the port's System and by
the JAX System. Each package saves a checkpoint; each loads the other's
file into a fresh System, and the restored tables equal the saving
System's exactly (map, trajectory, object tracks with their keyframes):
the npz keys are the reference's, key for key. The port then resumes
tracking from the JAX package's file with state OK (the saved last pose
seeds the first resumed frame, where the reference starts from the
reference keyframe's pose). Loading into a System
with the fast path, async mapping and loop closing leaves nothing stale:
the fast path's tables are rebuilt from the restored map, the loop
closer's database holds the restored keyframes and its global BA epoch
has moved, the pending object-keyframe counts are empty.

About 45 s alone, on one torch thread.
"""

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import checkpoint as jcheckpoint
from pointslot_tpu.slam import objects as jobjects
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config
from pointslot_torch.datasets import synthetic
from pointslot_torch.slam import checkpoint, objects
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 6
MAP_FIELDS = checkpoint._MAP_FIELDS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, loop=False, **runtime):
    return pkg.SystemConfig(
        slot_mode=pkg.SLOTMode.OFFLINE,
        camera=pkg.CameraConfig(**CAM),
        objects=pkg.ObjectConfig(init_min_features=10, init_min_map_points=8,
                                 min_tracked_points=8, track_min_features=10),
        tracking=pkg.TrackingConfig(min_init_stereo_features=350),
        loop=pkg.LoopConfig(enabled=loop),
        runtime=pkg.RuntimeConfig(**runtime),
    )


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(n_frames=N + 2, n_objects=1, seed=71, forward_speed=0.7,
                              camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    rows = synthetic.offline_detection_rows(sc)
    return sc, [renderer.render(i) for i in range(N + 2)], rows


def _track(system, scene, i, detection_cls):
    _, frames, rows = scene
    left, right, inst = frames[i]
    fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
    dets = [detection_cls.from_row24(r, mask_value=int(r[1]) + 1) for r in fr]
    system.track_stereo(left, right, i * 0.1, i, detections=dets, instance_mask=inst)


@pytest.fixture(scope="module")
def saved(scene, tmp_path_factory):
    """Both packages' Systems after N frames, and the file each saved."""
    d = tmp_path_factory.mktemp("ckpt")
    ref = jsystem.System(_configs(jconfig))
    port = System(_configs(config), device="cpu")
    for i in range(N):
        _track(ref, scene, i, jobjects.Detection)
        _track(port, scene, i, objects.Detection)
    jcheckpoint.save_checkpoint(str(d / "jax.npz"), ref)
    checkpoint.save_checkpoint(str(d / "port.npz"), port)
    return ref, port, str(d / "jax.npz"), str(d / "port.npz")


def _assert_restored(got, want):
    """`got` restored from `want`'s file: the same tables exactly."""
    for f in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(got.map, f), getattr(want.map, f), err_msg=f)
    assert got.map._next_uid == want.map._next_uid
    assert got.map.n_keyframes() == want.map.n_keyframes() >= 2
    assert (got.tracker.state, got.tracker.ref_kf, got.tracker.last_kf_frame_id) == (
        want.tracker.state, want.tracker.ref_kf, want.tracker.last_kf_frame_id)
    t1, t2 = want.camera_trajectory(), got.camera_trajectory()
    assert [f for f, _, _ in t1] == [f for f, _, _ in t2] == list(range(N))
    for (_, T1, l1), (_, T2, l2) in zip(t1, t2):
        np.testing.assert_array_equal(T1, T2)
        assert l1 == l2
    a, b = want._object_system.all_tracks, got._object_system.all_tracks
    assert [t.track_id for t in a] == [t.track_id for t in b] and len(a) >= 1
    for ta, tb in zip(a, b):
        for name in checkpoint._TRACK_SCALARS:
            assert getattr(ta, name) == getattr(tb, name), name
        for name in checkpoint._TRACK_ARRAYS:
            np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name), err_msg=name)
        assert sorted(ta.poses_cf) == sorted(tb.poses_cf)
        for f in ta.poses_cf:
            np.testing.assert_array_equal(ta.poses_cf[f], tb.poses_cf[f])
            np.testing.assert_array_equal(ta.poses_world[f], tb.poses_world[f])
        assert len(ta.keyframes) == len(tb.keyframes) >= 1
        for ka, kb in zip(ta.keyframes, tb.keyframes):
            assert ka.frame_id == kb.frame_id
            for name in checkpoint._OKF_ARRAYS:
                np.testing.assert_array_equal(getattr(ka, name), getattr(kb, name), err_msg=name)
        assert tb.track_id in got._object_system.tracks


def test_files_have_the_same_keys(saved):
    _, _, jpath, ppath = saved
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].ndim == p[k].ndim, k


def test_port_loads_the_reference_file(saved):
    ref, _, jpath, _ = saved
    system = System(_configs(config), device="cpu")
    checkpoint.load_checkpoint(jpath, system)
    _assert_restored(system, ref)


def test_reference_loads_the_port_file(saved):
    _, port, _, ppath = saved
    system = jsystem.System(_configs(jconfig))
    jcheckpoint.load_checkpoint(ppath, system)
    _assert_restored(system, port)


def test_port_round_trip(saved):
    _, port, _, ppath = saved
    system = System(_configs(config), device="cpu")
    checkpoint.load_checkpoint(ppath, system)
    _assert_restored(system, port)


def test_port_resumes_from_the_reference_file(scene, saved):
    """Frames N and N + 1 tracked after loading JAX's file: state OK, no
    lost frame, the trajectory continued with errors of the saved run's
    size; the first resumed frame went through reference-keyframe tracking
    (no velocity model on load), seeded from the saved pose of the last
    frame, which comes back without features."""
    sc = scene[0]
    _, _, jpath, _ = saved
    system = System(_configs(config), device="cpu")
    checkpoint.load_checkpoint(jpath, system)
    last = system.tracker.last_frame
    assert system.tracker.velocity is None and len(last.xy) == 0
    with np.load(jpath) as z:
        np.testing.assert_array_equal(last.T_cw, z["tracker/last_T_cw"])
    for i in (N, N + 1):
        _track(system, scene, i, objects.Detection)
        assert system.tracking_state == TrackingState.OK, i
    traj = system.camera_trajectory()
    assert [f for f, _, _ in traj] == list(range(N + 2))
    assert not any(e.lost for e in system.tracker.trajectory)
    errs = [np.linalg.norm(np.linalg.inv(T)[:3, 3] - sc.poses_world[f][:3, 3])
            for f, T, _ in traj]
    # the resumed frames at the async gate's form against the saved run's
    # frames (tests/test_async_mapping.py:131)
    assert max(errs[N:]) <= 1.5 * max(errs[:N]) + 0.1, errs
    track = system._object_system.all_tracks[0]
    assert N + 1 in track.poses_cf


def test_load_leaves_nothing_stale(saved):
    """A System with the fast path, async mapping and loop closing: its
    device tables, database, GBA epoch and pending object keyframes after a
    load."""
    _, port, _, ppath = saved
    system = System(_configs(config, loop=True, device_resident_tracking=True,
                             async_mapping=True), device="cpu")
    lc = system.loop_closer
    system._object_system._pending_okfs = {7: 2}
    epoch = lc._gba_epoch
    checkpoint.load_checkpoint(ppath, system)
    kfs = [int(k) for k in port.map.keyframe_ids()]
    assert lc._gba_epoch == epoch + 1
    assert lc.db.present.nonzero()[0].tolist() == sorted(kfs)
    assert system._object_system._pending_okfs == {}
    fast = system._fast
    assert fast._tables is not None and fast._T_dev is None
    assert not fast.ready(system.tracker)   # no velocity: the host tracker takes the next frame
    system.shutdown()
