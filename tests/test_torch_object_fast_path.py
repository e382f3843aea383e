"""The mode-4 fast path and the object BA's motion priors of the port against
the JAX package's, on the CPU.

The JAX System in SLOT mode 4 with the device-resident fast path
(device_resident_tracking) runs at 512x256 on 8 frames of
tests/test_object_slot.py's two-object scene, configured as in
tests/test_torch_object_system.py. The port's DeviceTrackingPath
(device="cpu") runs inside it (tests/test_torch_system.py's _Mirror): at
every refresh, fused-step frame and materialize, from a copy of the same
map, tracker state and pose/velocity chain, under the same background gate
(the instance mask's background plus the objects settled as static).

Bounds and why:
- the gated step: the bounds of the mode-0 fast-path mirror
  (tests/test_torch_system.py::test_device_tracking_path_matches_reference):
  equal device tables, the same frames accepted, T_cw and the velocity
  within 1e-4, at most 0.5 % of the bindings differing and n_inliers within
  2, equal visibility counts and reference keyframe. The gate's
  per-feature check: the valid flags differ on at most 0.5 % of the
  features (a keypoint at a FAST-cell tie), and no valid feature of the
  port lies outside the gate;
- the motion priors, at objects.ba_motion_prior_weight 50 and
  ba_min_covisible_kfs 1 (tests/test_object_slot.py:144-194's settings),
  built from a copy of the JAX run's tracks: exactly equal (the same numpy
  code, cast to float32 once);
- one object mapping step with those priors from the same state (cull,
  fuse, the windowed object BA with priors, write-back), the port's
  against the reference's _object_local_mapping: the batched-mapping
  bounds of tests/test_torch_object_system.py (keyframe translations within
  1e-2 m, rotation entries within 1e-3, points within 1e-2 m except at
  most 1 % of them, none beyond 5e-2 m).

Measured at about 95 s alone, on one torch thread of an 8-core Xeon shared
with other work; the JAX System's compiles are most of it.
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_system import _Mirror

from pointslot_tpu import config as jconfig
from pointslot_tpu.slam import objects as jobjects
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops.frontend import StereoFrontend
from pointslot_torch.slam.fast_path import DeviceTrackingPath

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N = 8
OBJECTS = dict(init_min_features=10, init_min_map_points=8, min_tracked_points=8,
               track_min_features=10, set_init_position_by_points=False,
               ba_min_covisible_kfs=2)
PRIORS = dict(OBJECTS, ba_motion_prior_weight=50.0, ba_min_covisible_kfs=1)
MAX_OBJ_GAP_M, MAX_ROT_GAP = 1e-2, 1e-3
MAX_SLIDING_POINTS, MAX_SLIDING_GAP_M = 0.01, 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, objects=OBJECTS, **runtime):
    """tests/test_torch_object_system.py's reduced mode-4 configuration in
    either package."""
    return pkg.SystemConfig(
        slot_mode=pkg.SLOTMode.OFFLINE,
        camera=pkg.CameraConfig(**CAM),
        objects=pkg.ObjectConfig(**objects),
        tracking=pkg.TrackingConfig(min_init_stereo_features=350),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        loop=pkg.LoopConfig(enabled=False),
        runtime=pkg.RuntimeConfig(**runtime),
    )


@pytest.fixture(scope="module")
def fast_run():
    """The JAX mode-4 fast-path System with the port's DeviceTrackingPath
    mirrored inside it (the JAX System once per module)."""
    sc = synthetic.make_scene(n_frames=N, n_points=2500, n_objects=2, seed=31,
                              forward_speed=0.8, camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    rows = synthetic.offline_detection_rows(sc)
    ref = jsystem.System(_configs(jconfig, device_resident_tracking=True))
    path = DeviceTrackingPath(_configs(config), StereoFrontend(
        CAM["height"], CAM["width"], CAM["fx"], CAM["bf"], device="cpu"))
    mirror = _Mirror(ref._fast, path)
    for i in range(N):
        left, right, inst = renderer.render(i)
        fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
        dets = [jobjects.Detection.from_row24(r, mask_value=int(r[1]) + 1) for r in fr]
        ref.track_stereo(left, right, timestamp=i * 0.1, frame_id=i, detections=dets,
                         instance_mask=inst)
    ref.wait_for_mapping()
    return ref, mirror


def test_gated_device_tracking_path_matches_reference(fast_run):
    ref, mirror = fast_run
    assert len(mirror.tables) >= 2
    for pts, tables, jpts, jtables in mirror.tables:
        np.testing.assert_array_equal(pts, jpts)
        for t, jt in zip(tables, jtables):
            np.testing.assert_array_equal(t.numpy().view(np.asarray(jt).dtype), np.asarray(jt))
    assert len(mirror.frames) == ref._fast_frames >= N // 2
    # a gate on every frame, masking the moving objects on some of them
    assert all(g is not None for g in mirror.gates)
    assert any(not g.all() for g in mirror.gates), [int((~g).sum()) for g in mirror.gates]
    for (got, state, want, after), gate in zip(mirror.frames, mirror.gates):
        assert (got is None) == (want is None)
        if want is None:
            continue
        # the pose as the step returned it (a keyframe's BA moves it later)
        np.testing.assert_allclose(got.T_cw, after.T_cw, rtol=0, atol=1e-4)
        np.testing.assert_allclose(state.velocity, after.velocity, rtol=0, atol=1e-4)
        differ = int((got.point_idx != after.point_idx).sum())
        assert differ <= 0.005 * len(after.point_idx), differ
        assert abs(state.n_matches_inliers - after.n_matches_inliers) <= 2
        assert state.ref_kf == after.ref_kf
        np.testing.assert_array_equal(state.map.pt_visible, after.pt_visible)
        assert int(np.abs(state.map.pt_found - after.pt_found).sum()) <= differ
        assert (got.valid != want.valid).sum() <= 0.005 * len(want.valid)
        assert got.valid.sum() > 100
    assert len(mirror.keyframes) >= 1
    for got, want in mirror.keyframes:
        assert (got.xy != want.xy).any(axis=1).sum() <= 0.005 * len(want.xy)
        np.testing.assert_array_equal(got.level, want.level)
        # the gate's per-feature check at level-0 coordinates
        h, w = CAM["height"], CAM["width"]
        xi = np.clip(np.round(got.xy[:, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(got.xy[:, 1]).astype(int), 0, h - 1)
        gate = next(g for (f, _, _, _), g in zip(mirror.frames, mirror.gates) if f is got)
        assert gate[yi, xi][got.valid].all()


@pytest.fixture()
def prior_twins(fast_run):
    """The JAX run's ObjectSystem switched to the priors' configuration on
    a deep copy of its tracks, and the port's ObjectSystem holding another
    copy; the JAX one's own state is put back afterwards."""
    ref, _ = fast_run
    jobj = ref._object_system
    saved = jobj.cfg, jobj.tracks, jobj.all_tracks, jobj.ba_calls
    twins = copy.deepcopy(jobj.all_tracks)
    port = convert.object_system_from_arrays(jobj, _configs(config, PRIORS), device="cpu")
    jobj.cfg = _configs(jconfig, PRIORS)
    jobj.all_tracks, jobj.tracks = twins, {t.track_id: t for t in twins}
    yield jobj, port
    jobj.cfg, jobj.tracks, jobj.all_tracks, jobj.ba_calls = saved


def test_object_motion_priors_equal_reference(prior_twins):
    """ObjectSystem._build_motion_priors over each track's keyframes: the
    constant-velocity T_rel = T_cw(b) V^gap T_cw(a)^-1 and the weight w/gap."""
    jobj, port = prior_twins
    built = 0
    for g, w in zip(port.all_tracks, jobj.all_tracks):
        for R_cap in (16, 32):
            want = jobj._build_motion_priors(w, w.keyframes, R_cap=R_cap)
            got = port._build_motion_priors(g, g.keyframes, R_cap=R_cap)
            assert (got is None) == (want is None)
            if want is None:
                continue
            built += 1
            for name, x in want._asdict().items():
                np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(x),
                                              err_msg=name)
            assert int(got.valid.sum()) == min(len(g.keyframes), R_cap + 1) - 1
    assert built >= 2


def test_object_mapping_with_priors_matches_reference(prior_twins):
    """One object mapping step per track with the priors on (the sync
    path: the port's _map_objects of one item against the reference's
    _object_local_mapping), from the same state."""
    jobj, port = prior_twins
    for g, w in zip(port.all_tracks, jobj.all_tracks):
        det = w.detections[max(w.detections)]
        window = jobj._build_object_ba(copy.deepcopy(w), len(w.keyframes) - 1)
        assert window is not None and window[3] is not None   # a solve with priors
        calls = port.ba_calls, jobj.ba_calls
        jobj._object_local_mapping(w, det)
        port._map_objects([(g, convert.copy_object_state(det))])
        assert port.ba_calls - calls[0] == jobj.ba_calls - calls[1] == 1
        assert len(g.keyframes) == len(w.keyframes)
        for gk, wk in zip(g.keyframes, w.keyframes):
            np.testing.assert_allclose(gk.T_co[:3, 3], wk.T_co[:3, 3], rtol=0,
                                       atol=MAX_OBJ_GAP_M)
            np.testing.assert_allclose(gk.T_co[:3, :3], wk.T_co[:3, :3], rtol=0,
                                       atol=MAX_ROT_GAP)
        np.testing.assert_array_equal(g.pt_valid, w.pt_valid)
        gap = np.abs(g.pt_pos[w.pt_valid] - w.pt_pos[w.pt_valid]).max(axis=1)
        assert (gap > MAX_OBJ_GAP_M).sum() <= MAX_SLIDING_POINTS * len(gap), gap.max()
        assert gap.max() <= MAX_SLIDING_GAP_M, gap.max()
