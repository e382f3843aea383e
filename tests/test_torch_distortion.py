"""Lens distortion in the port against the JAX package, on the CPU.

- ``geometry/camera.py``: ``undistort_points`` within 1e-3 px of the
  reference's on a grid over the KITTI image, for radial and tangential
  coefficients (both are float32 fixed-point iterations; they sum in
  another order), ``distort_normalized`` within 1e-6.
- The System's frame record: the same features (a random StereoFrame with
  stereo and monocular keypoints, and a gate) through the port's
  ``System._frame_record`` and the reference's ``_build_frame_record``:
  keypoints and right matches within 1e-3 px, depths within 1e-3
  relative, valid flags equal (the gate is checked at the distorted
  pixel, after undistortion, in both). k3 alone undistorts nothing, as in
  the reference (slam/system.py:470 of the JAX package reads k1, k2, p1
  and p2 only).
- tests/test_distortion_e2e.py's sequence (k1 = -0.05, 12 frames) on the
  port's CPU System at that file's size, 512x256, where the JAX System
  passes the same gates: at least 11 frames tracked, calibrated ATE under
  0.10 m, uncalibrated ATE over 1.5x the calibrated. The calibrated run
  has the fast path configured, and it takes no frame.

About 50 s alone, on one torch thread.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.geometry import camera as jcamera
from pointslot_tpu.ops.frontend import StereoFrame as JStereoFrame
from pointslot_tpu.slam import system as jsystem
from pointslot_torch import config
from pointslot_torch.datasets import synthetic
from pointslot_torch.geometry import camera
from pointslot_torch.ops.frontend import StereoFrame
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from test_distortion_e2e import K1, N, _distort_image

LENSES = [dict(k1=-0.05, k2=0.0, p1=0.0, p2=0.0), dict(k1=-0.12, k2=0.03, p1=0.0, p2=0.0),
          dict(k1=0.04, k2=-0.01, p1=1e-3, p2=-2e-3)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lens", LENSES)
def test_undistort_points_matches_reference(lens):
    cam = config.CameraConfig()
    u, v = np.meshgrid(np.linspace(0, cam.width - 1, 63), np.linspace(0, cam.height - 1, 21))
    xy = np.stack([u.ravel(), v.ravel()], 1).astype(np.float32)
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    want = np.asarray(jcamera.undistort_points(jnp.asarray(xy), *intr, **lens))
    got = camera.undistort_points(torch.from_numpy(xy), *intr, **lens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(got - xy).max() > 1.0   # the lens moves the corners
    xn = (xy - np.float32([cam.cx, cam.cy])) / np.float32([cam.fx, cam.fy])
    np.testing.assert_allclose(
        camera.distort_normalized(torch.from_numpy(xn), **lens).numpy(),
        np.asarray(jcamera.distort_normalized(jnp.asarray(xn), **lens)), rtol=0, atol=1e-6)


def _stereo_frame(rng, cam, n=600):
    xy = rng.uniform([0, 0], [cam.width - 1, cam.height - 1], (n, 2)).astype(np.float32)
    disp = rng.uniform(2.0, 60.0, n).astype(np.float32)
    stereo = rng.random(n) < 0.7
    u_right = np.where(stereo, xy[:, 0] - disp, -1.0).astype(np.float32)
    depth = np.where(stereo, cam.bf / disp, -1.0).astype(np.float32)
    fields = dict(xy=xy, response=rng.random(n).astype(np.float32),
                  angle=rng.uniform(0, 6.28, n).astype(np.float32),
                  level=rng.integers(0, 8, n).astype(np.int32),
                  desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
                  valid=rng.random(n) < 0.95, u_right=u_right, depth=depth)
    port = StereoFrame(**{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                          for k, v in fields.items()})
    return port, JStereoFrame(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("lens", LENSES + [dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.2)])
def test_frame_record_matches_reference(lens):
    rng = np.random.default_rng(4)
    cam = config.CameraConfig(**lens)
    sf, jsf = _stereo_frame(rng, cam)
    gate = np.ones((cam.height, cam.width), bool)
    gate[100:250, 300:700] = False
    got = System._frame_record(SimpleNamespace(cfg=config.SystemConfig(camera=cam)), sf, gate, 3)
    want = jsystem.System._build_frame_record(
        SimpleNamespace(cfg=jconfig.SystemConfig(camera=jconfig.CameraConfig(**lens))),
        jsf, gate, 3)
    np.testing.assert_allclose(got.xy, want.xy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.u_right, want.u_right, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.depth, want.depth, rtol=1e-3, atol=0)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.desc, want.desc)
    assert got.frame_id == 3 and not got.valid[(sf.xy[:, 1] > 101) & (sf.xy[:, 1] < 248)
                                               & (sf.xy[:, 0] > 301) & (sf.xy[:, 0] < 698)].any()
    moved = np.abs(got.xy - sf.xy.numpy()).max()
    assert (moved > 1.0) == cam.distorted
    assert cam.distorted == any(lens.get(k, 0.0) != 0 for k in ("k1", "k2", "p1", "p2"))


def _run(calibrated: bool, **runtime):
    """tests/test_distortion_e2e.py:_run on the port's CPU System."""
    shape = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
    cam = config.CameraConfig(**shape, k1=K1 if calibrated else 0.0)
    pin = config.CameraConfig(**shape)
    scene = synthetic.make_scene(n_frames=N, n_objects=0, seed=21, camera=pin,
                                 forward_speed=0.5, yaw_rate=0.03)
    renderer = synthetic.SyntheticRenderer(scene)
    system = System(config.SystemConfig(
        camera=cam, tracking=config.TrackingConfig(min_init_stereo_features=150),
        loop=config.LoopConfig(enabled=False), runtime=config.RuntimeConfig(**runtime)),
        device="cpu")
    for i in range(N):
        left, right, _ = renderer.render(i)
        system.track_stereo(_distort_image(left, pin, K1), _distort_image(right, pin, K1),
                            i * 0.1, i)
    errs = [np.linalg.norm(np.linalg.inv(T)[:3, 3] - scene.poses_world[f][:3, 3])
            for f, T, lost in system.camera_trajectory() if not lost]
    return system, float(np.sqrt(np.mean(np.square(errs)))) if errs else np.inf, len(errs)


def test_distorted_sequence_with_calibration():
    system, ate, n_ok = _run(calibrated=True, device_resident_tracking=True)
    assert system.tracker.state == TrackingState.OK
    assert n_ok >= N - 1
    assert ate < 0.10, ate
    assert system._fast is not None and system._fast_frames == 0
    _, ate_raw, _ = _run(calibrated=False)
    assert ate_raw > 1.5 * ate, (ate, ate_raw)
