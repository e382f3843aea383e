"""FusedFrameStep.multi: S = 3 frames with the carry (T_cw, velocity,
T_obj, vel_obj) chained, against the reference's ``multi`` (JAX on the CPU,
take path) at tests/test_torch_fused.py's small configuration (512x256,
M = 256 map points, O = 2 objects of Mo = 64 points) on frames 1-3 of its
rendered sequence, and against 3 chained ``__call__``s of the port.

Tolerances (tests/test_torch_fused.py): the translations of the camera
poses and of every carry term (T_cw, velocity, T_obj, vel_obj) within
1e-3 m and inlier counts within 2 of the reference's (a float32 LM whose
sums run in another order); the port's ``multi`` equals its chained calls
exactly (the same operations on the same inputs).
"""

import numpy as np
import pytest
import torch

from pointslot_tpu.config import CameraConfig as JCameraConfig
from pointslot_tpu.config import SystemConfig as JSystemConfig
from pointslot_tpu.ops.fused_track import FusedFrameStep as JFusedFrameStep
from pointslot_torch import convert
from pointslot_torch.config import CameraConfig, SystemConfig
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops.fused_track import FusedFrameStep

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
M, O, MO, S = 256, 2, 64, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step():
    return FusedFrameStep(SystemConfig().replace(camera=CameraConfig(**CAM)), device="cpu")


@pytest.fixture(scope="module")
def inputs(step):
    """Frames 1-3 of tests/test_torch_fused.py's rendered mode-4 sequence
    (seed 7, 0.3 m a frame), with the map and object tables built from
    frame 0 by the port's frontend, so that both LMs have matches to solve."""
    cam = step.step.cfg.camera
    scene = synthetic.make_scene(n_frames=S + 1, camera=cam, n_points=2500, n_objects=2,
                                 seed=7, forward_speed=0.3)
    renderer = synthetic.SyntheticRenderer(scene)
    left, right, inst = renderer.render(0)
    f0 = convert.to_numpy(step.frontend(left, right))
    tables = synthetic.map_table_from_frame(f0, cam, M)
    opos, odesc, ovalid, oT = synthetic.object_tables_from_frame(scene, 0, inst, f0, O, MO)
    assert tables[3].sum() == M and ovalid.sum(axis=1).min() > 10
    lefts, rights = (np.stack(x) for x in zip(*(renderer.render(i)[:2]
                                                 for i in range(1, S + 1))))
    eye = np.eye(4, dtype=np.float32)
    return (lefts, rights, eye, eye, *tables, opos, odesc, ovalid, oT)


@pytest.fixture(scope="module")
def port(step, inputs):
    return step, step.multi(*inputs)


def test_multi_matches_reference(inputs, port):
    jstep = JFusedFrameStep(JSystemConfig().replace(camera=JCameraConfig(**CAM)))
    (jT, jvel, jTo, jvo), (jposes, jn, jno) = jstep.multi(*inputs)
    _, ((T, vel, To, vo), (poses, n, no)) = port
    assert poses.shape == (S, 4, 4) and n.shape == (S,) and no.shape == (S, O)
    # the LM solves every frame and the camera moves, so a carry passed
    # wrong to the next frame shows
    assert n.min() > 30 and np.asarray(jn).min() > 30
    moved = np.linalg.norm(poses.numpy()[:, :3, 3], axis=1)
    assert np.all(np.diff(moved) > 0.1) and moved[0] > 0.1
    np.testing.assert_allclose(poses.numpy()[:, :3, 3], np.asarray(jposes)[:, :3, 3],
                               rtol=0, atol=1e-3)
    assert np.all(np.abs(n.numpy() - np.asarray(jn)) <= 2)
    assert np.all(np.abs(no.numpy() - np.asarray(jno)) <= 2)
    for got, want in ((T, jT), (vel, jvel), (To, jTo), (vo, jvo)):
        np.testing.assert_allclose(got.numpy()[..., :3, 3], np.asarray(want)[..., :3, 3],
                                   rtol=0, atol=1e-3)


def test_multi_equals_chained_calls(inputs, port):
    step, ((T, vel, To, vo), (poses, n, no)) = port
    lefts, rights, T_c, vel_c, *tables, oT = inputs
    To_c, vo_c = oT, None
    for s in range(S):
        r, To_c, vo_c, n_o = step(lefts[s], rights[s], T_c, vel_c, *tables, To_c, vo_c)
        T_c, vel_c = r.T_cw, r.velocity
        assert torch.equal(poses[s], T_c)
        assert torch.equal(n[s], r.n_inliers)
        assert torch.equal(no[s], n_o)
    for a, b in zip((T, vel, To, vo), (T_c, vel_c, To_c, vo_c)):
        assert torch.equal(a, b)
