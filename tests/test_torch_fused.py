"""The slice as a whole: pointslot_torch's FusedFrameStep (device="cpu")
against pointslot_tpu's (JAX on the CPU, take path) on the same inputs,
at 512x256 with M <= 256 map points and O = 2 objects of Mo = 64 points.

Tolerances and why:
- camera and object translations 1e-3 m, n_inliers +-2: float32 LM whose
  sums run in another order;
- keypoints (xy, level, valid): equal, except where a pyramid pixel moved
  by a float32 ulp (the resize matmuls sum in another order than XLA's)
  flips the pick between two FAST cells that tie to within rounding.
  Such keypoints are counted and bounded at 0.5 % of the capacity;
- on the keypoints that agree, descriptor bits flip only where a BRIEF
  pair's samples tie to within rounding: counted, bounded at 0.1 % of the
  bits; u_right agrees to 1e-3 px and depth to rtol 1e-4 where valid.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pointslot_tpu.config import CameraConfig as JCameraConfig
from pointslot_tpu.config import SystemConfig as JSystemConfig
from pointslot_tpu.ops import pyramid as jpyr
from pointslot_tpu.ops.fused_track import FusedFrameStep as JFusedFrameStep
from pointslot_torch import convert
from pointslot_torch.config import CameraConfig, SystemConfig
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops import patch, pyramid
from pointslot_torch.ops.fused_track import FusedFrameStep

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
M, O, MO = 256, 2, 64


@pytest.fixture(scope="module")
def steps():
    """The two FusedFrameSteps; the JAX one compiles once for the module."""
    jcfg = JSystemConfig().replace(camera=JCameraConfig(**CAM))
    cfg = SystemConfig().replace(camera=CameraConfig(**CAM))
    return JFusedFrameStep(jcfg), FusedFrameStep(cfg, device="cpu")


def _two_dispatch_inputs():
    """The inputs of tests/test_fused_track.py::test_fused_frame_step_matches_two_dispatch."""
    rng = np.random.default_rng(3)
    left = rng.integers(0, 255, (CAM["height"], CAM["width"]), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    eye = np.eye(4, dtype=np.float32)
    pos = rng.uniform([-5, -2, 2], [5, 2, 20], (M, 3)).astype(np.float32)
    dsc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    lvl = np.zeros(M, np.int32)
    val = np.ones(M, bool)
    opos = rng.uniform([-1, -1, -1], [1, 1, 1], (O, MO, 3)).astype(np.float32)
    odesc = rng.integers(0, 2**32, (O, MO, 8), dtype=np.uint32)
    ovalid = np.ones((O, MO), bool)
    oT = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    oT[:, 2, 3] = 8.0
    ovel = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    return (left, right, eye, eye, pos, dsc, lvl, val, opos, odesc, ovalid, oT, ovel)


def _compare_frames(got, want):
    """Feature comparison of one frame (see the module docstring)."""
    same = ((got.xy == want.xy).all(axis=1) & (got.level == want.level)
            & (got.valid == want.valid))
    assert (~same).sum() <= 0.005 * len(same), f"{(~same).sum()} keypoints differ"
    v = same & want.valid
    flips = int(np.unpackbits((got.desc[v] ^ want.desc[v]).view(np.uint8)).sum())
    assert flips <= 0.001 * 256 * v.sum(), f"{flips} descriptor bits flipped"
    # stereo on the agreeing keypoints whose descriptor and match agree
    sv = v & (got.depth > 0) & (want.depth > 0)
    assert ((got.depth > 0) != (want.depth > 0))[v].sum() <= 0.005 * len(same)
    np.testing.assert_allclose(got.u_right[sv], want.u_right[sv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.depth[sv], want.depth[sv], rtol=1e-4)


def _compare_poses(got, want):
    (r, To, _, no), (jr, jTo, _, jno) = got, want
    np.testing.assert_allclose(r.T_cw[:3, 3], np.asarray(jr.T_cw)[:3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(To[:, :3, 3], np.asarray(jTo)[:, :3, 3], rtol=0, atol=1e-3)
    assert abs(int(r.n_inliers) - int(jr.n_inliers)) <= 2
    assert np.all(np.abs(no - np.asarray(jno)) <= 2)


def _numpy(result):
    return type(result)(*[np.asarray(x) for x in result])


def _run_port(step, args):
    r, To, vo, no = step(*args)
    return convert.to_numpy(r), To.numpy(), vo.numpy(), no.numpy()


@pytest.fixture(scope="module")
def two_dispatch(steps):
    """The two-dispatch inputs and the port's __call__ on them, run once for
    the module."""
    args = _two_dispatch_inputs()
    return args, _run_port(steps[1], args)


def test_fused_frame_step_matches_reference(steps, two_dispatch):
    """On the inputs of the reference's two-dispatch test."""
    jstep, _ = steps
    args, got = two_dispatch
    want = jstep(*args)
    _compare_poses(got, want)
    _compare_frames(got[0], _numpy(want[0]))
    assert patch.LAUNCHES == 0


def test_step_then_phase_equals_call(steps, two_dispatch):
    """.step then .phase equals __call__ (same program, run in two calls)."""
    _, step = steps
    args, (r1, T1, v1, n1) = two_dispatch
    r2 = step.step(*args[:8])
    T2, v2, n2 = step.phase(r2.xy, r2.level, r2.desc, r2.valid, r2.depth, r2.u_right,
                            *args[8:])
    np.testing.assert_array_equal(r1.T_cw, r2.T_cw.numpy())
    np.testing.assert_array_equal(r1.desc, convert.desc_to_numpy(r2.desc))
    np.testing.assert_array_equal(T1, T2.numpy())
    np.testing.assert_array_equal(v1, v2.numpy())
    np.testing.assert_array_equal(n1, n2.numpy())


def test_fused_sequence_matches_reference(steps):
    """A short synthetic mode-4 sequence: map and object tables from frame
    0 (the port's frontend), then three tracked frames, each step chaining
    its own poses and velocities."""
    jstep, step = steps
    cam = step.step.cfg.camera
    scene = synthetic.make_scene(n_frames=4, camera=cam, n_points=2500, n_objects=2,
                                 seed=7, forward_speed=0.3)
    renderer = synthetic.SyntheticRenderer(scene)
    left, right, inst = renderer.render(0)
    f0 = convert.to_numpy(step.frontend(left, right))
    tables = synthetic.map_table_from_frame(f0, cam, M)
    opos, odesc, ovalid, oT = synthetic.object_tables_from_frame(scene, 0, inst, f0, O, MO)
    assert tables[3].sum() == M and ovalid.sum(axis=1).min() > 10
    eye = np.eye(4, dtype=np.float32)
    port_state = jax_state = (eye, eye, oT, np.tile(eye, (O, 1, 1)))
    for i in range(1, scene.n_frames):
        left, right, _ = renderer.render(i)
        got = _run_port(step, (left, right, *port_state[:2], *tables,
                               opos, odesc, ovalid, *port_state[2:]))
        want = jstep(left, right, *jax_state[:2], *tables, opos, odesc, ovalid,
                     *jax_state[2:])
        _compare_poses(got, want)
        _compare_frames(got[0], _numpy(want[0]))
        assert int(got[0].n_inliers) > 30
        port_state = (got[0].T_cw, got[0].velocity, got[1], got[2])
        jax_state = tuple(np.asarray(x) for x in (want[0].T_cw, want[0].velocity,
                                                  want[1], want[2]))


def test_resize_weights_small_geometry(steps):
    """The numpy rebuild of the resize weights equals _resize_mats at
    512x256 for every level (the fixture's compile filled the reference's
    cache; atol 1e-7 asked, it is bit-equal)."""
    shapes = pyramid.level_shapes(256, 512, 8, 1.2)
    assert shapes == jpyr.level_shapes(256, 512, 8, 1.2)
    for lvl in range(1, 8):
        R, C = pyramid.resize_mats(*shapes[lvl - 1], *shapes[lvl])
        Rj, Cj = jpyr._resize_mats(*shapes[lvl - 1], *shapes[lvl])
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-7)
        np.testing.assert_allclose(C, Cj, rtol=0, atol=1e-7)
        assert np.array_equal(R, Rj) and np.array_equal(C, Cj)


def test_stereo_frontend_matches_reference(steps):
    """Stereo matching on the same features and the same pyramid (the
    port's, handed to both): valid equal, u_right to 1e-3 px and depth to
    rtol 1e-4 where valid (the SAD sums run in another order)."""
    import jax

    from pointslot_tpu.ops.orb import FeatureSet as JFeatureSet
    from pointslot_torch.ops.orb import FeatureSet

    jstep, step = steps
    fe, jfe = step.frontend, jstep.frontend
    cam = step.step.cfg.camera
    scene = synthetic.make_scene(n_frames=2, camera=cam, n_points=2500, n_objects=2,
                                 seed=7, forward_speed=0.3)
    left, right, _ = synthetic.SyntheticRenderer(scene).render(1)
    both = convert.to_tensor(np.stack([left, right]), None, "cpu")
    levels, scores = fe._image_stage(both)
    ext = fe.extractor
    xyl, xy, resp, lvl, valid = ext.detect(scores)
    levels_l = [x[0] for x in levels]
    levels_r = [x[1] for x in levels]
    patch_l, ang_l, desc_l = ext.describe(levels_l, xyl[0])
    _, ang_r, desc_r = ext.describe(levels_r, xyl[1])
    fl = FeatureSet(xy[0], resp[0], ang_l, lvl[0], desc_l, valid[0])
    fr = FeatureSet(xy[1], resp[1], ang_r, lvl[1], desc_r, valid[1])
    u_right, depth, valid_st = fe._stereo_from_patches(fl, fr, levels_l, levels_r, patch_l)

    def jax_set(f):
        f = convert.to_numpy(f)
        return JFeatureSet(*[jnp.asarray(x) for x in f])

    run = jax.jit(jfe._stereo_from_patches)
    want = run(jax_set(fl), jax_set(fr), [jnp.asarray(x.numpy()) for x in levels_l],
               [jnp.asarray(x.numpy()) for x in levels_r], jnp.asarray(patch_l.numpy()))
    w_ur, w_depth, w_valid = (np.asarray(x) for x in want)
    assert w_valid.sum() > 200
    np.testing.assert_array_equal(valid_st.numpy(), w_valid)
    v = w_valid
    np.testing.assert_allclose(u_right.numpy()[v], w_ur[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(depth.numpy()[v], w_depth[v], rtol=1e-4)
