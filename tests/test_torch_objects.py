"""The modules of the object layer (SLOT mode 4) against the JAX package on
the same seeded inputs, on the CPU: pointslot_torch's BRIEF patterns,
gated frontend, matchers, pose LM with the translation prior,
object_factors, motion priors and batched BA, objects.py and the SE(3) log
(device="cpu") against pointslot_tpu's (JAX on the CPU).

Tolerances and why:
- the gaussian BRIEF table, the nearest gate index map at every pyramid
  level, dilate_mask_left, build_motion_priors, the batched matchers'
  bindings and objects.py's host bookkeeping: exactly equal. They are
  integer logic, copies or the same numpy code;
- the gated frontend: keypoints equal except at FAST-cell ties, at most
  0.5 % of them, and descriptor bits on agreeing keypoints at most 0.1 %
  (tests/test_torch_fused.py's bounds and reasons: the pyramid's resize
  sums run in another order than XLA's);
- pose LM with the translation prior: poses within 1e-4, inliers equal
  (float32 LM sums in another order);
- fine_tune_with_bbox: within 1e-4 m; the SE(3) log: within 1e-5;
- bundle_adjust with priors and bundle_adjust_batched: the BA bounds of
  tests/test_torch_mapping.py (poses 1e-4, points 1e-3 m + 1e-4 relative,
  inliers equal, cost 1e-3 relative);
- bundle_adjust run twice on one problem: bit for bit.

Measured at 100-115 s alone, on one torch thread of an 8-core Xeon shared
with other work; the JAX object frontend's compile is a third of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.config import ORBConfig as JORBConfig
from pointslot_tpu.config import SLOTMode as JSLOTMode
from pointslot_tpu.config import SystemConfig as JSystemConfig
from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.ops import frontend as jfrontend
from pointslot_tpu.ops import orb as jorb
from pointslot_tpu.slam import matchers as jmatchers
from pointslot_tpu.slam import objects as jobjects
from pointslot_tpu.slam.system import System as JSystem
from pointslot_tpu.solvers import local_ba as jba
from pointslot_tpu.solvers import object_factors as jof
from pointslot_tpu.solvers import pose_opt as jpose
from pointslot_torch import convert
from pointslot_torch.config import CameraConfig, ORBConfig, SLOTMode, SystemConfig
from pointslot_torch.datasets import synthetic
from pointslot_torch.geometry import se3
from pointslot_torch.ops import frontend, orb, pyramid
from pointslot_torch.slam import matchers, objects
from pointslot_torch.slam.object_system import ObjectSystem
from pointslot_torch.solvers import local_ba, object_factors, pose_opt

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
FX, FY, CX, CY, BF = 721.5, 721.5, 609.6, 172.9, 384.4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a, dtype=None):
    return convert.to_tensor(a, dtype, "cpu")


# --------------------------------------------------------------------------
# BRIEF pattern, gate index map, gated frontend, dilation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "learned"])
def test_brief_pattern_equals_reference(kind):
    got, want = orb.brief_pattern(kind), jorb.brief_pattern(kind)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("height, width", [(375, 1242), (256, 512)])
def test_gate_index_map_equals_jax_nearest(height, width):
    """The gate's index map against jax.image.resize(..., "nearest") on a
    mask that codes each pixel's index, at every level of the pyramid."""
    code = (np.arange(height)[:, None] * width + np.arange(width)[None, :]).astype(np.float32)
    for h, w in pyramid.level_shapes(height, width, 8, 1.2):
        want = np.asarray(jax.image.resize(jnp.asarray(code), (h, w), "nearest"))
        got = code[frontend.nearest_index(height, h)][:, frontend.nearest_index(width, w)]
        np.testing.assert_array_equal(got, want, err_msg=f"level {h}x{w}")


def test_dilate_mask_left_equals_reference():
    rng = np.random.default_rng(4)
    mask = np.zeros((64, 300), np.int32)
    for k in range(1, 5):
        y, x = rng.integers(0, 50), rng.integers(0, 280)
        mask[y:y + 12, x:x + 20] = k
    for d in (1, 5, 128, 200):
        np.testing.assert_array_equal(frontend.dilate_mask_left(mask, d),
                                      jfrontend.dilate_mask_left(mask, d))


@pytest.fixture(scope="module")
def rendered():
    scene = synthetic.make_scene(n_frames=2, n_points=2500, n_objects=2, seed=31,
                                 forward_speed=0.8,
                                 camera=CameraConfig(**CAM))
    left, right, inst = synthetic.SyntheticRenderer(scene).render(1)
    assert (inst > 0).sum() > 2000   # both boxes in view
    return left, right, inst


@pytest.mark.parametrize("use", ["object", "background"])
def test_gated_frontend_matches_reference(rendered, use):
    """The object frontend (gaussian pattern, gate and dilated gate_right)
    and the background one (learned pattern, gate on the left only)."""
    left, right, inst = rendered
    pattern = "gaussian" if use == "object" else "learned"
    gate = inst > 0 if use == "object" else inst == 0
    gate_r = frontend.dilate_mask_left(gate) if use == "object" else None
    args = (CAM["height"], CAM["width"], CAM["fx"], CAM["bf"])
    jfe = jfrontend.StereoFrontend(*args, JORBConfig(brief_pattern=pattern))
    fe = frontend.StereoFrontend(*args, ORBConfig(brief_pattern=pattern), device="cpu")
    want = jfrontend.frame_to_numpy(jfe(left, right, gate=gate, gate_right=gate_r))
    got = convert.to_numpy(fe(left, right, gate=gate, gate_right=gate_r))
    same = ((got.xy == want.xy).all(axis=1) & (got.level == want.level)
            & (got.valid == want.valid))
    assert (~same).sum() <= 0.005 * len(same), f"{(~same).sum()} keypoints differ"
    v = same & want.valid
    assert v.sum() > 100
    flips = int(np.unpackbits((got.desc[v] ^ want.desc[v]).view(np.uint8)).sum())
    assert flips <= 0.001 * 256 * v.sum(), f"{flips} descriptor bits flipped"
    # detection stays inside the gate (up to the coarse levels' leak,
    # which the keypoint check of the callers removes)
    xi = np.clip(np.round(got.xy[:, 0]).astype(int), 0, CAM["width"] - 1)
    yi = np.clip(np.round(got.xy[:, 1]).astype(int), 0, CAM["height"] - 1)
    assert gate[yi, xi][got.valid].mean() > 0.9


# --------------------------------------------------------------------------
# batched matchers
# --------------------------------------------------------------------------

def _tables(seed, O=3, NA=200, NB=160):
    """Per-object feature and point tables with planted matches."""
    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 2**32, (O, NB, 8), dtype=np.uint32)
    desc_a = rng.integers(0, 2**32, (O, NA, 8), dtype=np.uint32)
    angle_b = rng.uniform(0, 2 * np.pi, (O, NB)).astype(np.float32)
    angle_a = rng.uniform(0, 2 * np.pi, (O, NA)).astype(np.float32)
    for o in range(O):
        for ra, rb in zip(rng.choice(NA, 120, replace=False), rng.choice(NB, 120, replace=False)):
            bits = np.unpackbits(desc_b[o, rb].view(np.uint8))
            bits[rng.choice(256, rng.integers(0, 60), replace=False)] ^= 1
            desc_a[o, ra] = np.packbits(bits).view(np.uint32)
            angle_a[o, ra] = angle_b[o, rb] + rng.choice([0.2, 1.0]) + rng.normal(scale=0.05)
    valid_a = rng.random((O, NA)) > 0.05
    valid_b = rng.random((O, NB)) > 0.1
    return desc_a, angle_a, valid_a, desc_b, angle_b, valid_b


def test_brute_match_batched_equals_vmap():
    """The object tracker's batched brute match (object_system.py:140-148
    in the reference: nn_ratio 0.9, TH_HIGH, rotation check)."""
    args = _tables(7)

    def one(*a):
        return jmatchers.brute_match(*a, nn_ratio=0.9, th_desc=jmatchers.TH_HIGH,
                                     check_rotation=True).idx_b_for_a

    want = np.asarray(jax.vmap(one)(*[jnp.asarray(a) for a in args]))
    da, aa, va, db, ab, vb = args
    got = matchers.brute_match(T(da, torch.int32), T(aa), T(va), T(db, torch.int32), T(ab),
                               T(vb), nn_ratio=0.9, th_desc=matchers.TH_HIGH)
    np.testing.assert_array_equal(got.idx_b_for_a.numpy(), want)
    np.testing.assert_array_equal(got.n_matches.numpy(), (want >= 0).sum(axis=1))
    assert (want >= 0).sum(axis=1).min() > 20


def test_project_and_match_per_object_features_equals_vmap():
    """Each object's own features (the object tracker's projection stage,
    radius 6, level window 1)."""
    rng = np.random.default_rng(8)
    O, P, N = 3, 96, 128
    pts = rng.uniform([-1, -1, -1], [1, 1, 1], (O, P, 3)).astype(np.float32)
    Tco = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    Tco[:, :3, 3] = [[0.5, 0.2, 8.0], [-1.0, 0.0, 12.0], [2.0, 0.3, 6.0]]
    pdesc = rng.integers(0, 2**32, (O, P, 8), dtype=np.uint32)
    pc = pts @ Tco[:, :3, :3].transpose(0, 2, 1) + Tco[:, None, :3, 3]
    uv = np.stack([FX * pc[..., 0] / pc[..., 2] + CX, FY * pc[..., 1] / pc[..., 2] + CY], -1)
    take = rng.choice(P, N, replace=True)
    fxy = (uv[:, take] + rng.normal(scale=2.0, size=(O, N, 2))).astype(np.float32)
    fdesc = pdesc[:, take].copy()
    fdesc[..., 0] ^= rng.integers(0, 2**20, (O, N), dtype=np.uint32)
    flvl = rng.integers(0, 3, (O, N)).astype(np.int32)
    fval = rng.random((O, N)) > 0.1
    pval = rng.random((O, P)) > 0.1
    scales = np.asarray([1.2 ** i for i in range(8)], np.float32)

    def one(p, d, v, Tc, xy, lv, fd, fv):
        return jmatchers.project_and_match(
            p, d, v, Tc, xy, lv, fd, fv, jnp.full((P,), 6.0, jnp.float32), jnp.asarray(scales),
            jnp.zeros(P, jnp.int32), fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=1242,
            height=375, th_desc=jmatchers.TH_HIGH).point_for_feature

    want = np.asarray(jax.vmap(one)(*[jnp.asarray(a) for a in
                                      (pts, pdesc, pval, Tco, fxy, flvl, fdesc, fval)]))
    got = matchers.project_and_match(
        T(pts), T(pdesc, torch.int32), T(pval), T(Tco), T(fxy), T(flvl), T(fdesc, torch.int32),
        T(fval), 6.0, T(scales), torch.zeros((O, P), dtype=torch.int32),
        fx=FX, fy=FY, cx=CX, cy=CY, width=1242, height=375, th_desc=matchers.TH_HIGH)
    np.testing.assert_array_equal(got.point_for_feature.numpy(), want)
    assert (want >= 0).sum() > 100


# --------------------------------------------------------------------------
# pose LM with the translation prior
# --------------------------------------------------------------------------

def test_pose_optimize_trans_prior_matches_reference():
    """Three object problems of 512 edge slots, stereo and mono edges, 10 %
    outliers, a prior near the true translation, weight 50."""
    rng = np.random.default_rng(11)
    O, M = 3, 512
    pts = rng.uniform([-1.5, -1, -2], [1.5, 1, 2], (O, M, 3)).astype(np.float32)
    T_true = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    T_true[:, :3, 3] = [[1.0, 0.5, 10.0], [-2.0, 0.3, 14.0], [3.0, 0.4, 20.0]]
    pc = pts @ T_true[:, :3, :3].transpose(0, 2, 1) + T_true[:, None, :3, 3]
    u = FX * pc[..., 0] / pc[..., 2] + CX
    v = FY * pc[..., 1] / pc[..., 2] + CY
    obs = np.stack([u, v, u - BF / pc[..., 2]], -1) + rng.normal(scale=0.3, size=(O, M, 3))
    bad = rng.random((O, M)) < 0.1
    obs[bad, :2] += rng.uniform(20, 40, (bad.sum(), 2))
    obs = obs.astype(np.float32)
    stereo = rng.random((O, M)) > 0.3
    inv2 = rng.choice([1.0, 1 / 1.44], (O, M)).astype(np.float32)
    valid = np.zeros((O, M), bool)
    valid[0, :300], valid[1, :120], valid[2, :40] = True, True, True
    T0 = T_true.copy()
    T0[:, :3, 3] += rng.normal(scale=0.3, size=(O, 3))
    priors = (T_true[:, :3, 3] + rng.normal(scale=0.05, size=(O, 3))).astype(np.float32)
    cam = dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF)
    want = jpose.pose_optimize_batched(
        jnp.asarray(T0), jpose.PoseObs(*[jnp.asarray(a) for a in (pts, obs, stereo, inv2, valid)]),
        **cam, trans_priors=jnp.asarray(priors), use_trans_prior=True)
    got = pose_opt.pose_optimize(T(T0), T(pts), T(obs), T(stereo), T(inv2), T(valid), **cam,
                                 trans_prior=T(priors), trans_prior_weight=50.0)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert (got.n_inliers.numpy() > 0).all()


# --------------------------------------------------------------------------
# object_factors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("optimize_yaw", [False, True])
def test_fine_tune_with_bbox_matches_reference(optimize_yaw):
    """From a pose 0.5-1.5 m and 0.3 rad off, toward a box that no cuboid
    pose projects exactly (so the 12 iterations do not meet at a zero)."""
    dims = np.array([1.6, 1.5, 3.5], np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [2.0, 0.8, 12.0]
    b = np.asarray(jof.project_cuboid_bbox(jnp.asarray(T_true), jnp.asarray(dims),
                                           FX, FY, CX, CY))
    det = np.array([b[0] - 3, b[1] + 2, b[2] - b[0] + 5, b[3] - b[1] - 1], np.float32)
    T0 = T_true.copy()
    T0[:3, 3] += [0.5, -0.2, 1.5]
    c, s = np.cos(0.3), np.sin(0.3)
    T0[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    want = np.asarray(jof.fine_tune_with_bbox(jnp.asarray(T0), jnp.asarray(dims),
                                              jnp.asarray(det), FX, FY, CX, CY,
                                              optimize_yaw=optimize_yaw))
    got = object_factors.fine_tune_with_bbox(T(T0), T(dims), T(det), FX, FY, CX, CY,
                                             optimize_yaw=optimize_yaw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got[:3, 3] - T0[:3, 3]).max() > 0.1   # it moved


def test_object_residuals_match_reference():
    """Cuboid corners, the bbox residual, the motion-model and smoothness
    residuals and the planar velocity."""
    rng = np.random.default_rng(12)
    dims = np.array([1.6, 1.5, 3.5], np.float32)
    Tco = np.asarray(jse3.se3_exp(jnp.asarray([1.0, 0.5, 10.0, 0.0, 0.3, 0.0], jnp.float32)))
    det = np.array([500.0, 120.0, 90.0, 60.0], np.float32)
    np.testing.assert_array_equal(object_factors.cuboid_corners(T(dims)).numpy(),
                                  np.asarray(jof.cuboid_corners(jnp.asarray(dims))))
    np.testing.assert_allclose(
        object_factors.bbox_residual(T(Tco), T(dims), T(det), FX, FY, CX, CY).numpy(),
        np.asarray(jof.bbox_residual(jnp.asarray(Tco), jnp.asarray(dims), jnp.asarray(det),
                                     FX, FY, CX, CY)), rtol=0, atol=1e-3)
    xi = rng.normal(scale=0.2, size=(3, 6)).astype(np.float32)
    A, B_, V = (np.asarray(jse3.se3_exp(jnp.asarray(x))) for x in xi)
    np.testing.assert_allclose(
        object_factors.motion_model_residual(T(A), T(B_), T(V)).numpy(),
        np.asarray(jof.motion_model_residual(jnp.asarray(A), jnp.asarray(B_), jnp.asarray(V))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        object_factors.smoothness_residual(T(A), T(B_)).numpy(),
        np.asarray(jof.smoothness_residual(jnp.asarray(A), jnp.asarray(B_))), rtol=0, atol=1e-5)
    for v, steer in ((2.0, 0.0), (1.0, 0.1)):
        np.testing.assert_allclose(
            object_factors.planar_velocity_to_se2(torch.tensor(v), torch.tensor(steer)).numpy(),
            np.asarray(jof.planar_velocity_to_se2(jnp.float32(v), jnp.float32(steer))),
            rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# motion priors, bundle_adjust with priors, bundle_adjust_batched
# --------------------------------------------------------------------------

def _problem(seed, n_poses=6, n_points=240, dof=None, P_cap=8, L_cap=512, K=8):
    """An object-scale BA window (points within a few metres of the
    object's origin, seen from poses moving past it), stereo and mono
    edges, 0.2 px noise, perturbed poses and points, the first pose true.
    Returns both packages' problems and the true poses."""
    rng = np.random.default_rng(seed)
    poses, T_ = [], np.asarray(jse3.se3_exp(jnp.asarray([0.5, 0.3, 9.0, 0, 0.2, 0],
                                                         jnp.float32)))
    for _ in range(n_poses):
        poses.append(T_.copy())
        step = np.asarray(jse3.se3_exp(jnp.asarray(
            [0.3 + 0.02 * rng.normal(), 0.01 * rng.normal(), -0.4, 0, 0.03 * rng.normal(), 0],
            jnp.float32)))
        T_ = step @ T_
    pts = rng.uniform([-1.5, -1, -2], [1.5, 1, 2], (n_points, 3)).astype(np.float32)
    e_pose, e_point, e_obs = [], [], []
    for p, Tco in enumerate(poses):
        pc = pts @ Tco[:3, :3].T + Tco[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        for l in range(n_points):
            obs = np.array([u[l], v[l], u[l] - BF / pc[l, 2]])
            obs[:2] += rng.normal(size=2) * 0.2
            e_pose.append(p)
            e_point.append(l)
            e_obs.append(obs)
    E = len(e_pose)
    init = [poses[0]] + [np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.01))) @ Tt for Tt in poses[1:]]
    edges = dict(
        poses=np.stack(init).astype(np.float32), pose_fixed=[True] + [False] * (n_poses - 1),
        points=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02,
        e_pose=np.asarray(e_pose), e_point=np.asarray(e_point), e_obs=np.stack(e_obs),
        e_stereo=rng.random(E) > 0.3, e_inv_sigma2=rng.choice([1.0, 1 / 1.44], E))
    caps = dict(P_cap=P_cap, L_cap=L_cap, K=K, dof_mask=dof)
    (jprob, _), (prob, _) = (jba.build_problem(**edges, **caps),
                             local_ba.build_problem(**edges, **caps, device="cpu"))
    return jprob, prob, poses


def _object_dof(P_cap=8):
    """The object BA's mask: translation and yaw free, roll and pitch frozen."""
    dof = np.zeros((P_cap, 6), np.float32)
    dof[:, :3] = 1.0
    dof[:, 4] = 1.0
    return dof


def _priors_args(poses, weight=50.0):
    """Constant-motion priors between consecutive poses, from their true
    relative motion (what the object system builds from its velocity)."""
    idx = np.stack([np.arange(len(poses) - 1), np.arange(1, len(poses))], 1)
    T_rel = np.stack([poses[i + 1] @ np.linalg.inv(poses[i]) for i in range(len(poses) - 1)])
    return dict(idx=idx, T_rel=T_rel.astype(np.float32), weight=np.full(len(idx), weight))


def _assert_ba_close(got, want):
    """tests/test_torch_mapping.py's BA bounds."""
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-3)


def test_build_motion_priors_equals_reference():
    _, _, poses = _problem(1)
    args = _priors_args(poses)
    want = jba.build_motion_priors(**args, R_cap=8)
    got = local_ba.build_motion_priors(**args, R_cap=8, device="cpu")
    for name, w in want._asdict().items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w), err_msg=name)
    empty = local_ba.empty_motion_priors(8, device="cpu")
    for name, w in jba.empty_motion_priors(8)._asdict().items():
        np.testing.assert_array_equal(getattr(empty, name).numpy(), np.asarray(w), err_msg=name)


def test_bundle_adjust_with_priors_matches_reference():
    jprob, prob, poses = _problem(2, dof=_object_dof())
    args = _priors_args(poses)
    want = jba.bundle_adjust(jprob, FX, FY, CX, CY, BF,
                             priors=jba.build_motion_priors(**args, R_cap=8))
    got = local_ba.bundle_adjust(prob, FX, FY, CX, CY, BF,
                                 priors=local_ba.build_motion_priors(**args, R_cap=8,
                                                                     device="cpu"))
    _assert_ba_close(got, want)
    # roll and pitch stay frozen
    R0, R1 = prob.poses[1, :3, :3].numpy(), got.poses[1, :3, :3].numpy()
    assert abs(R1[1, 1] - R0[1, 1]) < 1e-6


def test_bundle_adjust_batched_matches_reference():
    """A two-problem stack with the object dof mask, priors on the first
    problem and the empty filler on the second, as process_object_tasks
    stacks them; and the same stack without priors."""
    (jp1, p1, poses1), (jp2, p2, _) = (_problem(3, dof=_object_dof()),
                                       _problem(4, dof=_object_dof(), n_poses=4))
    args = _priors_args(poses1)
    jstack, stack = jba.stack_problems([jp1, jp2]), local_ba.stack_problems([p1, p2])
    jpri = jba.stack_problems([jba.build_motion_priors(**args, R_cap=8),
                               jba.empty_motion_priors(8)])
    pri = local_ba.stack_problems([local_ba.build_motion_priors(**args, R_cap=8, device="cpu"),
                                   local_ba.empty_motion_priors(8, device="cpu")])
    _assert_ba_close(local_ba.bundle_adjust_batched(stack, FX, FY, CX, CY, BF, priors=pri),
                     jba.bundle_adjust_batched(jstack, FX, FY, CX, CY, BF, priors=jpri))
    got = local_ba.bundle_adjust_batched(stack, FX, FY, CX, CY, BF)
    _assert_ba_close(got, jba.bundle_adjust_batched(jstack, FX, FY, CX, CY, BF))
    # each lane is its own problem: the second equals its solve alone
    alone = local_ba.bundle_adjust(p2, FX, FY, CX, CY, BF)
    np.testing.assert_allclose(got.poses[1].numpy(), alone.poses.numpy(), rtol=0, atol=1e-6)


def test_bundle_adjust_repeats_bit_for_bit():
    """Two solves of one problem give the same bits: the pose-block and
    coupling sums run in a fixed order (one-hot GEMMs, no scatter-add)."""
    _, prob, poses = _problem(5, dof=_object_dof())
    pri = local_ba.build_motion_priors(**_priors_args(poses), R_cap=8, device="cpu")
    a = local_ba.bundle_adjust(prob, FX, FY, CX, CY, BF, priors=pri)
    b = local_ba.bundle_adjust(prob, FX, FY, CX, CY, BF, priors=pri)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# --------------------------------------------------------------------------
# objects.py and the SE(3) log
# --------------------------------------------------------------------------

def _mk_track(pkg, n_kfs=5, n_pts=6):
    """tests/test_object_kf_culling.py's fixture in either package: every
    keyframe observes every point."""
    track = pkg.ObjectTrack(track_id=0, dims=np.array([1.6, 1.5, 3.5]), max_points=32)
    rows = track.alloc_points(n_pts)
    track.pt_first_okf[rows] = 0
    for i in range(n_kfs):
        T_co = np.eye(4)
        T_co[:3, 3] = [0.1 * i, 0, 5.0]
        F = len(rows)
        track.keyframes.append(pkg.ObjectKeyFrameRec(
            obj_kf_id=i, frame_id=i * 2, T_co=T_co, T_cw=np.eye(4),
            xy=np.zeros((F, 2), np.float32), level=np.zeros(F, np.int32),
            desc=np.zeros((F, 8), np.uint32), angle=np.zeros(F, np.float32),
            depth=np.full(F, 5.0, np.float32), u_right=np.zeros(F, np.float32),
            point_idx=np.asarray(rows, np.int64)))
        track.obs[rows, i] = True
        track.rel_pose_log[i * 2] = (i, np.eye(4))
    return track


def _edit_fixture(case, track):
    """The edits of test_object_kf_culling.py's cases, then the removal."""
    if case == "rebased rel pose":
        T_rel = np.eye(4)
        T_rel[:3, 3] = [0.5, 0.2, -0.1]
        track.rel_pose_log[99] = (2, T_rel)
        track.remove_keyframes([2])
    elif case == "first okf falls to a survivor":
        extra = track.alloc_points(1)
        track.pt_first_okf[extra] = 1
        track.obs[extra, [1, 2, 3]] = True
        track.remove_keyframes([1])
    elif case == "lonely points culled":
        lonely = track.alloc_points(1)
        track.pt_first_okf[lonely] = 2
        track.obs[lonely, 2] = True
        track.keyframes[2].point_idx = np.concatenate([track.keyframes[2].point_idx, lonely])
        track.remove_keyframes([2])
    elif case == "first and out of range kept":
        track.remove_keyframes([0, -1, 99])
    else:
        track.remove_keyframes([2, 3])


def _state(track):
    out = {f.name: getattr(track, f.name) for f in dataclasses.fields(track)
           if f.name not in ("keyframes", "rel_pose_log", "detections", "poses_cf",
                             "poses_world")}
    out["keyframes"] = [(k.obj_kf_id, k.frame_id, k.T_co, k.point_idx) for k in track.keyframes]
    out["rel_pose_log"] = sorted((f, a, T_.tolist()) for f, (a, T_) in track.rel_pose_log.items())
    out["covisible"] = [track.covisible_keyframes(i, min_weight=1).tolist()
                        for i in range(len(track.keyframes))]
    return out


@pytest.mark.parametrize("case", ["compaction", "rebased rel pose",
                                  "first okf falls to a survivor", "lonely points culled",
                                  "first and out of range kept"])
def test_object_track_keyframe_removal_equals_reference(case):
    got, want = _mk_track(objects), _mk_track(jobjects)
    _edit_fixture(case, got)
    _edit_fixture(case, want)
    g, w = _state(got), _state(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_equal(g[k], w[k], err_msg=k)


def test_object_keyframe_culling_equals_reference():
    """ObjectSystem._cull_object_keyframes on the redundant 6-keyframe
    fixture (test_object_kf_culling.py::TestCullingRule)."""
    jo = JSystem(JSystemConfig(slot_mode=JSLOTMode.OFFLINE))._object_system
    o = ObjectSystem(SystemConfig(slot_mode=SLOTMode.OFFLINE), None, device="cpu")
    got, want = _mk_track(objects, n_kfs=6), _mk_track(jobjects, n_kfs=6)
    o._cull_object_keyframes(got)
    jo._cull_object_keyframes(want)
    assert len(got.keyframes) == len(want.keyframes) < 6
    np.testing.assert_equal(_state(got), _state(want))


def test_object_track_velocity_and_prediction_match_reference():
    """update_velocity across gaps of 1 and 3 frames (the SE(3) log/exp
    root of a multi-frame motion), then predict_pose_cf."""
    rng = np.random.default_rng(13)
    V = np.asarray(jse3.se3_exp(jnp.asarray([0.1, 0.0, 0.8, 0.0, 0.05, 0.0], jnp.float32)),
                   np.float64)
    tracks = [pkg.ObjectTrack(track_id=1, dims=np.ones(3)) for pkg in (objects, jobjects)]
    T_wo = np.eye(4)
    T_wo[:3, 3] = [2.0, 0.5, 10.0]
    for f in (0, 1, 4):
        for t in tracks:
            t.poses_world[f] = np.linalg.matrix_power(V, f) @ T_wo
    T_cw = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(scale=0.1, size=6), jnp.float32)),
                      np.float64)
    for a, b in ((0, 1), (1, 4)):
        for t in tracks:
            t.update_velocity(a, b)
            t.last_seen_frame = b
        np.testing.assert_allclose(tracks[0].velocity_world, tracks[1].velocity_world,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tracks[0].predict_pose_cf(b + 2, T_cw),
                                   tracks[1].predict_pose_cf(b + 2, T_cw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tracks[0].velocity_world, V, rtol=0, atol=1e-4)


def test_se3_log_matches_reference():
    """Random motions, small angles (the Taylor branch) and rotations near
    pi (the quaternion's other pivots)."""
    rng = np.random.default_rng(14)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[:16, 3:] *= 1e-5
    axis = rng.normal(size=(16, 3))
    xi[16:32, 3:] = (axis / np.linalg.norm(axis, axis=1, keepdims=True)
                     * (np.pi - rng.uniform(1e-3, 0.05, (16, 1))))
    Ts = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    want = np.asarray(jse3.se3_log(jnp.asarray(Ts)))
    got = se3.se3_log(T(Ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(se3.vee(se3.hat(T(xi[:, 3:]))).numpy(), xi[:, 3:])
