"""The mapping side of the port against the JAX package on the same inputs:
pointslot_torch's brute_match, triangulate, build_problem, bundle_adjust
and MapState (device="cpu") against pointslot_tpu's (JAX on the CPU).

Tolerances and why:
- brute_match: exactly equal (idx_b_for_a, n_matches). Integer Hamming
  tables, first-index argmin ties on both sides, a float32 ratio test on
  integers, and the same float32 rotation bins;
- build_problem: exactly equal, every field and slot_edge. It is the same
  host numpy packing;
- triangulate: 1e-4 relative (the point's error over its distance) on
  well-posed pairs, equal well_posed flags. The 4x4 eigenvector comes from
  another LAPACK call; its sign cancels;
- bundle_adjust: poses within 1e-4 (matrix entries), points within 1e-3 m
  plus 1e-4 of the coordinate (a point 30 m out on a 0.5 m baseline is
  weakly held in depth, and the outlier case moved one such point by
  2.3 mm), obs_inlier equal, cost within 1e-3 relative. The pose-block
  sums run through index_add_ where JAX contracts a one-hot: float32 sums
  in another order over 15 LM iterations;
- MapState: equal arrays after the same sequence of operations (a copy).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.geometry import triangulation as jtri
from pointslot_tpu.slam import matchers as jmatchers
from pointslot_tpu.slam.map_state import MapState as JMapState
from pointslot_tpu.solvers import local_ba as jba
from pointslot_torch import convert
from pointslot_torch.geometry import triangulation
from pointslot_torch.slam import matchers
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.solvers import local_ba

FX, FY, CX, CY, BF = 721.5, 721.5, 609.6, 172.9, 384.4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores
    many times over. The port's CPU runs here take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# brute_match
# --------------------------------------------------------------------------

def _planted_descriptors(seed: int, NA: int = 300, NB: int = 280):
    """Random descriptors with planted matches: 200 rows of A are rows of B
    with 0-40 bits flipped, rotated by one of three angles (plus noise) so
    the rotation histogram has dominant bins; some rows are invalid."""
    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 2**32, (NB, 8), dtype=np.uint32)
    desc_a = rng.integers(0, 2**32, (NA, 8), dtype=np.uint32)
    angle_b = rng.uniform(0, 2 * np.pi, NB).astype(np.float32)
    angle_a = rng.uniform(0, 2 * np.pi, NA).astype(np.float32)
    rows_a = rng.choice(NA, 200, replace=False)
    rows_b = rng.choice(NB, 200, replace=False)
    for ra, rb in zip(rows_a, rows_b):
        bits = np.unpackbits(desc_b[rb].view(np.uint8))
        flip = rng.choice(256, rng.integers(0, 41), replace=False)
        bits[flip] ^= 1
        desc_a[ra] = np.packbits(bits).view(np.uint32)
        rot = rng.choice([0.3, 0.35, 2.0, -1.0]) + rng.normal(scale=0.05)
        angle_a[ra] = angle_b[rb] + rot
    valid_a = rng.random(NA) > 0.05
    valid_b = rng.random(NB) > 0.05
    return desc_a, angle_a, valid_a, desc_b, angle_b, valid_b


@pytest.mark.parametrize("check_rotation", [True, False])
@pytest.mark.parametrize("nn_ratio", [0.6, 0.7, 0.9])
def test_brute_match_equals_reference(check_rotation, nn_ratio):
    args = _planted_descriptors(seed=int(nn_ratio * 10) + 3 * check_rotation)
    want = jmatchers.brute_match(*[jnp.asarray(a) for a in args], nn_ratio=nn_ratio,
                                 th_desc=jmatchers.TH_LOW, check_rotation=check_rotation)
    da, aa, va, db, ab, vb = args
    got = matchers.brute_match(
        convert.to_tensor(da, torch.int32, "cpu"), torch.from_numpy(aa), torch.from_numpy(va),
        convert.to_tensor(db, torch.int32, "cpu"), torch.from_numpy(ab), torch.from_numpy(vb),
        nn_ratio=nn_ratio, th_desc=matchers.TH_LOW, check_rotation=check_rotation)
    np.testing.assert_array_equal(got.idx_b_for_a.numpy(), np.asarray(want.idx_b_for_a))
    assert int(got.n_matches) == int(want.n_matches)
    assert int(want.n_matches) > 20   # the planted matches are found


# --------------------------------------------------------------------------
# triangulate
# --------------------------------------------------------------------------

def test_triangulate_matches_reference():
    """Two views 0.5-1.5 m apart of points 4-40 m away (the mapper's far
    tail), with 0.3 px of noise, in float32 as the mapper passes them."""
    rng = np.random.default_rng(5)
    n = 256
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    T1 = np.eye(4)
    T2 = np.eye(4)
    T2[:3, 3] = [-rng.uniform(0.5, 1.5), 0.02, -0.3]
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(4, 40, n)], 1)
    uv = []
    for T in (T1, T2):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv.append((pc[:, :2] / pc[:, 2:] * [FX, FY] + [CX, CY]
                   + rng.normal(scale=0.3, size=(n, 2))).astype(np.float32))
    P1 = np.broadcast_to((K @ T1[:3, :4]).astype(np.float32), (n, 3, 4))
    P2 = np.broadcast_to((K @ T2[:3, :4]).astype(np.float32), (n, 3, 4))
    want_X, want_ok = (np.asarray(a) for a in jtri.triangulate(
        jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    got_X, got_ok = triangulation.triangulate(
        torch.from_numpy(P1.copy()), torch.from_numpy(P2.copy()),
        torch.from_numpy(uv[0]), torch.from_numpy(uv[1]))
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert want_ok.all()
    # relative to each point's distance (a coordinate near 0 has no scale)
    rel = np.linalg.norm(got_X.numpy() - want_X, axis=1) / np.linalg.norm(want_X, axis=1)
    assert rel.max() <= 1e-4, rel.max()


# --------------------------------------------------------------------------
# build_problem + bundle_adjust on test_local_ba.py's synthetic problem
# --------------------------------------------------------------------------

def _edges(seed: int, n_poses=6, n_points=300, pose_noise=0.02, point_noise=0.05,
           corrupt_frac=0.0):
    """tests/test_local_ba.py::make_problem's construction, as flat edge
    arrays: a camera moving forward through points in front of it, stereo
    observations with 0.2 px of noise, perturbed initial poses and points,
    the first pose true; `corrupt_frac` of the edges moved 20-60 px."""
    rng = np.random.default_rng(seed)
    poses_true = []
    T = np.eye(4)
    for _ in range(n_poses):
        poses_true.append(T.copy())
        step = np.asarray(jse3.se3_exp(jnp.asarray(
            [0.02 * rng.normal(), 0.02 * rng.normal(), -1.0, 0, 0.01 * rng.normal(), 0],
            jnp.float32)))
        T = step @ T
    pts = np.stack([rng.uniform(-10, 10, n_points), rng.uniform(-3, 2, n_points),
                    rng.uniform(5, 30 + n_poses, n_points)], axis=1).astype(np.float32)
    e_pose, e_point, e_obs = [], [], []
    for p, Tcw in enumerate(poses_true):
        pc = (Tcw[:3, :3] @ pts.T).T + Tcw[:3, 3]
        z = pc[:, 2]
        u = FX * pc[:, 0] / z + CX
        v = FY * pc[:, 1] / z + CY
        ok = (z > 1) & (u > 0) & (u < 1242) & (v > 0) & (v < 375)
        for l in np.nonzero(ok)[0]:
            obs = np.array([u[l], v[l], u[l] - BF / z[l]])
            obs[:2] += rng.normal(size=2) * 0.2
            e_pose.append(p)
            e_point.append(l)
            e_obs.append(obs)
    E = len(e_pose)
    e_obs = np.stack(e_obs)
    if corrupt_frac > 0:
        bad = rng.choice(E, int(E * corrupt_frac), replace=False)
        e_obs[bad, :2] += rng.uniform(20, 60, size=(len(bad), 2))
    poses_init = [poses_true[0]] + [
        np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32)
                                            * pose_noise))) @ Tt
        for Tt in poses_true[1:]]
    stereo = rng.random(E) > 0.3    # a mix of stereo and monocular edges
    return dict(
        poses=np.stack(poses_init).astype(np.float32),
        pose_fixed=[True] + [False] * (n_poses - 1),
        points=pts + rng.normal(size=pts.shape).astype(np.float32) * point_noise,
        e_pose=np.asarray(e_pose), e_point=np.asarray(e_point), e_obs=e_obs,
        e_stereo=stereo, e_inv_sigma2=rng.choice([1.0, 1 / 1.44, 1 / 2.0736], E),
    )


CASES = {
    "converge": dict(seed=1),
    "outliers": dict(seed=2, corrupt_frac=0.1),
    "fixed-pose, dof mask": dict(seed=3, pose_noise=0.0, point_noise=0.02),
}


def _build_both(case: str, P_cap=8, L_cap=512, K=8):
    kw = dict(CASES[case])
    dof = None
    if case.startswith("fixed"):
        dof = np.ones((P_cap, 6), np.float32)
        dof[:, 3] = 0.0
        dof[:, 5] = 0.0
    e = _edges(**kw)
    caps = dict(P_cap=P_cap, L_cap=L_cap, K=K, dof_mask=dof)
    return jba.build_problem(**e, **caps), local_ba.build_problem(**e, **caps, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_build_problem_equals_reference(case):
    """K = 4 drops the observations beyond 4 per point on both sides."""
    (jprob, jslot), (prob, slot) = _build_both(case, K=4)
    np.testing.assert_array_equal(slot, jslot)
    for name, want in jprob._asdict().items():
        got = getattr(prob, name).numpy()
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_reference(case):
    (jprob, _), (prob, _) = _build_both(case)
    want = jba.bundle_adjust(jprob, FX, FY, CX, CY, BF)
    got = local_ba.bundle_adjust(prob, FX, FY, CX, CY, BF)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    # the fixed first pose is held exactly
    np.testing.assert_array_equal(got.poses[0].numpy(), prob.poses[0].numpy())
    if case == "outliers":
        assert (~got.obs_inlier.numpy() & prob.obs_valid.numpy()).sum() > 50


# --------------------------------------------------------------------------
# MapState
# --------------------------------------------------------------------------

def _drive_map(m, rng):
    """The same sequence of operations on either MapState: allocate and
    bind keyframes and points, unbind points, remove a keyframe, fill the
    keyframe table to eviction. Returns the covisibility queries' answers."""
    answers = []
    for _ in range(6):
        kf = m.alloc_keyframe()
        m.kf_frame_id[kf] = kf * 3
        pts = m.alloc_points(40)
        m.pt_pos[pts] = rng.normal(size=(len(pts), 3))
        feats = rng.choice(m.feats_per_kf, len(pts), replace=False)
        m.bind(kf, feats, pts)
        # re-observe some points of the earlier keyframes
        old = np.nonzero(m.pt_valid)[0]
        again = rng.choice(old, 30, replace=False)
        free_feats = np.setdiff1d(np.arange(m.feats_per_kf), feats)[:30]
        m.bind(kf, free_feats, again)
        answers.append(m.covisible_keyframes(kf, min_weight=2).tolist())
    m.unbind_point(np.nonzero(m.pt_valid)[0][::7])
    m.remove_keyframe(2)
    answers.append(m.covisible_keyframes(3, min_weight=1, max_n=3).tolist())
    for _ in range(m.max_kfs):   # fills the table, then evicts
        kf = m.alloc_keyframe()
        m.kf_frame_id[kf] = 100 + kf
    answers.append(m.keyframe_ids().tolist())
    answers.append(m.points_of_keyframes([0, 1, 3]).tolist())
    return answers


def test_map_state_copy_equals_reference():
    jm = JMapState(max_kfs=8, max_points=512, feats_per_kf=128)
    m = MapState(max_kfs=8, max_points=512, feats_per_kf=128)
    want = _drive_map(jm, np.random.default_rng(9))
    got = _drive_map(m, np.random.default_rng(9))
    assert got == want
    for f in dataclasses.fields(JMapState):
        a, b = getattr(m, f.name), getattr(jm, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    # and the port's copy of the reference's tables is field-equal
    c = convert.map_state_from_arrays(jm)
    for f in dataclasses.fields(JMapState):
        b = getattr(jm, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(getattr(c, f.name), b, err_msg=f.name)
    assert c.alloc_keyframe() == jm.alloc_keyframe()
