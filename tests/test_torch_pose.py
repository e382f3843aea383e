"""Projection matching and the pose LM, port against reference, on the
same numpy-seeded inputs (JAX on the CPU, the port with device="cpu")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.slam import matchers as jmatch
from pointslot_tpu.solvers import pose_opt as jpose
from pointslot_torch.slam import matchers
from pointslot_torch.solvers import pose_opt

FX, FY, CX, CY, BF = 721.5, 721.5, 609.6, 172.9, 384.4
W, H = 1242, 375
SCALES = np.asarray([1.2 ** i for i in range(8)], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _match_case(rng, M=256, N=600):
    """Map points, the features they project to (jittered, a few bits
    flipped) and distractor features."""
    pts = np.stack([rng.uniform(-8, 8, M), rng.uniform(-2, 2, M),
                    rng.uniform(4, 30, M)], axis=1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    xi = (rng.normal(size=6) * 0.02).astype(np.float32)
    T_cw = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1)
    feat_xy = rng.uniform([0, 0], [W, H], (N, 2)).astype(np.float32)
    feat_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    take = rng.permutation(N)[:M]
    feat_xy[take] = uv + rng.normal(scale=1.5, size=(M, 2))
    flips = np.uint32(1) << rng.integers(0, 32, (M, 8)).astype(np.uint32)
    feat_desc[take] = desc ^ np.where(rng.random((M, 8)) < 0.5, flips, 0).astype(np.uint32)
    feat_level = rng.integers(0, 3, N).astype(np.int32)
    feat_valid = rng.random(N) < 0.95
    pt_valid = rng.random(M) < 0.95
    pred_level = rng.integers(0, 3, M).astype(np.int32)
    return pts, desc, pt_valid, T_cw, feat_xy, feat_level, feat_desc, feat_valid, pred_level


@pytest.mark.parametrize("radius, window", [(7.0, 2), (4.0, 2), (7.0, 8)])
def test_project_and_match_bindings_identical(rng, radius, window):
    """Integer logic on the same inputs: bindings are identical."""
    pts, desc, pv, T_cw, fxy, flv, fdesc, fval, plv = _match_case(rng)
    M = pts.shape[0]
    want = jmatch.project_and_match(
        jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(pv), jnp.asarray(T_cw),
        jnp.asarray(fxy), jnp.asarray(flv), jnp.asarray(fdesc), jnp.asarray(fval),
        jnp.full((M,), radius, jnp.float32), jnp.asarray(SCALES), jnp.asarray(plv),
        fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H,
        th_desc=jmatch.TH_HIGH, level_window=jnp.int32(window))
    got = matchers.project_and_match(
        T(pts)[None], T(desc.view(np.int32))[None], T(pv)[None], T(T_cw)[None],
        T(fxy), T(flv), T(fdesc.view(np.int32)), T(fval), radius, T(SCALES),
        T(plv)[None], FX, FY, CX, CY, W, H, th_desc=matchers.TH_HIGH,
        level_window=window)
    pf = np.asarray(want.point_for_feature)
    assert (pf >= 0).sum() > 100
    np.testing.assert_array_equal(got.point_for_feature[0].numpy(), pf)
    assert int(got.n_matches[0]) == int(want.n_matches)
    np.testing.assert_array_equal(got.visible[0].numpy(), np.asarray(want.visible))


def _problem(rng, n_pts=200, noise=0.3, n_outliers=0, xi_scale=0.1):
    """As tests/test_pose_opt.py::make_problem, in numpy form."""
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-3, 2, n_pts),
                    rng.uniform(4, 40, n_pts)], axis=1).astype(np.float32)
    xi_true = rng.normal(size=6).astype(np.float32) * xi_scale
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi_true)))
    pc = (T_true[:3, :3] @ pts.T).T + T_true[:3, 3]
    obs = np.asarray(jse3.project_stereo(jnp.asarray(pc), FX, FY, CX, CY, BF))
    obs = obs + rng.normal(size=(n_pts, 3)).astype(np.float32) * noise
    if n_outliers:
        idx = rng.choice(n_pts, n_outliers, replace=False)
        obs[idx, :2] += rng.uniform(30, 80, size=(n_outliers, 2)) * np.sign(
            rng.normal(size=(n_outliers, 2)))
    xi0 = rng.normal(size=6).astype(np.float32) * 0.03
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(xi0))) @ T_true).astype(np.float32)
    return dict(T0=T0, pts=pts, obs=obs.astype(np.float32),
                is_stereo=np.ones(n_pts, bool), inv_sigma2=np.ones(n_pts, np.float32),
                valid=np.ones(n_pts, bool))


def _solve_both(probs):
    """JAX: pose_optimize vmapped over the problems; port: one batched call."""
    keys = ("pts", "obs", "is_stereo", "inv_sigma2", "valid")
    edges = jpose.PoseObs(*[jnp.asarray(np.stack([p[k] for p in probs])) for k in keys])
    T0 = jnp.asarray(np.stack([p["T0"] for p in probs]))
    want = jax.vmap(lambda t, e: jpose.pose_optimize(t, e, FX, FY, CX, CY, BF))(T0, edges)
    got = pose_opt.pose_optimize(T(np.asarray(T0)),
                                 *[T(np.asarray(x)) for x in edges], FX, FY, CX, CY, BF)
    return want, got


@pytest.mark.parametrize("case", ["clean", "outliers", "mono"])
def test_pose_optimize_matches_reference(rng, case):
    """The tests/test_pose_opt.py cases: T agrees to 1e-4 (float32 LM with
    sums in another order) and the inlier masks are equal."""
    if case == "clean":
        p = _problem(rng, noise=0.0)
    elif case == "outliers":
        p = _problem(rng, n_pts=300, noise=0.3, n_outliers=60)
    else:
        p = _problem(rng, n_pts=150, noise=0.1)
        p["obs"][:, 2] += 500.0
        p["is_stereo"][:] = False
    edges = jpose.PoseObs(*[jnp.asarray(p[k]) for k in
                            ("pts", "obs", "is_stereo", "inv_sigma2", "valid")])
    want = jpose.pose_optimize(jnp.asarray(p["T0"]), edges, FX, FY, CX, CY, BF)
    got = pose_opt.pose_optimize(T(p["T0"])[None], *[T(np.asarray(x))[None] for x in edges],
                                 FX, FY, CX, CY, BF)
    np.testing.assert_allclose(got.T[0].numpy(), np.asarray(want.T), atol=1e-4)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers[0]) == int(want.n_inliers)


def test_pose_optimize_batched_objects(rng):
    """Object-style batch (B = 3) with outliers, masked-out edges and mono
    edges: the per-lane freeze equals JAX's vmapped early exit."""
    probs = [_problem(rng, n_pts=120, noise=0.2, n_outliers=10),
             _problem(rng, n_pts=120, noise=0.5, xi_scale=0.2),
             _problem(rng, n_pts=120, noise=0.0)]
    probs[1]["valid"][60:] = False
    probs[2]["is_stereo"][::2] = False
    want, got = _solve_both(probs)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
