"""The padding of the graphed camera pose solve (solvers/pose_opt.py), on
the CPU: a solve padded to its bucket with invalid copies of its first edge
against the unpadded solve and the JAX package's pose_optimize, and the
entry point against the eager body. The graph itself runs only on a card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.solvers import pose_opt as jpose
from pointslot_torch.slam import tracking
from pointslot_torch.solvers import pose_opt

FX, FY, CX, CY, BF = 721.5377, 721.5377, 609.5593, 172.854, 384.38148
CAM = dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF)
SIZES = (10, 17, 600, 1500)


def _problem(seed: int, m: int):
    """A camera-like solve of m edges: stereo and mono edges over 8 pyramid
    levels, 0.5 px noise, a tenth of the edges moved off by 30-80 px."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, m), rng.uniform(-3, 2, m),
                    rng.uniform(4, 40, m)], axis=1).astype(np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.1)))
    pc = (T_true[:3, :3] @ pts.T).T + T_true[:3, 3]
    obs = np.asarray(jse3.project_stereo(jnp.asarray(pc), FX, FY, CX, CY, BF))
    obs = obs + rng.normal(size=(m, 3)).astype(np.float32) * 0.5
    bad = rng.choice(m, m // 10, replace=False)
    obs[bad, :2] += rng.uniform(30, 80, (len(bad), 2)) * np.sign(rng.normal(size=(len(bad), 2)))
    is_stereo = rng.random(m) < 0.7
    level = rng.integers(0, 8, m)
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.03)))
          @ T_true).astype(np.float32)
    return dict(T0=T0, pts=pts, obs=obs.astype(np.float32), is_stereo=is_stereo,
                inv_sigma2=(1.2 ** (-2.0 * level)).astype(np.float32),
                valid=np.ones(m, bool))


def _edges(p):
    """The port's (T_init, pts, obs, is_stereo, inv_sigma2, valid), B = 1."""
    return tuple(torch.from_numpy(np.array(p[k]))[None] for k in
                 ("T0", "pts", "obs", "is_stereo", "inv_sigma2", "valid"))


def _padded(edges, n):
    static = tuple(torch.full((1, n) + tuple(x.shape[2:]), 7, dtype=x.dtype)
                   for x in edges[1:])
    static = (torch.zeros_like(edges[0]),) + static
    pose_opt.pad_edges_into(static, edges)
    return static


@pytest.fixture(scope="module")
def oracle():
    """Every size's problem and the JAX package's answer, built once."""
    out = {}
    for m in SIZES:
        p = _problem(m, m)
        want = jpose.pose_optimize(
            jnp.asarray(p["T0"]), jpose.PoseObs(*[jnp.asarray(p[k]) for k in
                                                 ("pts", "obs", "is_stereo", "inv_sigma2",
                                                  "valid")]), FX, FY, CX, CY, BF)
        out[m] = (p, np.asarray(want.T), np.asarray(want.inliers), int(want.n_inliers))
    return out


def test_buckets_cover_the_camera_edge_cap():
    b = pose_opt.GRAPH_BUCKETS
    assert b[0] == 16 and all(y == 2 * x for x, y in zip(b, b[1:]))
    assert b[-2] < tracking.POSE_EDGE_CAP <= b[-1]
    assert [pose_opt.graph_bucket(m) for m in (1, 16, 17, 600, 1024, 1025, 1500, 2048)] == \
        [16, 16, 32, 1024, 1024, 2048, 2048, 2048]


@pytest.mark.parametrize("m", [1, 10, 16, 600])
def test_padding_rows_are_invalid_copies_of_the_first_edge(m):
    edges = _edges(_problem(3, m))
    n = pose_opt.graph_bucket(m)
    static = _padded(edges, n)
    assert torch.equal(static[0], edges[0])
    for dst, src in zip(static[1:5], edges[1:5]):
        assert torch.equal(dst[:, :m], src)
        assert torch.equal(dst[:, m:], src[:, :1].expand_as(dst[:, m:]))
    assert torch.equal(static[5][:, :m], edges[5])
    assert not static[5][:, m:].any()


@pytest.mark.parametrize("m", SIZES)
def test_padded_solve_matches_unpadded_and_reference(oracle, m):
    """Padded to its bucket, the solve agrees with the unpadded one and with
    JAX to today's pose tolerance (1e-4 on T, float32 sums over other
    lengths) with the same inliers; the padding rows are never inliers."""
    p, want_T, want_inl, want_n = oracle[m]
    edges = _edges(p)
    n = pose_opt.graph_bucket(m)
    pad = pose_opt._pose_optimize_eager(*_padded(edges, n), **CAM)
    ref = pose_opt._pose_optimize_eager(*edges, **CAM)
    assert pad.inliers.shape == (1, n) and not pad.inliers[0, m:].any()
    for got in (pad, ref):
        np.testing.assert_allclose(got.T[0].numpy(), want_T, atol=1e-4)
        np.testing.assert_array_equal(got.inliers[0, :m].numpy(), want_inl)
        assert int(got.n_inliers[0]) == want_n
    np.testing.assert_allclose(pad.T.numpy(), ref.T.numpy(), atol=1e-4)
    np.testing.assert_allclose(pad.chi2[:, :m].numpy(), ref.chi2.numpy(), rtol=1e-3, atol=1e-3)
    assert 0.5 * m < want_n < m


@pytest.mark.parametrize("case", ["camera", "objects-with-prior"])
def test_entry_point_is_the_eager_body_on_the_cpu(case):
    """On the CPU, pose_optimize returns what the eager body returns, bit
    for bit, in the camera's form and in the objects' (B = 3, a prior)."""
    if case == "camera":
        edges, kw = _edges(_problem(5, 600)), {}
    else:
        lanes = [_edges(_problem(6 + i, 120)) for i in range(3)]
        edges = tuple(torch.cat(x) for x in zip(*lanes))
        kw = dict(trans_prior=edges[0][:, :3, 3] + 0.05, trans_prior_weight=50.0)
    got = pose_opt.pose_optimize(*edges, **CAM, **kw)
    want = pose_opt._pose_optimize_eager(*edges, **CAM, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
