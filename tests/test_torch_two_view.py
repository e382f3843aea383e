"""The two-view initialiser of the port against the JAX package's, on the CPU.

pointslot_torch.geometry.two_view (CPU tensors) beside pointslot_tpu.
geometry.two_view on tests/test_aux.py:25's scene: 200 points at 4-20 m,
T21 = exp([0.6, 0.05, 0.05, 0.01, 0.08, 0.01]), the first 20 correspondences
pushed 0.05-0.2 off in view 2, K = 128 hypotheses.

- On JAX's own draws (``jax.random.categorical`` per hypothesis key, with
  replacement, as ``reconstruct_two_view`` draws them): the same ``ok``,
  ``used_homography`` and inlier set, T21 within 1e-3 (the eigen- and
  singular-vector solves run in another order; 5.4e-5 measured), and the
  triangulated inliers within 1e-2 m (a point at 20 m on a 0.6 m
  baseline). H, F and E are not compared: their signs are the solver's.
- With the port's own ``torch.Generator``: tests/test_aux.py's gates (ok,
  cos(t) > 0.99, rotation error < 0.02), on three seeds.
- The draws have JAX's semantics: with replacement, only valid rows, a
  repeated row weighted once; all rows invalid gives ``ok`` False, and a
  draw over no valid row falls back to every row (equal logits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.geometry import two_view as jtwo_view
from pointslot_torch.geometry import two_view

N, K = 200, 128
MAX_T21_GAP = 1e-3
MAX_POINT_GAP_M = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_aux.py:25-37's correspondences (its rng fixture, seed 42)."""
    rng = np.random.default_rng(42)
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N), rng.uniform(4, 20, N)], 1)
    T21 = np.asarray(jse3.se3_exp(jnp.asarray([0.6, 0.05, 0.05, 0.01, 0.08, 0.01],
                                              jnp.float32)))
    p1 = pts[:, :2] / pts[:, 2:3]
    pc2 = pts @ T21[:3, :3].T + T21[:3, 3]
    p2 = pc2[:, :2] / pc2[:, 2:3]
    p2[:20] += rng.uniform(0.05, 0.2, size=(20, 2))
    return p1.astype(np.float32), p2.astype(np.float32), T21


def _jax_draws(key, valid):
    """reconstruct_two_view's minimal sets: per hypothesis key, 4 and 8
    categorical draws over logits 0 (valid) / -1e9."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, K)
    draw = lambda m: np.array(jax.vmap(  # noqa: E731
        lambda k: jax.random.categorical(k, logits, shape=(m,)))(keys))
    return draw(4), draw(8)


def _assert_pose(res, T21):
    assert bool(res.ok)
    t_est, t_true = res.T21[:3, 3].numpy(), T21[:3, 3]
    assert np.dot(t_est, t_true) / (np.linalg.norm(t_est) * np.linalg.norm(t_true)) > 0.99
    assert np.abs(res.T21[:3, :3].numpy() @ T21[:3, :3].T - np.eye(3)).max() < 0.02


@pytest.mark.parametrize("case", ["all_valid", "some_invalid"])
def test_on_reference_draws_matches_reference(scene, case):
    p1, p2, T21 = scene
    valid = np.ones(N, bool)
    if case == "some_invalid":
        valid[::7] = False
    key = jax.random.PRNGKey(2)
    want = jtwo_view.reconstruct_two_view(jnp.asarray(p1), jnp.asarray(p2),
                                          jnp.asarray(valid), key)
    idx_h, idx_f = _jax_draws(key, valid)
    got = two_view.reconstruct_two_view_from_sets(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        torch.from_numpy(idx_h), torch.from_numpy(idx_f))
    assert bool(got.ok) == bool(want.ok)
    assert bool(got.used_homography) == bool(want.used_homography)
    inl = np.asarray(want.inliers)
    assert np.array_equal(got.inliers.numpy(), inl)
    assert np.abs(got.T21.numpy() - np.asarray(want.T21)).max() <= MAX_T21_GAP
    assert np.abs(got.points.numpy()[inl] - np.asarray(want.points)[inl]).max() <= MAX_POINT_GAP_M
    _assert_pose(got, T21)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_own_generator_meets_reference_gates(scene, seed):
    p1, p2, T21 = scene
    res = two_view.reconstruct_two_view(torch.from_numpy(p1), torch.from_numpy(p2),
                                        torch.ones(N, dtype=torch.bool),
                                        torch.Generator().manual_seed(seed))
    _assert_pose(res, T21)
    assert not res.inliers[:20].any(), "an outlier correspondence was kept"


def test_draw_semantics():
    valid = torch.zeros(12, dtype=torch.bool)
    valid[[2, 5]] = True
    idx_h, idx_f = two_view.draw_index_sets(valid, 64, 3)
    assert idx_h.shape == (64, 4) and idx_f.shape == (64, 8)
    assert set(idx_h.unique().tolist()) | set(idx_f.unique().tolist()) == {2, 5}
    w = two_view._selection_weights(torch.tensor([[2, 2, 5, 2]]), valid)
    assert w.tolist() == [[0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0]]
    # no valid row: every row is drawn (equal logits), and nothing is weighted
    idx_h, _ = two_view.draw_index_sets(torch.zeros(12, dtype=torch.bool), 64, 3)
    assert len(idx_h.unique()) > 2
    # the same seed draws the same sets
    assert torch.equal(two_view.draw_index_sets(valid, 8, 7)[1],
                       two_view.draw_index_sets(valid, 8, torch.Generator().manual_seed(7))[1])


def test_all_invalid_is_not_ok(scene):
    p1, p2, _ = scene
    res = two_view.reconstruct_two_view(torch.from_numpy(p1), torch.from_numpy(p2),
                                        torch.zeros(N, dtype=torch.bool), 0)
    assert not bool(res.ok) and not res.inliers.any()
    want = jtwo_view.reconstruct_two_view(jnp.asarray(p1), jnp.asarray(p2),
                                          jnp.zeros(N, bool), jax.random.PRNGKey(0))
    assert not bool(want.ok)
