"""The object path's two matching options against the JAX package, on the
CPU: pointslot_torch's ``ops/gms.py::gms_filter`` and
``slam/matchers.py::guided_match`` against pointslot_tpu's on the same
seeded inputs.

Tolerances: none. The GMS votes are integers in float32 (sums exact in any
order), and the guided match is integer logic over Hamming distances, so
the keep masks, the bindings and the match counts are equal bit for bit.
The GMS neighbourhood sums wrap around the grid's edges in both packages
(``jnp.roll`` / ``torch.roll``); ``test_gms_wraparound_support`` shows the
port keeps that quirk of the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.ops import gms as jgms
from pointslot_tpu.slam import matchers as jmatchers
from pointslot_torch.ops import gms
from pointslot_torch.slam import matchers

W, H = 1242, 375


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _matches(rng, n, outliers=0.3, invalid=0.2):
    """n matches: clustered consistent motion plus random outliers, some
    endpoints off the image, some invalid."""
    xa = rng.uniform(-20, [W + 20, H + 20], (n, 2)).astype(np.float32)
    xb = (xa + rng.normal(0, 3, (n, 2)) + rng.uniform(-60, 60, 2)).astype(np.float32)
    out = rng.random(n) < outliers
    xb[out] = rng.uniform(0, [W, H], (int(out.sum()), 2))
    return xa, xb, rng.random(n) >= invalid


@pytest.mark.parametrize("seed", range(4))
def test_gms_filter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (64, 512):
        xa, xb, valid = _matches(rng, n)
        want = np.asarray(jgms.gms_filter(jnp.asarray(xa), jnp.asarray(xb),
                                          jnp.asarray(valid), W, H))
        got = gms.gms_filter(_t(xa), _t(xb), _t(valid), W, H).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < valid.sum()


def test_gms_filter_batched_matches_reference():
    """The port's batched form against the reference's vmap over lanes."""
    rng = np.random.default_rng(7)
    lanes = [_matches(rng, 512, outliers=o) for o in (0.1, 0.3, 0.6)]
    xa, xb, valid = (np.stack(x) for x in zip(*lanes))
    want = np.asarray(jax.vmap(lambda a, b, v: jgms.gms_filter(a, b, v, W, H))(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(valid)))
    got = gms.gms_filter(_t(xa), _t(xb), _t(valid), W, H).numpy()
    np.testing.assert_array_equal(got, want)


def _two_groups(a0, a1, b, n=2):
    """n matches from a-end a0 and n from a-end a1, all ending at b."""
    xa = np.array([a0] * n + [a1] * n, np.float32)
    return xa, np.array([b] * (2 * n), np.float32)


def test_gms_wraparound_support():
    """Two pairs of matches whose a-ends sit at opposite edges of the grid
    (cell column 0 and 19; row 0 and 19) and whose b-ends share a cell
    support each other through the wrap: each match then scores 2n - 1 = 3
    against tau = 3 sqrt(2n / 9) = 2 and is kept, in the reference and in
    the port alike. The same pairs two columns apart inside the grid score
    n - 1 = 1 against tau = sqrt(2) and are dropped."""
    groups = [_two_groups([5.0, 150.0], [W - 5.0, 150.0], [600.0, 150.0]),
              _two_groups([300.0, 2.0], [300.0, H - 2.0], [900.0, 300.0])]
    inner = [_two_groups([340.0, 150.0], [900.0, 150.0], [600.0, 150.0]),
             _two_groups([300.0, 100.0], [300.0, 300.0], [900.0, 300.0])]
    for case, expect in ((groups, True), (inner, False)):
        xa = np.concatenate([g[0] for g in case])
        xb = np.concatenate([g[1] for g in case])
        valid = np.ones(len(xa), bool)
        want = np.asarray(jgms.gms_filter(jnp.asarray(xa), jnp.asarray(xb),
                                          jnp.asarray(valid), W, H))
        got = gms.gms_filter(_t(xa), _t(xb), _t(valid), W, H).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want == expect).all(), (expect, want)


def _guided_inputs(rng, M, N, ties=True):
    pt_desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    src = rng.integers(0, M, N)
    feat_desc = pt_desc[src].copy()
    flips = (rng.random((N, 8)) < 0.05).astype(np.uint32) * rng.integers(
        0, 2 ** 32, (N, 8), dtype=np.uint32)
    feat_desc ^= flips
    if ties:
        # duplicated points and features: equal distances to break by index
        pt_desc[M // 2: M // 2 + 8] = pt_desc[:8]
        feat_desc[N // 2: N // 2 + 8] = feat_desc[:8]
    pred_xy = rng.uniform(0, 80, (M, 2)).astype(np.float32)
    feat_xy = rng.integers(0, 80, (N, 2)).astype(np.float32)
    feat_xy[: min(M, N)] = np.round(pred_xy[: min(M, N)])   # exact window edges too
    return (pred_xy, rng.random(M) < 0.9, pt_desc, feat_xy, feat_desc, rng.random(N) < 0.9)


@pytest.mark.parametrize("seed", range(3))
def test_guided_match_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    for M, N in ((300, 400), (512, 512)):
        args = _guided_inputs(rng, M, N)
        want = jmatchers.guided_match(*(jnp.asarray(a) for a in args), radius=5.0,
                                      th_desc=130)
        got = matchers.guided_match(*(_t(a) for a in args), radius=5.0, th_desc=130)
        np.testing.assert_array_equal(got.point_for_feature.numpy(),
                                      np.asarray(want.point_for_feature))
        assert int(got.n_matches) == int(want.n_matches) > 0


def test_guided_match_batched_matches_reference_vmap():
    """The object-axis form: one (O, P, N) table against the reference's
    jax.vmap(guided_match) (object_system._guided_batched)."""
    rng = np.random.default_rng(9)
    lanes = [_guided_inputs(rng, 512, 512, ties=bool(i % 2)) for i in range(3)]
    args = [np.stack(x) for x in zip(*lanes)]

    def one(*a):
        r = jmatchers.guided_match(*a, radius=5.0, th_desc=130)
        return r.point_for_feature, r.n_matches

    pf, n = jax.vmap(one)(*(jnp.asarray(a) for a in args))
    got = matchers.guided_match(*(_t(a) for a in args), radius=5.0, th_desc=130)
    np.testing.assert_array_equal(got.point_for_feature.numpy(), np.asarray(pf))
    np.testing.assert_array_equal(got.n_matches.numpy(), np.asarray(n))
