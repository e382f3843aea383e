"""Loop-closing components of the port against the JAX package's, on the CPU.

pointslot_torch's vocabulary, keyframe database, RANSACs, rigid alignment,
pose graph and relocalizer (device="cpu") against pointslot_tpu's (JAX on
the CPU), on the same numpy inputs made from a seed.

Bounds and why:
- word ids, database candidate lists, RANSAC inlier sets: exact (integer
  Hamming distances with first-minimum argmins; the same host numpy on the
  same vectors; the RANSACs are given JAX's own minimal sets, drawn here
  with ``jax.random`` exactly as the reference draws them);
- tf-idf vectors within 1e-6 (their L1 norm sums in another order);
- ``umeyama`` / ``rigid_refine`` within 1e-5 and the rigid RANSAC's pose
  within 1e-4: float32 SVDs from LAPACK through torch and through XLA, on
  sums taken in another order;
- the PnP poses (``pnp_dlt``, ``pnp_ransac``, a relocalization) within
  1e-4, or, where the reference's own float32 DLT lies further than that
  from the float64 solution of the same problem, within twice that
  distance: the DLT takes the null vector of a 12x12 normal matrix whose
  float32 eigh leaves each package up to 1e-2 from the float64 answer on
  these inputs (measured: JAX 8.8e-04 and 7.5e-03, the port 5.9e-05 and
  9.5e-03, apart 9.4e-04 and 2.0e-03), so 1e-4 between them is below the
  method's float32 precision;
- pose-graph poses within 1e-4 (m and rotation entries): 20 float32
  Gauss-Newton steps whose normal equations sum in another order;
- a relocalization from a JAX run's map: the same candidates and PnP
  correspondences, the same outcome, T_cw within 0.05 m and 0.01 (see the
  test).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointslot_tpu import config as jconfig
from pointslot_tpu.datasets import synthetic as jsynthetic
from pointslot_tpu.geometry import pnp as jpnp
from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.slam import loop_closing as jlc
from pointslot_tpu.slam import system as jsystem
from pointslot_tpu.slam.tracking import TrackingState
from pointslot_tpu.solvers import posegraph as jposegraph
from pointslot_tpu.vocab import bow as jbow
from pointslot_torch import convert
from pointslot_torch.geometry import pnp
from pointslot_torch.slam import loop_closing
from pointslot_torch.slam.tracking import FrameRecord
from pointslot_torch.solvers import posegraph
from pointslot_torch.vocab import bow
from test_loop_components import make_loop_problem, perturb_desc, random_desc

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(valid, n_hypotheses: int, m: int, seed: int) -> torch.Tensor:
    """The reference's minimal sets: categorical over equal logits of the
    valid rows of its 512-row padded table, keys split from PRNGKey(seed)."""
    mask = np.zeros(max(loop_closing.MATCH_CAP, len(valid)), bool)
    mask[:len(valid)] = valid
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hypotheses)
    idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(m,)))(keys)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_pnp_close(got, want, exact):
    """The PnP bound: within 1e-4 of the reference's pose, or within twice
    the reference's own distance from the float64 solution `exact`."""
    exact = np.asarray(exact, np.float64)
    bound = max(1e-4, 2.0 * float(np.abs(np.asarray(want, np.float64) - exact).max()))
    gap = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert gap <= bound, (gap, bound)


# ---------------------------------------------------------------------------
# vocabulary and database
# ---------------------------------------------------------------------------

def test_default_vocabulary_equals_reference():
    """The in-repo vocabulary, loaded by both packages: words and idf bit
    for bit."""
    got, want = bow.train_default_vocab(device="cpu"), jbow.train_default_vocab()
    assert got.n_words == want.n_words == 512
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.idf.view(np.uint32), want.idf.view(np.uint32))


def test_vocabulary_train_and_transform_match_reference(rng):
    base = random_desc(rng, 400)
    vocab = bow.BinaryVocabulary.train(base, n_words=64, iters=5, device="cpu")
    jvocab = jbow.BinaryVocabulary.train(base, n_words=64, iters=5)
    np.testing.assert_array_equal(vocab.words, jvocab.words)
    np.testing.assert_array_equal(vocab.idf, jvocab.idf)
    query = np.concatenate([perturb_desc(rng, base[:200], 8), random_desc(rng, 100)])
    valid = rng.random(len(query)) > 0.2
    for v, jv in ((vocab, jvocab), (bow.train_default_vocab(device="cpu"),
                                    jbow.train_default_vocab())):
        vec, words = v.transform(query, valid)
        jvec, jwords = (np.asarray(x) for x in jv.transform(query, valid))
        np.testing.assert_array_equal(words, jwords)
        np.testing.assert_allclose(vec, jvec, rtol=0, atol=1e-6)
        other, _ = v.transform(query[::-1].copy(), valid)
        got = float(bow.BinaryVocabulary.score(_t(vec), _t(other)))
        want = float(jbow.BinaryVocabulary.score(jnp.asarray(vec), jnp.asarray(other)))
        assert got == pytest.approx(want, abs=1e-6)


def test_database_query_and_pair_score_match_reference(rng):
    """Both databases hold the same vectors (the JAX transform's): the same
    candidate lists, in the same order, and the same pair scores."""
    vocab = bow.train_default_vocab(device="cpu")
    jvocab = jbow.train_default_vocab()
    db = loop_closing.make_database(vocab, 64)
    jdb = jlc.make_database(jvocab, 64)
    base = random_desc(rng, 300)
    for k in range(40):
        desc = perturb_desc(rng, base, int(rng.integers(0, 40))) if k % 3 else random_desc(rng, 300)
        valid = rng.random(300) > 0.1
        jdb.add(k, desc, valid)
    db.vectors, db.present = jdb.vectors.copy(), jdb.present.copy()
    for k in (3, 17, 30):
        db.remove(k)
        jdb.remove(k)
    for q in range(6):
        vec = jdb.transform(perturb_desc(rng, base, 10 * q), np.ones(300, bool))
        exclude = {int(x) for x in rng.integers(0, 40, 5)}
        for floor in (0.0, 0.05, 0.2):
            assert db.query(vec, exclude, floor) == jdb.query(vec, exclude, floor)
        for k in range(0, 45, 4):
            assert db.pair_score(k, vec) == jdb.pair_score(k, vec)
    db.clear()
    assert db.query(vec, set(), 0.0) == []


# ---------------------------------------------------------------------------
# RANSACs and rigid alignment
# ---------------------------------------------------------------------------

def _rigid_inputs(rng, n=200, n_out=60, noise=0.03):
    N = loop_closing.MATCH_CAP
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    t = np.array([1.0, 2.0, -0.5], np.float32)
    s = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = s @ R.T + t
    d[:n_out] += rng.uniform(2, 5, (n_out, 3))
    d = (d + rng.normal(0, noise, d.shape)).astype(np.float32)
    src, dst, valid = np.zeros((N, 3), np.float32), np.zeros((N, 3), np.float32), np.zeros(N, bool)
    src[:n], dst[:n], valid[:n] = s, d, True
    return src, dst, valid


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_rigid_ransac_and_refine_match_reference(rng, seed):
    src, dst, valid = _rigid_inputs(rng)
    key = jax.random.PRNGKey(seed)
    want = jpnp.rigid_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                             inlier_threshold=0.4, n_hypotheses=64, min_inliers=20)
    got = pnp.rigid_ransac(_t(src), _t(dst), _t(valid), jax_draws(valid, 64, 3, seed),
                           inlier_threshold=0.4, min_inliers=20)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= 120
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=1e-4)
    ref = pnp.rigid_refine(_t(src), _t(dst), got.inliers, got.T, huber_delta=0.15, n_iters=4)
    jref = jpnp.rigid_refine(jnp.asarray(src), jnp.asarray(dst), want.inliers, want.T,
                             huber_delta=0.15, n_iters=4)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_reference(rng, with_scale):
    src, dst, valid = _rigid_inputs(rng, n_out=0)
    if with_scale:
        dst = dst * np.float32(1.3)
    w = (rng.random(len(src)) * valid).astype(np.float32)
    s, R, t = pnp.umeyama(_t(src), _t(dst), _t(w), with_scale=with_scale)
    js, jR, jt = jpnp.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                              with_scale=with_scale)
    assert float(s) == pytest.approx(float(js), abs=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    # a batch of weight rows solves each row as the single call does
    W = np.stack([w, valid.astype(np.float32)])
    sb, Rb, tb = pnp.umeyama(_t(src), _t(dst), _t(W), with_scale=with_scale)
    np.testing.assert_allclose(Rb[0].numpy(), R.numpy(), rtol=0, atol=1e-6)


def _pnp_inputs(rng, n=200, n_out=40):
    N = loop_closing.MATCH_CAP
    fx, fy, cx, cy = CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]
    P = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(4, 20, n)],
                 1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray([0.05, 0.1, -0.02], jnp.float32)))
    T[:3, 3] = [0.3, -0.1, 0.5]
    pc = P @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    uv[:n_out] += rng.uniform(20, 50, (n_out, 2))
    pts, uvs, valid = np.zeros((N, 3), np.float32), np.zeros((N, 2), np.float32), np.zeros(N, bool)
    pts[:n], uvs[:n], valid[:n] = P, uv, True
    return pts, uvs, valid, T, (fx, fy, cx, cy)


@pytest.mark.parametrize("seed", [13, 5])
def test_pnp_ransac_and_dlt_match_reference(rng, seed):
    pts, uv, valid, T_true, cam = _pnp_inputs(rng)
    key = jax.random.PRNGKey(seed)
    want = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), key, *cam,
                           min_inliers=15)
    got = pnp.pnp_ransac(_t(pts), _t(uv), _t(valid), jax_draws(valid, 128, 6, seed), *cam,
                         min_inliers=15)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= 150
    exact = pnp.pnp_ransac(_t(pts.astype(np.float64)), _t(uv.astype(np.float64)), _t(valid),
                           jax_draws(valid, 128, 6, seed), *cam, min_inliers=15)
    np.testing.assert_array_equal(exact.inliers.numpy(), np.asarray(want.inliers))
    assert_pnp_close(got.T.numpy(), want.T, exact.T.numpy())
    assert np.abs(got.T.numpy()[:3, 3] - T_true[:3, 3]).max() < 0.05
    # the DLT alone on the inlier set, and on a batch of two weight rows
    fx, fy, cx, cy = cam
    uvn = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], 1)
    w = np.asarray(want.inliers).astype(np.float32)
    dlt = pnp.pnp_dlt(_t(pts), _t(uvn.astype(np.float32)), _t(w))
    assert_pnp_close(dlt.numpy(), jpnp.pnp_dlt(jnp.asarray(pts), jnp.asarray(uvn, jnp.float32),
                                               jnp.asarray(w)),
                     pnp.pnp_dlt(_t(pts.astype(np.float64)), _t(uvn),
                                 _t(w.astype(np.float64))).numpy())
    both = pnp.pnp_dlt(_t(pts), _t(uvn.astype(np.float32)), _t(np.stack([w, w])))
    np.testing.assert_allclose(both[1].numpy(), dlt.numpy(), rtol=0, atol=1e-6)


def test_minimal_sets_are_uniform_over_valid_rows():
    """The port's own draw: only valid rows, with replacement, the same for
    the same seed, repeats set once in the hypothesis weights."""
    valid = np.zeros(100, bool)
    valid[[3, 10, 11, 50]] = True
    a = pnp.draw_index_sets(valid, 64, 6, 5)
    assert a.shape == (64, 6)
    assert set(a.unique().tolist()) == {3, 10, 11, 50}
    assert torch.equal(a, pnp.draw_index_sets(valid, 64, 6, 5))
    assert not torch.equal(a, pnp.draw_index_sets(valid, 64, 6, 6))
    w = pnp._selection_weights(torch.tensor([[3, 3, 10]]), _t(valid))
    assert w.sum() == 2 and w[0, 3] == 1


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def test_pose_graph_matches_reference():
    """tests/test_loop_components.py's drifted circle with one loop edge."""
    prob, poses_true, poses_noisy = make_loop_problem(np.random.default_rng(42))
    want = np.asarray(jposegraph.optimize_pose_graph(prob, n_iters=20))
    got = posegraph.optimize_pose_graph(
        posegraph.PoseGraphProblem(*(_t(np.asarray(x)) for x in prob)), n_iters=20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0], poses_noisy[0].astype(np.float32))   # fixed
    before = np.abs(poses_noisy[:, :3, 3] - poses_true[:, :3, 3]).mean()
    assert np.abs(got[:, :3, 3] - poses_true[:, :3, 3]).mean() < before


# ---------------------------------------------------------------------------
# relocalization from a JAX run's map
# ---------------------------------------------------------------------------

def _frame_copy(frame):
    """A port FrameRecord with copies of the reference frame's fields."""
    fields = {f.name: getattr(frame, f.name) for f in dataclasses.fields(FrameRecord)}
    return FrameRecord(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                          for k, v in fields.items()})


def test_relocalizer_matches_reference_from_jax_map(monkeypatch):
    """tests/test_loop_closing.py's blackout case at 512x256 in the JAX
    System; every relocalization attempt of its tracker is first made by
    the port's Relocalizer from a copy of the map and the database, on a
    copy of the frame, with JAX's draws. The candidates and the 2D-3D
    correspondences handed to PnP are equal; the outcome is the same; the
    pose is held loosely, translation within 0.05 m and rotation entries
    within 0.01, and the inlier sets not at all: the 128 hypotheses'
    float32 DLT null vectors lie a median 2e-3 from their float64 values
    in both packages, which is enough to pick another best hypothesis and
    refine on another inlier set (measured: 75 and 83 inliers, poses
    3.45e-02 m apart, the float64 solve 1.7e-03 m from JAX's and 3.6e-02 m
    from the port's). A feature bound in both is bound to the same point
    (the correspondences are equal)."""
    cam = jconfig.CameraConfig(**CAM)
    scene = jsynthetic.make_scene(n_frames=10, n_points=2500, n_objects=0, seed=43,
                                  forward_speed=0.6, camera=cam)
    renderer = jsynthetic.SyntheticRenderer(scene)
    ref = jsystem.System(jconfig.SystemConfig(camera=cam))
    from pointslot_torch import config

    cfg = config.SystemConfig(camera=config.CameraConfig(**CAM))
    jreloc = ref.tracker.relocalizer
    calls, solves = [], {"port": [], "jax": []}

    def recorded(name, fn):
        def run(pts, uv, valid, *args, **kw):
            n = int(np.asarray(valid).sum())
            solves[name].append((np.asarray(pts)[:n].copy(), np.asarray(uv)[:n].copy()))
            return fn(pts, uv, valid, *args, **kw)
        return run

    monkeypatch.setattr(pnp, "pnp_ransac", recorded("port", pnp.pnp_ransac))
    monkeypatch.setattr(jpnp, "pnp_ransac", recorded("jax", jpnp.pnp_ransac))
    orig = jreloc.relocalize

    def mirrored(frame):
        m = convert.map_state_from_arrays(ref.map)
        db = loop_closing.make_database(bow.train_default_vocab(device="cpu"), m.max_kfs)
        db.vectors, db.present = jreloc.db.vectors.copy(), jreloc.db.present.copy()
        port = loop_closing.Relocalizer(cfg, m, db, device="cpu")
        port.draw_index_sets = jax_draws
        got = _frame_copy(frame)
        ok = port.relocalize(got)
        want_ok = orig(frame)
        calls.append((ok, got, want_ok, frame.T_cw.copy() if want_ok else None,
                      frame.point_idx.copy()))
        return want_ok

    jreloc.relocalize = mirrored
    rendered = [renderer.render(i)[:2] for i in range(10)]
    for i, (left, right) in enumerate(rendered):
        ref.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    black = np.zeros_like(rendered[0][0])
    for j in range(3):
        ref.track_stereo(black, black, timestamp=1.0 + j * 0.1, frame_id=10 + j)
    assert ref.tracker.state == TrackingState.LOST
    ref.track_stereo(*rendered[5], timestamp=1.4, frame_id=13)
    assert ref.tracker.state == TrackingState.OK
    assert calls and calls[-1][2], "the reference did not relocalize"
    assert len(solves["port"]) == len(solves["jax"]) >= 1
    for (pts, uv), (jpts, juv) in zip(solves["port"], solves["jax"]):
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(uv, juv)
    for ok, got, want_ok, want_T, want_bind in calls:
        assert ok == want_ok
        if want_ok:
            np.testing.assert_allclose(got.T_cw[:3, 3], want_T[:3, 3], rtol=0, atol=0.05)
            np.testing.assert_allclose(got.T_cw[:3, :3], want_T[:3, :3], rtol=0, atol=0.01)
            both = (got.point_idx >= 0) & (want_bind >= 0)
            assert both.sum() >= 15
            np.testing.assert_array_equal(got.point_idx[both], want_bind[both])
