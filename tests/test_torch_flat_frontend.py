"""The flat multi-image frontend, its multi-image patch source and the gated
ORB call against the reference, at 320x160 with 4 pyramid levels (the fine
refine from level 2, so all three of the flat batch's gathers run).

The JAX side runs on the CPU as its own frontend tests run it (the take
path, no Pallas): ``StereoFrontend._run_batch_impl`` and
``ORBExtractor(img, gate)``. The port runs with device="cpu" on one torch
thread. Inputs are numpy arrays from a seed.

Tolerances (tests/test_torch_orb.py, tests/test_torch_fused.py): xy, level
and valid equal; responses within 1e-3 and angles within 1e-4 rad (sums in
another order than XLA's); descriptor bits flipped on at most 0.1 % of the
valid bits (BRIEF pairs whose samples tie within rounding); stereo
validity differing on at most 0.5 % of the keypoints, u_right within 1e-3
px and depth within rtol 1e-4 where both have it. The multi-image gather
is a pure copy: equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.config import ORBConfig as JORBConfig
from pointslot_tpu.ops import pallas_patch as jpatch
from pointslot_tpu.ops import pyramid as jpyr
from pointslot_tpu.ops.frontend import StereoFrontend as JStereoFrontend
from pointslot_tpu.ops.orb import ORBExtractor as JORB
from pointslot_torch import convert
from pointslot_torch.config import CameraConfig, ORBConfig
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops import patch
from pointslot_torch.ops.frontend import StereoFrontend
from pointslot_torch.ops.orb import FeatureSet, ORBExtractor

H, W, B = 160, 320, 2
ORB = dict(n_features=500, n_levels=4, stereo_fine_min_level=2)
CAM = dict(width=W, height=H, fx=200.0, fy=200.0, cx=160.0, cy=80.0, bf=40.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """B stereo pairs of a synthetic scene, uint8 (B, H, W) each."""
    scene = synthetic.make_scene(n_frames=B, n_points=600, n_objects=1, seed=3,
                                 camera=CameraConfig(**CAM))
    r = synthetic.SyntheticRenderer(scene)
    frames = [r.render(i) for i in range(B)]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


@pytest.fixture(scope="module")
def flat(pairs):
    """The reference's flat batch and the port's batch_flat on the pairs,
    each run once for the module."""
    lefts, rights = pairs
    jfe = JStereoFrontend(H, W, CAM["fx"], CAM["bf"], JORBConfig(**ORB))
    want = jax.jit(jfe._run_batch_impl)(jnp.asarray(lefts, jnp.float32),
                                        jnp.asarray(rights, jnp.float32))
    fe = StereoFrontend(H, W, CAM["fx"], CAM["bf"], ORBConfig(**ORB), device="cpu")
    before = patch.CANVAS_BUILDS
    got = convert.to_numpy(fe.batch_flat(lefts, rights))
    return got, [np.asarray(x) for x in want], patch.CANVAS_BUILDS - before


def _flips(a, b) -> int:
    return int(np.unpackbits((a.astype(np.uint32) ^ b.astype(np.uint32)).view(np.uint8)).sum())


def test_batch_flat_matches_reference(flat):
    got, want, builds = flat
    xy, resp, angle, level, desc, valid, u_right, depth = want
    np.testing.assert_array_equal(got.xy, xy)
    np.testing.assert_array_equal(got.level, level)
    np.testing.assert_array_equal(got.valid, valid)
    np.testing.assert_allclose(got.response, resp, rtol=0, atol=1e-3)
    v = valid
    assert v.sum() > 300
    np.testing.assert_allclose(got.angle[v], angle[v], rtol=0, atol=1e-4)
    assert _flips(got.desc[v], desc[v]) <= 0.001 * 256 * v.sum()
    assert ((got.depth > 0) != (depth > 0))[v].sum() <= 0.005 * v.size
    sv = v & (got.depth > 0) & (depth > 0)
    assert sv.sum() > 50
    np.testing.assert_allclose(got.u_right[sv], u_right[sv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.depth[sv], depth[sv], rtol=1e-4)
    # the CPU path builds the multi-image canvas once per gather: 3 per batch
    assert builds == 3


def test_multi_image_gather_plain_matches_reference(pairs):
    """The plain multi-image gather on the reference's own levels equals
    stack_pyramid_for_patches_multi + extract_patches_stack (take path)
    exactly, for rows of every image and level and for rows, centres and
    negative indices out of range."""
    lefts, rights = pairs
    imgs = np.concatenate([lefts, rights]).astype(np.float32)       # G = 2B images
    G = imgs.shape[0]
    levels = jpyr.build_pyramid(jnp.asarray(imgs), ORB["n_levels"], 1.2)
    L = len(levels)
    rng = np.random.default_rng(5)
    K = 300
    row = rng.integers(0, G * L, K)
    hw = np.array([x.shape[-2:] for x in levels])[row % L]
    xyl = np.stack([(rng.random(K) * hw[:, 1]).astype(np.int64),
                    (rng.random(K) * hw[:, 0]).astype(np.int64), row], 1)
    Hp, Wp = H + 64, W + 256
    R = G * L
    edges = np.array([[0, 0, 0], [Wp - 1, Hp - 1, R - 1], [Wp + 5, Hp + 9, R], [-1, -1, L],
                      [-Wp - 3, -2, R + 3], [3, 4, -1], [17, -60, -R - 2]])
    xyl = np.concatenate([xyl, edges]).astype(np.int32)
    want = np.asarray(jpatch.extract_patches_stack(
        jpatch.stack_pyramid_for_patches_multi(levels), jnp.asarray(xyl), use_pallas=False))
    got = patch.gather_patches([torch.from_numpy(np.array(x)) for x in levels],
                               torch.from_numpy(xyl))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gated_orb_matches_reference(pairs):
    """ORBExtractor(img, gate) against the reference's gated call."""
    img = pairs[0][1]
    gate = np.zeros((H, W), bool)
    gate[20:130, 40:250] = True
    gate[60:90, 100:140] = False
    cfg = dict(n_features=500, n_levels=4)
    want = FeatureSet(*[np.asarray(x) for x in JORB(H, W, JORBConfig(**cfg))(img, gate)])
    got = convert.to_numpy(ORBExtractor(H, W, ORBConfig(**cfg), device="cpu")(img, gate))
    np.testing.assert_array_equal(got.xy, want.xy)
    np.testing.assert_array_equal(got.level, want.level)
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert 50 < v.sum() < 0.9 * v.size
    np.testing.assert_allclose(got.response, want.response, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.angle[v], want.angle[v], rtol=0, atol=1e-4)
    assert _flips(got.desc[v], want.desc[v]) <= 0.001 * 256 * v.sum()
