"""Port against reference at the KITTI geometry (1242x375): the resize
weights, pyramid levels, FAST/NMS, the patch canvas and gather, and ORB
extraction on the tests/test_orb.py scenes. The JAX functions run on the
CPU (take path); the port runs with device="cpu". The tests share one
process-wide cache of the reference's resize matrices, which the module
fixture's first extraction fills."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.datasets.synthetic import SyntheticRenderer, make_scene
from pointslot_tpu.ops import fast as jfast
from pointslot_tpu.ops import pallas_patch as jpatch
from pointslot_tpu.ops import pyramid as jpyr
from pointslot_tpu.ops.orb import ORBExtractor as JORB
from pointslot_torch import convert
from pointslot_torch.ops import fast, patch, pyramid
from pointslot_torch.ops.orb import FeatureSet, ORBExtractor


def T(a):
    return torch.from_numpy(np.array(a))


SCENES = {3: 800, 5: 600, 11: 900}   # seed -> n_points, as in tests/test_orb.py


@pytest.fixture(scope="module")
def extractors():
    return JORB(375, 1242), ORBExtractor(375, 1242, device="cpu")


def _left(seed):
    scene = make_scene(n_frames=2, n_points=SCENES[seed], n_objects=1, seed=seed)
    return SyntheticRenderer(scene).render(0)[0]


@pytest.fixture(scope="module")
def reference_features(extractors):
    """seed -> (left image, the reference's features of it), each computed
    once for the module."""
    jext, _ = extractors
    done = {}

    def get(seed):
        if seed not in done:
            left = _left(seed)
            done[seed] = left, FeatureSet(*[np.asarray(x) for x in jext(left)])
        return done[seed]

    return get


@pytest.fixture(scope="module")
def frame7(extractors):
    """Frame 1 of the seed-7 scene: the left image's reference levels, the
    right image's level 0, and the port's detections on the left levels."""
    _, ext = extractors
    scene = make_scene(n_frames=2, n_points=2500, n_objects=2, seed=7)
    left, right, _ = SyntheticRenderer(scene).render(1)
    lv_l = jpyr.build_pyramid(jnp.asarray(left, jnp.float32), 8, 1.2)
    xyl, xy = ext.detect(ext.scores([T(np.asarray(x)) for x in lv_l]))[:2]
    right0 = jpyr.build_pyramid(jnp.asarray(right, jnp.float32), 8, 1.2)[0]
    return lv_l, right0, xyl.numpy(), xy.numpy()


def _flipped_bits(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.unpackbits((a ^ b).view(np.uint8)).sum())


@pytest.mark.parametrize("seed", sorted(SCENES))
def test_orb_matches_reference(extractors, reference_features, seed):
    """Keypoints, levels and validity are equal exactly. Descriptor bits
    may flip only where a BRIEF pair's two samples tie to within float32
    rounding (the bilinear taps and the blur sum in another order than the
    reference's matmuls): they are counted and bounded at 0.1 % of the
    valid bits. Angles agree to 1e-4 rad (the moment sums run in another
    order). Responses agree to 1e-3: the pyramid's resize matmuls sum in
    another order than XLA's, moving coarse-level pixels by float32 ulps;
    fed the reference's own levels they are equal exactly (next test)."""
    _, ext = extractors
    left, want = reference_features(seed)
    got = convert.to_numpy(ext(left))
    np.testing.assert_array_equal(got.xy, want.xy)
    np.testing.assert_array_equal(got.level, want.level)
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert v.sum() > 300
    flips = _flipped_bits(got.desc[v], want.desc[v])
    assert flips <= 0.001 * 256 * v.sum(), f"{flips} descriptor bits flipped"
    np.testing.assert_allclose(got.angle[v], want.angle[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.response, want.response, rtol=0, atol=1e-3)
    assert patch.LAUNCHES == 0


def test_orb_on_reference_levels_equal_exactly(extractors, reference_features):
    """Fed the reference's pyramid levels, the port's selection gives the
    same keypoints and bit-identical responses."""
    _, ext = extractors
    left, want = reference_features(3)
    levels = jpyr.build_pyramid(jnp.asarray(left.astype(np.float32)), 8, 1.2)
    levels_t = [torch.from_numpy(np.array(x)) for x in levels]
    got = convert.to_numpy(FeatureSet(*ext._extract_from_scores(levels_t, ext.scores(levels_t))))
    np.testing.assert_array_equal(got.xy, want.xy)
    np.testing.assert_array_equal(got.level, want.level)
    np.testing.assert_array_equal(got.response, want.response)


def test_pyramid_levels_match(extractors, rng):
    """Whole levels agree to 1e-3 grey: the matmuls sum the three taps in
    another order than XLA, which moves values by a few float32 ulps."""
    img = rng.integers(0, 256, (2, 375, 1242)).astype(np.float32)
    want = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    got = pyramid.build_pyramid(T(img), pyramid.pyramid_mats(375, 1242, 8, 1.2, "cpu"))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-3)


def test_fast_and_nms_equal_exactly(extractors, rng):
    """Given the same level images, FAST scores and NMS are min/max/subtract
    only, so they are equal exactly (the finest, a middle and the coarsest
    level: one code path, three shapes)."""
    img = rng.integers(0, 256, (2, 375, 1242)).astype(np.float32)
    levels = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    for lv in (levels[0], levels[4], levels[7]):
        want = jfast.fast_score_map(lv, 5.0)
        got = fast.fast_score_map(T(np.asarray(lv)), 5.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(fast.nms3x3(got).numpy(),
                                      np.asarray(jfast.nms3x3(want)))


def test_patch_canvas_and_gather_equal_exactly(extractors, rng):
    """The canvas equals stack_pyramid_for_patches and the plain gather
    equals the take path exactly, centers at the clamp edges included."""
    img = rng.integers(0, 256, (375, 1242)).astype(np.float32)
    levels = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    want_canvas = np.asarray(jpatch.stack_pyramid_for_patches(levels))
    canvas = patch.stack_pyramid_for_patches([T(np.asarray(x)) for x in levels])
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)
    assert canvas.shape == (8, 375 + 64, 1242 + 256)
    L, Hp, Wp = canvas.shape
    xyl = np.stack([rng.integers(0, 1242, 200), rng.integers(0, 375, 200),
                    rng.integers(0, 8, 200)], axis=1)
    edges = np.array([[0, 0, 0], [1241, 374, 0], [Wp - 1, Hp - 1, 7], [Wp + 5, Hp + 9, 7],
                      [-1, -1, 0], [-Wp - 3, -2, 3], [17, -60, 9], [3, 4, -1]])
    xyl = np.concatenate([xyl, edges]).astype(np.int32)
    want = np.asarray(jpatch.extract_patches_stack(jnp.asarray(want_canvas),
                                                   jnp.asarray(xyl), use_pallas=False))
    got = patch.extract_patches_stack_plain(canvas, T(xyl))
    np.testing.assert_array_equal(got.numpy(), want)
    got = patch.gather_patches([T(np.asarray(x)) for x in levels], T(xyl))
    np.testing.assert_array_equal(got.numpy(), want)
    assert patch.LAUNCHES == 0


@pytest.mark.parametrize("source", ["left-levels", "level0-pair"])
def test_level_source_gather_equals_reference(frame7, source):
    """The gather from a patch source (planes where they lie, here on the
    CPU through the plain version) equals the reference's take path on the
    canvas JAX builds, exactly: a frame's real keypoints, edge centres and
    negative wraps, for the left image's 8 levels (the ORB gathers) and for
    the two level-0 images (the fine windows; the third column picks the
    image)."""
    lv_l, right0, xyl, xy = frame7
    if source == "left-levels":
        planes = lv_l
    else:
        planes = [lv_l[0], right0]
        xy0 = np.round(xy).astype(np.int32)
        xyl = np.stack([xy0[:, 0], xy0[:, 1], np.arange(len(xy0)) % 2], axis=1)
    assert len(xyl) == 1000
    L = len(planes)
    Hp, Wp = 375 + 64, 1242 + 256
    edges = np.array([[0, 0, 0], [1241, 374, L - 1], [Wp - 1, Hp - 1, L - 1],
                      [Wp + 5, Hp + 9, L], [-1, -1, 0], [-Wp - 3, -2, 1], [17, -60, L + 1],
                      [3, 4, -1], [-30, 380, 0], [1230, -Hp - 7, 1]])
    xyl = np.concatenate([xyl, edges]).astype(np.int32)
    want = np.asarray(jpatch.extract_patches_stack(jpatch.stack_pyramid_for_patches(planes),
                                                   jnp.asarray(xyl), use_pallas=False))
    got = patch.gather_patches([T(np.asarray(x)) for x in planes], T(xyl))
    assert got.shape == (1010, 48, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    assert patch.LAUNCHES == 0


def test_resize_weights_kitti_geometry():
    """The numpy rebuild of the resize weights equals _resize_mats at the
    KITTI geometry for every level (atol 1e-7 asked; it is bit-equal)."""
    shapes = pyramid.level_shapes(375, 1242, 8, 1.2)
    assert shapes[1] == (312, 1035)
    for lvl in range(1, 8):
        R, C = pyramid.resize_mats(*shapes[lvl - 1], *shapes[lvl])
        Rj, Cj = jpyr._resize_mats(*shapes[lvl - 1], *shapes[lvl])
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-7)
        np.testing.assert_allclose(C, Cj, rtol=0, atol=1e-7)
        assert np.array_equal(R, Rj) and np.array_equal(C, Cj)
