"""Port against reference, module by module, for the small ops of the
mode-4 hot path: se3, cell selection, Hamming tables, the stereo median and
SAD refine; plus the port's import and device contracts. Inputs come from
numpy seeds; the JAX function runs on the CPU and the port with
device="cpu". (The pyramid, FAST and patch comparisons run at the KITTI
geometry in test_torch_orb.py.)"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointslot_tpu.geometry import se3 as jse3
from pointslot_tpu.ops import hamming as jham
from pointslot_tpu.ops import stereo as jstereo
from pointslot_tpu.ops.orb import ORBExtractor as JORB
from pointslot_torch.geometry import se3
from pointslot_torch.ops import hamming, patch, stereo
from pointslot_torch.ops.orb import ORBExtractor


def T(a):
    return torch.from_numpy(np.array(a))


def _tangents(rng, n=64):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * 0.5
    xi[:8, 3:] = rng.normal(size=(8, 3)).astype(np.float32) * 1e-5   # theta ~ 0
    xi[8:12, 3:] = 0.0                                               # theta == 0
    return xi


def test_se3_matches_reference(rng):
    """exp, retract, inverse and transform agree to 1e-5: both are float32
    and differ only in the order of a few sums."""
    xi = _tangents(rng)
    np.testing.assert_allclose(se3.se3_exp(T(xi)).numpy(),
                               np.asarray(jse3.se3_exp(jnp.asarray(xi))), atol=1e-5)
    Tm = np.asarray(jse3.se3_exp(jnp.asarray(xi[::-1].copy())))
    np.testing.assert_allclose(se3.se3_retract(T(Tm), T(xi)).numpy(),
                               np.asarray(jse3.se3_retract(jnp.asarray(Tm), jnp.asarray(xi))),
                               atol=1e-5)
    np.testing.assert_allclose(se3.se3_inverse(T(Tm)).numpy(),
                               np.asarray(jse3.se3_inverse(jnp.asarray(Tm))), atol=1e-5)
    pts = rng.uniform(-5, 5, (64, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.transform_points(T(Tm), T(pts)).numpy(),
                               np.asarray(jse3.transform_points(jnp.asarray(Tm), jnp.asarray(pts))),
                               atol=1e-5)


def _select_both(score, k):
    jext = JORB(256, 512)
    ext = ORBExtractor(256, 512, device="cpu")
    want = [np.asarray(x) for x in jext._select_cells(jnp.asarray(score), k)]
    got = [x.numpy() for x in ext._select_cells(T(score), k)]
    return want, got


@pytest.mark.parametrize("case", ["random", "ties", "short_grid"])
def test_cell_select_equal_exactly(rng, case):
    """(score, y, x) equal exactly, including a score map full of ties (the
    stable sort must break them toward the lower cell, as lax.top_k does)."""
    if case == "random":
        score = np.where(rng.random((213, 427)) < 0.05,
                         rng.uniform(5, 60, (213, 427)), 0).astype(np.float32)
        k = 181
    elif case == "ties":
        score = np.where(rng.random((213, 427)) < 0.2,
                         rng.integers(6, 9, (213, 427)), 0).astype(np.float32)
        k = 300
    else:   # fewer cells (5 x 9) than the budget: zero-padded tail
        score = np.where(rng.random((71, 143)) < 0.1, 7.0, 0.0).astype(np.float32)
        k = 60
    want, got = _select_both(score, k)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a.astype(b.dtype))
        assert b.shape == (k,)


def test_hamming_tables_equal_exactly(rng):
    a = rng.integers(0, 2 ** 32, (100, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (120, 8), dtype=np.uint32)
    b[:4] = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)[:, None]
    ai, bi = T(a.view(np.int32)), T(b.view(np.int32))
    np.testing.assert_array_equal(hamming.hamming_table_popcount(ai, bi).numpy(),
                                  np.asarray(jham.hamming_table_popcount(a, b)))
    np.testing.assert_array_equal(hamming.hamming_pairwise(ai, bi[:100]).numpy(),
                                  np.asarray(jham.hamming_pairwise(a, b[:100])))


def test_nanmedian_and_argmin_follow_jax():
    """jnp.nanmedian averages the middle pair; all-NaN gives NaN; argmin
    takes the first of equal minima."""
    nan = float("nan")
    assert stereo.nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0, nan])).item() == 2.5
    assert float(jnp.nanmedian(jnp.asarray([1.0, 2.0, 3.0, 4.0, nan]))) == 2.5
    assert np.isnan(stereo.nanmedian(torch.tensor([nan, nan, nan])).item())
    x = np.array([3.0, 1.0, 2.0, 1.0, 5.0], np.float32)
    assert stereo.nanmedian(T(x)).item() == float(jnp.nanmedian(jnp.asarray(x)))
    ties = np.array([[3, 1, 1, 0, 0], [2, 2, 2, 2, 2]], np.float32)
    np.testing.assert_array_equal(torch.argmin(T(ties), dim=1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(ties), axis=1)))


def test_sad_refine_matches_reference(rng):
    """SAD refine and the level-0 fine refine on the same patches: valid
    equal, u_right to 1e-3 px, depth to rtol 1e-4 (the SAD sums run in
    another order)."""
    N = 300
    base = rng.integers(0, 256, (N, 48, 48)).astype(np.float32)
    shift = rng.integers(-4, 5, N)
    pr = np.stack([np.roll(base[i], shift[i], axis=1) for i in range(N)])
    pr += rng.normal(scale=2.0, size=pr.shape).astype(np.float32)
    sul = rng.integers(20, 400, N).astype(np.int32)
    svl = rng.integers(20, 200, N).astype(np.int32)
    sur = (sul - rng.integers(1, 30, N)).astype(np.int32)
    ul = sul.astype(np.float32) * 1.2
    matched = rng.random(N) < 0.9
    inb = rng.random(N) < 0.95
    scale = np.full(N, 1.2, np.float32)
    args = (base, pr, sul, svl, sur, ul, matched, inb, scale)
    want = jstereo.sad_refine_from_patches(*map(jnp.asarray, args), 300.0, 60.0)
    got = stereo.sad_refine_from_patches(*map(T, args), 300.0, 60.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    fargs = (base, pr, ul, np.asarray(want[0]), np.asarray(want[1]), np.asarray(want[2]))
    fw = jstereo.fine_refine_from_patches(*map(jnp.asarray, fargs), 60.0)
    fg = stereo.fine_refine_from_patches(*map(T, fargs), 60.0)
    np.testing.assert_allclose(fg[0].numpy(), np.asarray(fw[0]), atol=1e-3)
    np.testing.assert_allclose(fg[1].numpy(), np.asarray(fw[1]), rtol=1e-4)


def test_port_imports_no_jax():
    """Importing the port and all its modules loads neither jax nor the
    JAX package."""
    code = (
        "import sys, pkgutil, importlib, pointslot_torch\n"
        "for m in pkgutil.walk_packages(pointslot_torch.__path__, 'pointslot_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pointslot_tpu'))]\n"
        "print(len(list(pkgutil.walk_packages(pointslot_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(pathlib.Path(__file__).parent.parent))
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_request_raises_without_card():
    """Asking for CUDA on a machine without it raises instead of returning
    CPU tensors; the CPU path never launches the kernel."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from pointslot_torch import SystemConfig, resolve_device
    from pointslot_torch.ops.fused_track import FusedFrameStep

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FusedFrameStep(SystemConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        ORBExtractor(64, 96)
    with pytest.raises(ValueError):
        patch.gather_patches_cuda([torch.zeros(64, 64)],
                                  torch.zeros(1, 3, dtype=torch.int32))
    assert patch.LAUNCHES == 0
