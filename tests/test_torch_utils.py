"""The port's utils and native helpers against the reference:

- ``utils/roofline.py``: every model's FLOPs and bytes equal the
  reference's, and the H100 frontend models differ from them only in the
  two stages the port runs otherwise; ``analyze`` works against the H100's data-sheet peaks and
  no TPU figure is left in the port;
- ``utils/stagebench.py``: the prefix names in the reference's order, the
  last frontend prefix equal to the frontend's own output, ``timeit_ms``
  None (never NaN) where its signal stays in the noise, and stage dicts
  that ``json.dumps`` writes without ``NaN``;
- ``native.py``: ``CovisGraph`` and ``hamming_nn`` against the reference's
  C++ library on tests/test_native.py's cases.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pointslot_tpu import native as jnative
from pointslot_tpu.config import ORBConfig as JORBConfig
from pointslot_tpu.config import SystemConfig as JSystemConfig
from pointslot_tpu.ops.frontend import StereoFrontend as JStereoFrontend
from pointslot_tpu.ops.fused_track import FusedObjectPhase as JFusedObjectPhase
from pointslot_tpu.ops.fused_track import FusedTrackStep as JFusedTrackStep
from pointslot_tpu.utils import roofline as jroofline
from pointslot_tpu.utils import stagebench as jstagebench
from pointslot_torch import native
from pointslot_torch.config import ORBConfig, SystemConfig
from pointslot_torch.ops.frontend import StereoFrontend
from pointslot_torch.ops.fused_track import FusedObjectPhase, FusedTrackStep
from pointslot_torch.utils import roofline, stagebench

H, W = 160, 320
ORB = dict(n_features=500, n_levels=4)


@pytest.fixture(scope="module")
def frontends():
    return (JStereoFrontend(H, W, 200.0, 40.0, JORBConfig(**ORB)),
            StereoFrontend(H, W, 200.0, 40.0, ORBConfig(**ORB), device="cpu"))


def _models(mod, fe):
    return {"frontend": mod.frontend_models(fe),
            "hamming": {"hamming": mod.hamming_model(2048, 2048)},
            "ba": {"ba": mod.ba_iteration_model(32, 4096, 8)}}


@pytest.mark.parametrize("kind", ["frontend", "hamming", "ba"])
def test_roofline_models_match_reference(frontends, kind):
    jfe, fe = frontends
    want, got = _models(jroofline, jfe)[kind], _models(roofline, fe)[kind]
    assert list(got) == list(want)
    for name in want:
        assert got[name].name == want[name].name
        assert got[name].flops == want[name].flops
        assert got[name].bytes == want[name].bytes
        assert got[name].engine == want[name].engine


def test_h100_frontend_models(frontends):
    """The H100 models differ from the reference's only where the port's
    kernels do other work: the CUDA gather (no arithmetic, coordinates and
    float32 patches) and orient_brief on the float32 engine."""
    _, fe = frontends
    ref, got = roofline.frontend_models(fe), roofline.h100_frontend_models(fe)
    assert list(got) == list(ref)
    for name in ("pyr_fast_select", "stereo_sad"):
        assert got[name] == ref[name]
    K = fe.extractor.capacity
    assert got["patch_dma"] == roofline.KernelModel("patch_dma", 0.0, 2.0 * K * (12 + 9216),
                                                    "f32")
    ob = got["orient_brief"]
    assert (ob.flops, ob.bytes, ob.engine) == (ref["orient_brief"].flops,
                                               ref["orient_brief"].bytes, "f32")


def test_analyze_uses_h100_peaks():
    m = roofline.KernelModel("x", flops=67e9, bytes=3.35e9, engine="f32")
    v = roofline.analyze(m, 2.0)                    # 1 ms of compute, 1 ms of bytes
    assert v["sol_ms"] == 1.0 and v["mfu"] == 0.5 and v["bw_frac"] == 0.5
    assert roofline.analyze(roofline.KernelModel("y", 989.4e9, 0.0, "bf16"), 1.0)["mfu"] == 1.0
    assert roofline.analyze(m, 0.0)["bound"] == "unmeasured"
    root = Path(roofline.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        text = path.read_text()
        for figure in ("197e12", "819e9", "197 TFLOP", "819 GB"):
            assert figure not in text, f"{path}: {figure}"


def test_stagebench_prefixes_match_reference(frontends):
    jfe, fe = frontends
    assert list(stagebench.frontend_prefixes(fe)) == list(jstagebench.frontend_prefixes(jfe))
    jcfg, cfg = JSystemConfig(), SystemConfig()
    jnames = list(jstagebench.track_prefixes(JFusedTrackStep(jcfg, jfe), JFusedObjectPhase(jcfg)))
    step = FusedTrackStep(cfg, frontend=fe)
    assert list(stagebench.track_prefixes(step, FusedObjectPhase(cfg, device="cpu"))) == jnames


def test_prefixes_run_and_the_last_equals_the_frontend(frontends):
    """Each frontend prefix gives a finite scalar; the last is the whole
    frontend's sum(xy) + sum(depth), bit for bit."""
    _, fe = frontends
    rng = np.random.default_rng(4)
    left = torch.from_numpy(rng.integers(0, 255, (H, W), dtype=np.uint8))
    right = torch.roll(left, -4, dims=1)
    values = [fn(left, right) for fn in stagebench.frontend_prefixes(fe).values()]
    assert all(v.dim() == 0 and bool(torch.isfinite(v)) for v in values)
    sf = fe.run(left, right)
    assert torch.equal(values[-1], torch.sum(sf.xy) + torch.sum(sf.depth))


def test_timeit_ms_none_in_noise_and_json_without_nan(frontends, monkeypatch):
    _, fe = frontends
    # a clock that sees no cost: no signal at any n
    monkeypatch.setattr(stagebench, "_run_timed", lambda fn, args, steps: 0.25)
    with pytest.warns(UserWarning, match="within the noise"):
        assert stagebench.timeit_ms(lambda: torch.zeros(()), warmup=0) is None
    # 1 ms per call and a fixed 5 ms: the two points cancel the fixed cost
    monkeypatch.setattr(stagebench, "_run_timed", lambda fn, args, steps: 0.005 + steps * 1e-3)
    assert stagebench.timeit_ms(lambda: torch.zeros(()), warmup=0) == pytest.approx(1.0)
    times = {"pyr_fast_select": 3.0, "patch_dma": None, "orient_brief": 4.5, "stereo_sad": 6.0}
    monkeypatch.setattr(stagebench, "frontend_prefixes",
                        lambda fe_: {k: (lambda k=k: k) for k in times})
    monkeypatch.setattr(stagebench, "timeit_ms", lambda fn, *a, n=30: times[fn()])
    stages = stagebench.frontend_stage_ms(fe, None, None)
    assert stages == {"pyr_fast_select": 3.0, "stereo_sad": 1.5}
    models = roofline.frontend_models(fe)
    text = json.dumps({"stages": stages, "roofline": roofline.report(
        {k: (models[k], ms) for k, ms in stages.items()})}, allow_nan=False)
    assert "NaN" not in text


def _covis_ops(graph, rng, P, K):
    """tests/test_native.py's random insertions, deletions, point and
    keyframe removals."""
    for _ in range(2000):
        p = int(rng.integers(P))
        k = int(rng.integers(K))
        if rng.uniform() < 0.7:
            graph.add_obs(p, k)
        else:
            graph.remove_obs(p, k)
    for _ in range(5):
        graph.remove_point(int(rng.integers(P)))
    graph.remove_kf(int(rng.integers(K)))


@pytest.mark.parametrize("case", ["covis_graph", "covis_top", "hamming_nn"])
def test_native_matches_reference(case):
    if case == "covis_graph":
        P, K = 200, 16
        got, want = native.CovisGraph(P, K), jnative.CovisGraph(P, K)
        _covis_ops(got, np.random.default_rng(42), P, K)
        _covis_ops(want, np.random.default_rng(42), P, K)
        for kf in range(K):
            np.testing.assert_array_equal(got.weights_of(kf), want.weights_of(kf))
            for min_w, n in ((1, 8), (15, 64), (40, 3)):
                for a, b in zip(got.top(kf, min_w, n), want.top(kf, min_w, n)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    elif case == "covis_top":
        got, want = native.CovisGraph(100, 8), jnative.CovisGraph(100, 8)
        for g in (got, want):
            for p in range(5):
                g.add_obs(p, 0)
                g.add_obs(p, 1)
            for p in range(5, 8):
                g.add_obs(p, 0)
                g.add_obs(p, 2)
            for p in range(8, 11):        # a weight tie between keyframes 3 and 4
                g.add_obs(p, 0)
                g.add_obs(p, 4 if p < 10 else 3)
                g.add_obs(p, 3 if p < 10 else 4)
        for kf in range(5):
            for a, b in zip(got.top(kf, min_weight=1, n=8), want.top(kf, min_weight=1, n=8)):
                np.testing.assert_array_equal(a, b)
    else:
        rng = np.random.default_rng(42)
        a = rng.integers(0, 2 ** 32, size=(37, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, size=(53, 8), dtype=np.uint32)
        b[7] = b[3]                       # a tie: the lower index wins
        a[0] = b[3]
        for x, y in zip(native.hamming_nn(a, b), jnative.hamming_nn(a, b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        cost = rng.uniform(0, 10, size=(6, 9))
        np.testing.assert_array_equal(native.hungarian(cost), jnative.hungarian(cost))
