"""The detection stack of mode 3 and the ROI tracker, the port against the
JAX package on the CPU.

- YOLO heads through ``convert.detector_from_flax``: the bundled trained
  width-8 weights (XLA "SAME" padding) and seeded flax variables with
  ``torch_pad``; bound 1e-4 x max|head| (float32 convolutions summed in
  another order).
- ``decode_predictions`` + ``nms`` fed the JAX heads: the same valid rows
  and classes, boxes within 1e-4 px.
- ``letterbox`` of a 1242x375 frame to 320 and 640 within 1e-3 grey levels
  (the same resize weights, contracted in another order).
- ``Detector.run`` with the bundled weights on frames of
  tests/test_modes.py:108's scene: the same detections, boxes within
  0.05 px, scores within 1e-4.
- ``Detector.from_ultralytics`` on tests/test_yolo_convert.py's random
  yolov5s mirror at input 128: heads within 1e-4 x max|head| of the mirror
  and of the JAX converted detector; a missing key raises.
- The numpy PIL-bilinear resize against PIL, up and down, within 1e-4.
- ``ReIDEmbedder`` with the bundled weights within 1e-5 of the JAX one.
- ``hungarian`` equal to the JAX package's on 50 seeded costs with a unique
  optimum; DeepSORT equal (ids, states, boxes) on tests/test_detect.py:31's
  sequence and on tests/test_reid.py:67's occluded crossing.
- ``_ncc_match`` within 1e-5; ``MultiTracker2D`` on tests/test_detect.py:87's
  moving square: boxes within 1e-3 px and confidences within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointslot_tpu import config as jconfig
from pointslot_tpu.detect import deepsort as jds
from pointslot_tpu.detect import reid as jreid
from pointslot_tpu.detect import tracker2d as jtracker
from pointslot_tpu.detect import yolo as jyolo
from pointslot_tpu.detect.convert import convert_yolov5_state_dict
from pointslot_tpu.detect.train_reid import make_identity_bank
from pointslot_tpu.native import hungarian as jhungarian
from pointslot_torch import config, convert
from pointslot_torch.datasets import synthetic
from pointslot_torch.detect import deepsort, reid, tracker2d, yolo
from pointslot_torch.detect.convert import yolov5_from_state_dict

W8 = "pointslot_tpu/detect/weights/synthetic_yolo_w8.npz"
HEAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Left images of tests/test_modes.py:108's scene (1242x375, seed 205)."""
    sc = synthetic.make_scene(n_frames=6, n_objects=2, seed=205, forward_speed=0.8)
    renderer = synthetic.SyntheticRenderer(sc)
    return [renderer.render(i)[0] for i in range(0, 6, 2)]


@pytest.fixture(scope="module")
def detectors():
    jd = jyolo.Detector(input_size=320, width=8, conf=0.3)
    jd.load_npz(W8)
    pd = yolo.Detector(input_size=320, width=8, conf=0.3, device="cpu")
    pd.load_npz(W8)
    return jd, pd


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _assert_heads(got, want):
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= HEAD_REL * np.abs(w).max(), np.abs(g - w).max()


@pytest.mark.parametrize("weights", ["bundled_w8", "seeded_torch_pad"])
def test_yolo_heads_match_flax(weights):
    x = np.random.default_rng(1).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    if weights == "bundled_w8":
        jd = jyolo.Detector(input_size=128, width=8)
        jd.load_npz(W8)
        fmodel, variables = jd.model, jd.variables
        model = convert.detector_from_flax(dict(np.load(W8)))
    else:
        fmodel = jyolo.YOLOv5(width=8, torch_pad=True)
        variables = fmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 128, 3)))
        model = convert.detector_from_flax(variables, torch_pad=True)
    want = fmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    _assert_heads(got, want)
    # and back: the port saves the JAX package's npz layout
    flat = convert.flax_from_module(model)
    assert sorted(flat) == sorted(convert.flat_flax(variables))


def test_decode_and_nms_match_reference(frames, detectors):
    jd, _ = detectors
    boxed, _, _ = jyolo.letterbox(np.stack([frames[0]] * 3, -1), 320)
    heads = jd.model.apply(jd.variables, jnp.asarray(boxed[None] / 255.0, jnp.float32))
    cases = [(jyolo.decode_predictions(heads, 320)[0], 0.3, 0.5)]
    pred = np.zeros((10, 85), np.float32)   # tests/test_detect.py:59's overlaps
    pred[0, :4], pred[0, 4], pred[0, 7] = [100, 100, 40, 40], 0.9, 0.9
    pred[1, :4], pred[1, 4], pred[1, 7] = [102, 102, 40, 40], 0.8, 0.9
    pred[2, :4], pred[2, 4], pred[2, 12] = [104, 100, 40, 40], 0.85, 0.9
    pred[3, :4], pred[3, 4], pred[3, 7] = [400, 200, 30, 30], 0.7, 0.9
    cases.append((jnp.asarray(pred), 0.3, 0.5))
    decoded = yolo.decode_predictions([torch.from_numpy(np.array(h)) for h in heads], 320)[0]
    np.testing.assert_allclose(decoded.numpy(), np.asarray(cases[0][0]), rtol=1e-5, atol=1e-4)
    for k, (jpred, conf, iou) in enumerate(cases):
        want = [np.asarray(a) for a in jyolo.nms(jpred, conf, iou, max_out=8 if k else 64)]
        got = yolo.nms(torch.from_numpy(np.array(jpred)), conf, iou, max_out=8 if k else 64)
        np.testing.assert_array_equal(got[3], want[3])
        v = want[3]
        assert v.sum() == (3 if k else v.sum()) and v.sum() >= 1
        np.testing.assert_array_equal(got[2][v], want[2][v])
        np.testing.assert_allclose(got[0][v], want[0][v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1][v], want[1][v], rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [320, 640])
def test_letterbox_matches_reference(frames, size):
    img = np.stack([frames[1]] * 3, -1)
    want, r_w, off_w = jyolo.letterbox(img, size)
    got, r, off = yolo.letterbox(img, size, device="cpu")
    assert (r, off) == (r_w, off_w)
    assert np.abs(got.numpy() - want).max() <= 1e-3
    grey, _, _ = yolo.letterbox(frames[1], size, device="cpu")   # Detector.run's path
    assert np.abs(grey.numpy() - want[..., 0]).max() <= 1e-3


def test_detector_run_matches_reference(frames, detectors):
    jd, pd = detectors
    n = 0
    for img in frames:
        want, got = jd.run(img), pd.run(img)
        assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.05)
            assert abs(g["score"] - w["score"]) <= 1e-4
        n += len(want)
    assert n >= 2, "the trained detector found nothing to compare"


def test_from_ultralytics_matches_mirror_and_reference():
    from test_yolo_convert import TYolo5s, _randomize

    tmodel = TYolo5s()
    _randomize(tmodel, seed=2)
    tmodel.eval()
    sd = {k: v for k, v in tmodel.state_dict().items() if "num_batches_tracked" not in k}
    x = np.random.default_rng(3).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    det = yolo.Detector.from_ultralytics(sd, input_size=128, device="cpu")
    assert det.model.width == 32 and det.model.torch_pad
    with torch.no_grad():
        got = det.model(_nchw(x))
        mirror = [h.permute(0, 2, 3, 1) for h in tmodel(_nchw(x))]
    _assert_heads(got, mirror)
    jvars = convert_yolov5_state_dict({k: v.numpy() for k, v in sd.items()})
    _assert_heads(got, jyolo.YOLOv5(width=32, torch_pad=True).apply(jvars, jnp.asarray(x)))
    del sd["model.13.cv1.conv.weight"]
    with pytest.raises(KeyError, match="model.13.cv1.conv.weight"):
        yolov5_from_state_dict(sd)


@pytest.mark.parametrize("shape", [(30, 17), (200, 90), (300, 40), (60, 200), (128, 64)])
def test_pil_bilinear_resize_matches_pil(shape):
    from PIL import Image

    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(Image.fromarray(img).resize((reid.CROP_W, reid.CROP_H), Image.BILINEAR),
                      np.float32)
    got = reid.pil_resize_bilinear(img, reid.CROP_W, reid.CROP_H)
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture(scope="module")
def embedders():
    path = reid.ReIDEmbedder.bundled_weights_path()
    assert path is not None
    je = jreid.ReIDEmbedder()
    je.load_npz(path)
    pe = reid.ReIDEmbedder(device="cpu")
    pe.load_npz(path)
    return je, pe


def test_reid_embedder_matches_reference(frames, embedders):
    je, pe = embedders
    boxes = np.array([[10, 10, 50, 80], [100, 40, 60, 90.5], [600.3, 150, 180, 120],
                      [1200, 300, 60, 90], [-5, -3, 40, 30]])
    want, got = je(frames[0], boxes), pe(frames[0], boxes)
    assert got.shape == want.shape == (5, 128)
    assert np.abs(got - want).max() <= 1e-5


def test_hungarian_matches_reference():
    rng = np.random.default_rng(0)
    for k in range(50):
        r = int(rng.integers(1, 8))
        c = int(rng.integers(r, 10))
        cost = rng.uniform(0, 1, (r, c))     # continuous: the optimum is unique
        if k % 5 == 0:
            cost[rng.uniform(size=(r, c)) < 0.3] = jds.INFTY_COST
        np.testing.assert_array_equal(deepsort.hungarian(cost), jhungarian(cost))


def _deepsort_sequence():
    """tests/test_detect.py:31: two boxes, the second gone after frame 7."""
    for f in range(12):
        dets = [{"bbox": np.array([50 + 6 * f, 100, 40, 30]), "score": 0.9, "class_id": 2}]
        if f < 8:
            dets.append({"bbox": np.array([300, 200 + 4 * f, 50, 40]), "score": 0.9,
                         "class_id": 2})
        yield dets, None


def _crossing_sequence():
    """tests/test_reid.py:67: two identities cross behind a 14-frame
    occlusion and come back swapped, dimmer and closer."""
    from test_reid import PATCH, _render

    bank = make_identity_bank(2, seed=7)
    y, xa0, xb0, speed, meet, gap = 100.0, 106.0, 166.0, 0.5, 20, 14
    for i in range(meet + gap + 6):
        if meet <= i < meet + gap:
            yield [], None
            continue
        if i < meet:
            xa, xb = xa0 + speed * i, xb0 - speed * i
        else:
            xa, xb = xb0 - speed * (meet - 1), xa0 + speed * (meet - 1)
        img = _render(bank, (xa, y), (xb, y), gain=1.0 if i < meet else 0.72,
                      zoom=1.0 if i < meet else 1.3)
        yield [{"bbox": np.array([xa, y, PATCH, PATCH]), "score": 0.9, "class_id": 2},
               {"bbox": np.array([xb, y, PATCH, PATCH]), "score": 0.9, "class_id": 2}], img


@pytest.mark.parametrize("sequence", ["boxes", "crossing"])
def test_deepsort_matches_reference(sequence, embedders):
    je, pe = embedders
    if sequence == "boxes":
        frames_, want_mot, got_mot = _deepsort_sequence(), jds.DeepSort(), deepsort.DeepSort()
    else:
        frames_ = _crossing_sequence()
        want_mot = jds.DeepSort(jconfig.DetectorConfig(), embedder=je)
        got_mot = deepsort.DeepSort(config.DetectorConfig(), embedder=pe)
    confirmed = 0
    for dets, img in frames_:
        want = want_mot.update([dict(d) for d in dets], img)
        got = got_mot.update([dict(d) for d in dets], img)
        assert [t["track_id"] for t in got] == [t["track_id"] for t in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-6)
        assert [(t.track_id, t.state, t.hits, t.time_since_update) for t in got_mot.tracks] == \
            [(t.track_id, t.state, t.hits, t.time_since_update) for t in want_mot.tracks]
        confirmed += len(want)
    assert confirmed > 0


def test_ncc_match_matches_reference():
    rng = np.random.default_rng(5)
    template = rng.uniform(0, 255, (48, 48)).astype(np.float32)
    window = rng.uniform(0, 255, (96, 96)).astype(np.float32)
    window[20:68, 31:79] = template * 0.8 + 10
    want = np.asarray(jtracker._ncc_match(jnp.asarray(template), jnp.asarray(window)))
    got = tracker2d._ncc_match(torch.from_numpy(template), torch.from_numpy(window)).numpy()
    assert got.shape == want.shape == (49, 49)
    assert np.abs(got - want).max() <= 1e-5
    assert np.unravel_index(np.argmax(got), got.shape) == (20, 31)


def test_multi_tracker_matches_reference():
    """tests/test_detect.py:87's moving square, both trackers on the same
    frames."""
    rng = np.random.default_rng(42)
    tex = rng.uniform(0, 255, size=(60, 60)).astype(np.float32)

    def make_frame(pos):
        img = rng.uniform(0, 40, size=(240, 320)).astype(np.float32)
        x, y = pos
        img[y:y + 60, x:x + 60] = tex
        return img.astype(np.uint8)

    want_tr, got_tr = jtracker.MultiTracker2D(), tracker2d.MultiTracker2D(device="cpu")
    img0 = make_frame((50, 80))
    want_tr.add(img0, (50, 80, 60, 60))
    got_tr.add(img0, (50, 80, 60, 60))
    np.testing.assert_allclose(got_tr.tracks[0].template.numpy(), want_tr.tracks[0].template,
                               rtol=0, atol=1e-3)
    pos = np.array([50, 80])
    for i in range(8):
        pos = pos + np.array([6, 3])
        img = make_frame(tuple(pos))
        want, got = want_tr.update(img), got_tr.update(img)
        assert len(got) == len(want) == 1, i
        np.testing.assert_allclose(got[0].bbox, want[0].bbox, rtol=0, atol=1e-3)
        assert abs(got[0].confidence - want[0].confidence) <= 1e-5
    assert np.abs(got[0].bbox[:2] - pos).max() < 6


def test_resize_matches_jax_image_resize():
    """The tracker's resize: jax.image.resize's antialiased bilinear, down
    and up. jax applies its weights in a contraction that strays up to
    1.5e-3 grey levels from the exact product on an upscale (an upscaled
    identity comes back 0.12500763 for 0.125), so the upscale bound is
    2e-3."""
    img = np.random.default_rng(6).uniform(0, 255, (75, 130)).astype(np.float32)
    for h, w, bound in ((48, 48, 1e-3), (96, 96, 1e-3), (150, 200, 2e-3)):
        want = np.asarray(jax.image.resize(jnp.asarray(img), (h, w), "bilinear"))
        got = tracker2d.resize_bilinear(img, h, w, "cpu").numpy()
        assert np.abs(got - want).max() <= bound


def test_entry_points_default_to_the_card():
    """The detector, the ReID embedder and the ROI tracker run on the card
    unless the caller asks for the CPU: without a card they raise."""
    makers = (yolo.Detector, reid.ReIDEmbedder, tracker2d.MultiTracker2D)
    if torch.cuda.is_available():
        for make in makers:
            assert make().device.type == "cuda"
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
