"""The port's readers, evaluation and viewers against the JAX package's.

- PNG (``pointslot_torch/datasets/png16.py``): ``read_png`` equal to
  ``np.asarray(PIL.Image.open(path))`` (dtype and values) for 8-bit gray,
  gray + alpha, RGB, RGBA and palette, and 16-bit gray, gray + alpha, RGB
  and RGBA, on files PIL wrote (its own filter choice) and on files written
  here row by row with each of the five filter types in turn; the gray
  conversion equal to PIL's ``convert("L")`` bit for bit; the C unfilter
  helper equal to the plain numpy one; ``read_png16`` / ``write_png16``
  equal to the JAX module's; interlaced and sub-8-bit files refused.
- ``load_yaml`` against the JAX one on a file that sets every key it reads.
- The KITTI tracking (tracking, raw and flat layouts), Virtual KITTI 2
  (``.jpg`` frames through PIL, flow, camera GT) and MyntEye readers: the
  same arrays and ``Detection`` fields as the JAX readers.
- ``prefetch``: order, errors, the empty case.
- ``evaluate``: every function and the CLI against the JAX module, to
  1e-12 (the same numpy code on the same inputs).
- ``viz``: ``draw_frame``, ``draw_frame_cuboids`` and ``draw_map_topdown``
  bit-equal to the JAX renderers on the same map tables; ``LiveViewer``
  serving a frame and the map over localhost, with the page's CSS fixed.

Every comparison is exact except where a tolerance is stated.
"""

import io
import json
import struct
import sys
import threading
import time
import urllib.request
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from pointslot_tpu import config as jconfig
from pointslot_tpu import evaluate as jev
from pointslot_tpu.datasets import kitti as jkitti
from pointslot_tpu.datasets import png16 as jpng
from pointslot_tpu.datasets import prefetch as jprefetch
from pointslot_tpu.viz import live as jlive
from pointslot_tpu.viz import render as jrender
from pointslot_torch import config, evaluate
from pointslot_torch.datasets import kitti, png16
from pointslot_torch.datasets.prefetch import prefetch
from pointslot_torch.viz import live, render

EVAL_TOL = 1e-12


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _filter_row(cur: np.ndarray, prev: np.ndarray, bpp: int, ft: int) -> np.ndarray:
    """PNG filter `ft` of one row of bytes (the encoder side, PNG spec 9)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ft == 0:
        pred = np.zeros_like(cur)
    elif ft == 1:
        pred = left
    elif ft == 2:
        pred = prev
    elif ft == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
    return ((cur - pred) & 0xFF).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(path, arr, color_type: int, bit_depth: int = 8, palette=None,
               interlace: int = 0, header_depth=None) -> None:
    """Write `arr` as a PNG whose rows take the filter types 0-4 in turn."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    if bit_depth == 16:
        data = arr.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    else:
        data = arr.astype(np.uint8).reshape(h, -1)
    bpp = max(1, data.shape[1] // w)
    raw, prev = bytearray(), np.zeros(data.shape[1], np.uint8)
    for r in range(h):
        raw += bytes([r % 5]) + _filter_row(data[r], prev, bpp, r % 5).tobytes()
        prev = data[r]
    ihdr = struct.pack(">IIBBBBB", w, h, header_depth or bit_depth, color_type, 0, 0, interlace)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    out += _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


# (colour type, bit depth, trailing shape)
PNG_CASES = {
    "gray8": (0, 8, ()), "gray_alpha8": (4, 8, (2,)), "rgb8": (2, 8, (3,)),
    "rgba8": (6, 8, (4,)), "palette8": (3, 8, ()), "gray16": (0, 16, ()),
    "gray_alpha16": (4, 16, (2,)), "rgb16": (2, 16, (3,)), "rgba16": (6, 16, (4,)),
}


def _image(rng, shape, bit_depth):
    """Random samples over a gradient, so that every filter type has work."""
    base = np.add.outer(np.arange(shape[0]) * 7, np.arange(shape[1]) * 3)
    base = base.reshape(base.shape + (1,) * (len(shape) - 2))
    noise = rng.integers(0, 40, shape)
    top = 2 ** bit_depth
    return ((base * (top // 256) + noise * (top // 256)) % top).astype(
        np.uint16 if bit_depth == 16 else np.uint8)


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_decode_matches_pil_all_filter_types(case, tmp_path):
    """Hand-written PNGs, rows filtered 0, 1, 2, 3, 4, 0, ...: read_png
    equals PIL's array, the C helper equals the plain unfilter, and the
    readers' gray image equals the JAX reader's (PIL's convert("L"))."""
    color_type, depth, tail = PNG_CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (23, 37) + tail
    palette = None
    if color_type == 3:
        palette = rng.integers(0, 256, (256, 3))
        arr = rng.integers(0, 256, shape[:2]).astype(np.uint8)
    else:
        arr = _image(rng, shape, depth)
    path = str(tmp_path / f"{case}.png")
    encode_png(path, arr, color_type, depth, palette)
    want = np.asarray(Image.open(path))
    got = png16.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png16.read_png(path, plain=True), got)
    np.testing.assert_array_equal(kitti._imread_gray(path), jkitti._imread_gray(path))
    np.testing.assert_array_equal(kitti._imread_raw(path), jkitti._imread_raw(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16"])
def test_png_decode_matches_pil_on_pil_files(mode, tmp_path):
    """PNGs that PIL encoded with its own filter choice."""
    rng = np.random.default_rng(3)
    img = _image(rng, (41, 67, 3), 8)
    if mode == "I;16":
        pil = Image.fromarray((img[..., 0].astype(np.uint16) * 257 + 11).astype(np.uint16))
    elif mode == "P":
        pil = Image.fromarray(img).quantize(200)
    elif mode == "LA":
        pil = Image.fromarray(np.stack([img[..., 0], img[..., 2]], -1), "LA")
    elif mode == "RGBA":
        pil = Image.fromarray(np.concatenate([img, img[..., :1]], -1), "RGBA")
    else:
        pil = Image.fromarray(img).convert(mode)
    path = str(tmp_path / "pil.png")
    pil.save(path)
    want = np.asarray(Image.open(path))
    got = png16.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kitti._imread_gray(path), jkitti._imread_gray(path))


def test_to_gray_is_pils_rounding():
    """Every (R, G, B) corner and a random sample against convert("L")."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    rgb[0, :8] = [[r, g, b] for r in (0, 255) for g in (0, 255) for b in (0, 255)]
    np.testing.assert_array_equal(png16.to_gray(rgb),
                                  np.asarray(Image.fromarray(rgb).convert("L")))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_equals_plain(bpp):
    """Random filtered bytes (any byte is a valid filtered stream), each
    filter type on a fifth of the rows, in a shuffled order."""
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (60, 1 + 13 * bpp)).astype(np.uint8)
    rows[:, 0] = rng.permutation(np.arange(60) % 5)
    np.testing.assert_array_equal(png16._unfilter_c(rows, bpp),
                                  png16.unfilter_plain(rows, bpp))


def test_png_refusals(tmp_path):
    """Interlaced, sub-8-bit and unknown-filter files raise ValueError."""
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    encode_png(tmp_path / "adam7.png", arr, 0, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png16.read_png(str(tmp_path / "adam7.png"))
    encode_png(tmp_path / "four.png", arr[:, :4], 0, header_depth=4)
    with pytest.raises(ValueError, match="bit depth 4"):
        png16.read_png(str(tmp_path / "four.png"))
    rows = np.zeros((3, 9), np.uint8)
    rows[1, 0] = 7
    for fn in (png16._unfilter_c, png16.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 7 on row 1"):
            fn(rows, 1)


def test_png16_codec_matches_jax(tmp_path):
    """read_png16 on write_png16's files and on filtered 16-bit files, and
    write_png16's bytes, against the JAX module; _paeth too."""
    rng = np.random.default_rng(1)
    for shape in ((9, 11), (9, 11, 3)):
        arr = rng.integers(0, 65536, shape).astype(np.uint16)
        png16.write_png16(tmp_path / "p.png", arr)
        jpng.write_png16(tmp_path / "j.png", arr)
        assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
        np.testing.assert_array_equal(png16.read_png16(str(tmp_path / "p.png")), arr)
        encode_png(tmp_path / "f.png", arr, 0 if len(shape) == 2 else 2, 16)
        want = jpng.read_png16(str(tmp_path / "f.png"))
        np.testing.assert_array_equal(png16.read_png16(str(tmp_path / "f.png")), want)
        np.testing.assert_array_equal(want, arr)
    a, b, c = (rng.integers(0, 256, 500).astype(np.uint8) for _ in range(3))
    np.testing.assert_array_equal(png16._paeth(a, b, c), jpng._paeth(a, b, c))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

YAML = """%YAML:1.0
# every key the JAX load_yaml reads, none at its default (the port keeps no
# field for Camera.RGB, ORBextractor.iniThFAST or Viewer.ObjectCenter, which
# nothing reads in either package)
Camera.fx: 512.5
Camera.fy: 511.25
Camera.cx: 300.5   # trailing comment
Camera.cy: 150.25
Camera.k1: -0.01
Camera.k2: 0.002
Camera.p1: 0.0003
Camera.p2: -0.0004
Camera.width: 640
Camera.height: 320
Camera.fps: 15.0
Camera.bf: 210.0
Camera.RGB: 0
ThDepth: 40.0
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.25
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 6
Object.Width.xc: 1.7
Object.Height.yc: 1.4
Object.Length.zc: 3.9
Object.EnSelectTrackedObjId: 3
Object.EbManualSetPointMaxDistance: 1
Object.EfInObjFramePointMaxDistance: 2.5
Object.EbSetInitPositionByPoints: 0
Object.UseOfflineFlow: 1
Object.EnInitDetObjORBFeaturesNum: 25
Viewer.ObjectCenter: 1
Yolo.confThres: 0.35
Yolo.iouThres: 0.45
Yolo.weightsPath: "weights/yolo.npz"
DeepSort.weightsPath: weights/reid.npz
Tracking.MinInitStereoFeatures: 320
SLOT.MODE: 4
DynaSLAM.MODE: 1
Camera.matrix: !!opencv-matrix
"""


def _assert_same_fields(got, want, where="cfg"):
    """Every field of the port's dataclass equals the JAX one's, nested."""
    import dataclasses

    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            _assert_same_fields(g, w, f"{where}.{f.name}")
        else:
            assert g == w and type(g) is type(w), (f"{where}.{f.name}", g, w)


def test_load_yaml_matches_jax(tmp_path):
    path = tmp_path / "calib.yaml"
    path.write_text(YAML)
    assert config._parse_opencv_yaml(str(path)) == jconfig._parse_opencv_yaml(str(path))
    got, want = config.load_yaml(str(path)), jconfig.load_yaml(str(path))
    _assert_same_fields(got, want)
    assert got.camera.width == 640 and got.objects.use_offline_flow and got.slot_mode == 4
    # keys left out keep the base's values
    base = config.SystemConfig().replace(dynaslam_mode=1)
    (tmp_path / "one.yaml").write_text("%YAML:1.0\nCamera.fx: 100.0\n")
    got = config.load_yaml(str(tmp_path / "one.yaml"), base=base)
    want = jconfig.load_yaml(str(tmp_path / "one.yaml"),
                             base=jconfig.SystemConfig().replace(dynaslam_mode=1))
    _assert_same_fields(got, want)


# ---------------------------------------------------------------------------
# KITTI and Virtual KITTI readers
# ---------------------------------------------------------------------------

def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("frame_id", "track_id", "mask_value", "score", "truncated", "occluded",
                     "alpha", "is_moving", "rotation_y"):
            assert getattr(g, name) == getattr(w, name), name
        for name in ("bbox", "dims", "location_cam"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


def _assert_same_load(seq, jseq, i):
    got, want = seq.load(i), jseq.load(i)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    _assert_same_detections(got[2], want[2])


LABELS = (
    "0 1 Car 0.00 0 -1.57 100.0 60.0 180.0 120.0 1.50 1.60 3.90 2.0 1.75 15.0 0.1\n"
    "0 2 Pedestrian 0.00 0 0.2 20.0 30.0 40.0 90.0 1.80 0.60 0.80 -3.0 1.6 9.0 0.2\n"
    "0 -1 DontCare -1 -1 -10 0.0 0.0 10.0 10.0 -1 -1 -1 -1000 -1000 -1000 -10\n"
    "1 1 Van 0.10 1 -1.5 104.0 61.0 186.0 123.0 2.10 1.80 4.60 2.1 2.05 14.2 0.12\n"
    "2 3 Truck 0.00 2 0.0 200.0 50.0 260.0 110.0 3.00 2.50 8.00 6.0 1.5 30.0 0.0\n"
    "5 3 Car 0 0 0 0 0 1 1 1 1 1 0 0 0 0\n"
    "short line\n"
)


def _write_kitti(root, layout: str, n: int = 3, ext: str = ".png"):
    """A small KITTI sequence in the `layout` ("tracking", "raw", "flat")."""
    rng = np.random.default_rng(7)
    sub = {"tracking": "0000", "raw": "data", "flat": ""}[layout]
    dirs = [root / "image_02" / sub, root / "image_03" / sub]
    for d in dirs:
        d.mkdir(parents=True, exist_ok=True)
    inst_dir = root / "instances" / "0000"
    inst_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        name = f"{i:06d}{ext}" if layout != "raw" else f"{i:010d}{ext}"
        rgb = _image(rng, (130, 300, 3), 8)
        Image.fromarray(rgb).save(dirs[0] / name)
        Image.fromarray(rgb[..., 1]).save(dirs[1] / name)
        raw = np.zeros((130, 300), np.uint16)
        raw[60:120, 100:180] = 2001 + i % 2
        raw[30:90, 20:40] = 1002
        png16.write_png16(inst_dir / name, raw)
    label = root / ("ObjectTracking.txt" if layout == "flat" else "label_02/0000.txt")
    label.parent.mkdir(parents=True, exist_ok=True)
    label.write_text(LABELS)
    poses = np.tile(np.eye(4)[:3], (n, 1, 1))
    poses[:, 2, 3] = np.arange(n) * 0.7
    np.savetxt(root / "pose_gt.txt", poses.reshape(n, 12))


@pytest.mark.parametrize("layout", ["tracking", "raw", "flat"])
def test_kitti_tracking_sequence_matches_jax(layout, tmp_path):
    _write_kitti(tmp_path, layout)
    seq = kitti.KittiTrackingSequence(str(tmp_path), "0000")
    jseq = jkitti.KittiTrackingSequence(str(tmp_path), "0000")
    assert (seq.left_dir, seq.right_dir, seq.frames, seq.instances_dir, seq.flow_dir) == (
        jseq.left_dir, jseq.right_dir, jseq.frames, jseq.instances_dir, jseq.flow_dir)
    np.testing.assert_array_equal(seq.rows, jseq.rows)
    np.testing.assert_array_equal(seq.gt_poses, jseq.gt_poses)
    np.testing.assert_array_equal(seq.timestamps(10.0), jseq.timestamps(10.0))
    assert len(seq) == 3
    for i in range(len(seq)):
        _assert_same_load(seq, jseq, i)
    left, _, dets, inst = seq.load(0)
    assert left.shape == (130, 300) and len(dets) == 1 and inst.max() == dets[0].mask_value


def test_kitti_labels_and_instances():
    """Y at the bottom centre becomes the geometric centre (y - h/2); the
    non-vehicle types get type id 0; rows past n_frames are dropped; the
    instance normalisation matches by IoU."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(LABELS)
    rows = kitti.read_kitti_object_rows(f.name, n_frames=3)
    np.testing.assert_array_equal(rows, jkitti.read_kitti_object_rows(f.name, n_frames=3))
    np.testing.assert_array_equal(kitti.read_kitti_object_rows(f.name),
                                  jkitti.read_kitti_object_rows(f.name))
    assert rows.shape == (5, 24)
    np.testing.assert_allclose(rows[0, 12:15], [2.0, 1.75 - 1.5 / 2, 15.0])
    assert rows[1, 17] == 0.0 and rows[0, 17] == 1.0
    dets = [kitti.Detection.from_row24(r, mask_value=k + 1) for k, r in enumerate(rows[:2])]
    jdets = [jkitti.Detection.from_row24(r, mask_value=k + 1) for k, r in enumerate(rows[:2])]
    raw = np.zeros((130, 300), np.int32)
    raw[60:120, 100:180] = 7
    raw[30:90, 20:40] = 9
    raw[0:5, 290:300] = 11          # overlaps no detection
    got = kitti.KittiTrackingSequence._normalize_instances(raw, dets)
    np.testing.assert_array_equal(
        got, jkitti.KittiTrackingSequence._normalize_instances(raw, jdets))
    assert set(np.unique(got)) == {0, 1, 2}


def _write_vkitti(root, n: int = 2):
    rng = np.random.default_rng(11)
    left = root / "frames" / "rgb" / "Camera_0"
    right = root / "frames" / "rgb" / "Camera_1"
    inst = root / "frames" / "instanceSegmentation" / "Camera_0"
    flow = root / "frames" / "forwardFlow" / "Camera_0"
    for d in (left, right, inst, flow):
        d.mkdir(parents=True)
    for i in range(n):
        rgb = _image(rng, (96, 160, 3), 8)
        Image.fromarray(rgb).save(left / f"rgb_{i:05d}.jpg")
        Image.fromarray(rgb[::-1].copy()).save(right / f"rgb_{i:05d}.jpg")
        raw = np.zeros((96, 160), np.uint16)
        raw[20:60, 30:90] = 101
        Image.fromarray(raw).save(inst / f"instancegt_{i:05d}.png")
        f16 = rng.integers(0, 65536, (96, 160, 3)).astype(np.uint16)
        f16[::7, :, 2] = 0
        encode_png(flow / f"flow_{i:05d}.png", f16, 2, 16)
    (root / "pose.txt").write_text(
        "frame cameraID trackID alpha width height length wx wy wz r_wy r_wx r_wz "
        "cx cy cz r_cy r_cx r_cz\n"
        "0 0 1 0.1 1.6 1.5 3.5 10 0 20 0.2 0 0 2.0 1.0 15.0 0.3 0 0\n"
        "0 1 1 0.1 1.6 1.5 3.5 10 0 20 0.2 0 0 2.0 1.0 15.0 0.3 0 0\n"
        "1 0 1 0.1 1.6 1.5 3.5 10 0 20 0.2 0 0 2.1 1.0 14.0 0.3 0 0\n"
        "1 0 4 0.0 1.8 1.6 4.0 10 0 20 0.2 0 0 -2.0 1.0 25.0 0.0 0 0\n")
    (root / "bbox.txt").write_text(
        "frame cameraID trackID left right top bottom pixels trunc occ isMoving\n"
        "0 0 1 30 90 20 60 2400 0.0 0.1 True\n"
        "0 1 1 30 90 20 60 2400 0.0 0.1 True\n"
        "1 0 1 32 92 21 61 2400 0.0 0.1 False\n")
    ext = ["frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 r3,3 t3 0 0 0 1"]
    for i in range(n):
        T = np.eye(4)
        T[2, 3] = -0.5 * i
        ext.append(f"{i} 0 " + " ".join(f"{v:.9f}" for v in T.reshape(-1)))
        ext.append(f"{i} 1 " + " ".join("0" for _ in range(16)))
    (root / "extrinsic.txt").write_text("\n".join(ext) + "\n")


def test_virtual_kitti_matches_jax(tmp_path):
    """Frames (.jpg through PIL), instances, detections, flow, camera GT."""
    _write_vkitti(tmp_path)
    seq = kitti.VirtualKittiSequence(str(tmp_path))
    jseq = jkitti.VirtualKittiSequence(str(tmp_path))
    assert seq.frames == jseq.frames and seq.stereo and len(seq) == 2
    np.testing.assert_array_equal(seq.rows, jseq.rows)
    np.testing.assert_array_equal(seq.gt_poses, jseq.gt_poses)
    for i in range(len(seq)):
        _assert_same_load(seq, jseq, i)
        got, want = seq.load_flow(i), jseq.load_flow(i)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert seq.load(0)[3].max() == 1
    path = kitti.virtual_kitti_flow_path(str(tmp_path), 3, camera=1)
    assert path == jkitti.virtual_kitti_flow_path(str(tmp_path), 3, camera=1)
    np.testing.assert_array_equal(
        kitti.read_virtual_kitti_camera_gt(str(tmp_path / "extrinsic.txt")),
        jkitti.read_virtual_kitti_camera_gt(str(tmp_path / "extrinsic.txt")))
    rows = kitti.read_virtual_kitti_objects(str(tmp_path / "pose.txt"), str(tmp_path / "bbox.txt"))
    np.testing.assert_array_equal(rows, jkitti.read_virtual_kitti_objects(
        str(tmp_path / "pose.txt"), str(tmp_path / "bbox.txt")))
    assert rows[:, 18].tolist() == [1.0, 0.0]


def test_jpeg_without_pil_names_the_roadmap_line(tmp_path, monkeypatch):
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "a.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="numpy JPEG decoder"):
        kitti._imread_gray(str(tmp_path / "a.jpg"))
    # PNG needs no PIL
    png16.write_png16(tmp_path / "m.png", np.full((4, 5), 300, np.uint16))
    np.testing.assert_array_equal(kitti._imread_raw(str(tmp_path / "m.png")), 300)


def test_poses_and_mynteye_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    np.savetxt(tmp_path / "poses.txt", rng.normal(size=(5, 12)))
    np.testing.assert_array_equal(kitti.read_kitti_poses(str(tmp_path / "poses.txt")),
                                  jkitti.read_kitti_poses(str(tmp_path / "poses.txt")))
    (tmp_path / "mynt.txt").write_text("0 10 20 30 40\n1 11 21 31 41\nbad\n4 1 2 3 4 5\n")
    for kw in ({}, dict(dims=(1.0, 2.0, 3.0), location=(1.0, 0.5, 7.0), rotation_y=0.3)):
        np.testing.assert_array_equal(
            kitti.read_mynteye_object_rows(str(tmp_path / "mynt.txt"), **kw),
            jkitti.read_mynteye_object_rows(str(tmp_path / "mynt.txt"), **kw))


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_prefetch_order_errors_and_empty():
    def load(i):
        time.sleep(0.002 * ((7 * i) % 5))     # finish out of order
        return i * i

    assert list(prefetch(load, 12, depth=4, workers=3)) == [i * i for i in range(12)]
    assert list(prefetch(load, 12, depth=4, workers=3)) == list(
        jprefetch.prefetch(load, 12, depth=4, workers=3))
    assert list(prefetch(load, 0)) == [] and list(prefetch(load, -3)) == []
    assert list(prefetch(load, 1, depth=0, workers=0)) == [0]

    def failing(i):
        if i == 3:
            raise KeyError("frame 3")
        return i

    got = []
    with pytest.raises(KeyError, match="frame 3"):
        for x in prefetch(failing, 8, depth=2):
            got.append(x)
    assert got == [0, 1, 2]


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def _poses(rng, n):
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        w = rng.normal(scale=0.2, size=3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        out[i, :3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        out[i, :3, 3] = rng.normal(size=3) + [0, 0, i]
    return out


def _assert_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    elif want is None or isinstance(want, (str, bool)):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_TOL)


def test_evaluate_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    gt = _poses(rng, 12)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(12, 3))
    src = rng.normal(size=(30, 3))
    for scale in (False, True):
        _assert_close(evaluate.umeyama_alignment(src, 1.3 * src + 0.2, scale),
                      jev.umeyama_alignment(src, 1.3 * src + 0.2, scale))
        _assert_close(evaluate.ate(est, gt, with_scale=scale), jev.ate(est, gt, with_scale=scale))
    _assert_close(evaluate.ate(est, gt, align=False), jev.ate(est, gt, align=False))
    for delta in (1, 3):
        _assert_close(evaluate.rpe(est, gt, delta), jev.rpe(est, gt, delta))
    traj = [(f, np.linalg.inv(est[f]), f == 4) for f in range(12)]
    _assert_close(evaluate.evaluate_trajectory_entries(traj, gt),
                  jev.evaluate_trajectory_entries(traj, gt))
    _assert_close(evaluate.evaluate_trajectory_entries(traj[:2], gt),
                  jev.evaluate_trajectory_entries(traj[:2], gt))
    # objects: GT rows, estimates near them, one track missing a frame
    rows = np.zeros((10, 24))
    rows[:, 0] = np.arange(10) // 2
    rows[:, 1] = np.arange(10) % 2
    rows[:, 5:9] = rng.uniform(10, 100, (10, 4))
    rows[:, 12:15] = rng.normal(size=(10, 3)) + [0, 0, 10]
    rows[:, 15] = rng.uniform(-3, 3, 10)
    rows[:, 17] = 1.0
    rows[:, 18] = np.arange(10) % 3 > 0
    rows[7, 17] = 0.0
    est_cf = {}
    for r in rows[:-1]:
        T = np.eye(4)
        c, s = np.cos(r[15] + 0.05), np.sin(r[15] + 0.05)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = r[12:15] + rng.normal(scale=0.1, size=3)
        est_cf[(int(r[0]), int(r[1]))] = T
    for moving in (False, True):
        _assert_close(evaluate.object_pose_errors(est_cf, rows, moving),
                      jev.object_pose_errors(est_cf, rows, moving))
    boxes = {f: {tid + 10 * (f > 2): rows[2 * f + tid, 5:9] + 1.0 for tid in (0, 1)}
             for f in range(5)}
    boxes[1][99] = np.array([0.0, 0.0, 5.0, 5.0])
    _assert_close(evaluate.mot_metrics(boxes, rows), jev.mot_metrics(boxes, rows))
    _assert_close(evaluate.bbox_iou_matrix(rows[:, 5:9], rows[::-1, 5:9] + 3),
                  jev.bbox_iou_matrix(rows[:, 5:9], rows[::-1, 5:9] + 3))
    # the files and the CLI
    from pointslot_tpu.io.writers import write_trajectory_kitti

    write_trajectory_kitti(str(tmp_path / "est.txt"), [(f, np.linalg.inv(est[f]), False)
                                                       for f in range(12)])
    write_trajectory_kitti(str(tmp_path / "gt.txt"), [(f, np.linalg.inv(gt[f]), False)
                                                      for f in range(12)])
    with open(tmp_path / "cf.txt", "w") as f:
        for (fr, tid), T in sorted(est_cf.items()):
            f.write(f"{fr} {tid} " + " ".join(f"{v:.9f}" for v in T[:3, :4].reshape(-1)) + "\n")
    with open(tmp_path / "labels.txt", "w") as f:
        f.write(LABELS)
    _assert_close(evaluate.read_object_poses_camera_frame(str(tmp_path / "cf.txt")),
                  jev.read_object_poses_camera_frame(str(tmp_path / "cf.txt")))
    for argv in (["traj", "--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt"),
                  "--rpe-delta", "2"],
                 ["traj", "--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt"),
                  "--no-align"],
                 ["traj", "--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt"),
                  "--scale"],
                 ["objects", "--est", str(tmp_path / "cf.txt"),
                  "--gt", str(tmp_path / "labels.txt")],
                 ["objects", "--est", str(tmp_path / "cf.txt"),
                  "--gt", str(tmp_path / "labels.txt"), "--moving-only"]):
        _assert_close(json.loads(json.dumps(evaluate.main(argv))),
                      json.loads(json.dumps(jev.main(argv))))


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------

def _map_system(rng):
    """One duck-typed System (map tables, trajectory, object tracks) that
    both renderers read."""
    M = 300
    pt_pos = rng.normal(scale=[6.0, 1.0, 12.0], size=(M, 3)) + [0, 0, 15]
    pt_valid = rng.random(M) > 0.2
    kf_pose = np.tile(np.eye(4), (4, 1, 1))
    kf_pose[:, 2, 3] = -np.arange(4) * 2.0
    traj = [(f, np.linalg.inv(np.array([[1, 0, 0, 0.1 * f], [0, 1, 0, 0],
                                        [0, 0, 1, 0.8 * f], [0, 0, 0, 1.0]])), False)
            for f in range(8)]
    tracks = []
    for tid in (0, 3):
        poses = {}
        for f in range(0, 8, 2):
            T = np.eye(4)
            T[:3, 3] = [3.0 * (tid - 1), 0.8, 10 + f + tid]
            poses[f] = T
        tracks.append(SimpleNamespace(track_id=tid, poses_world=poses))
    m = SimpleNamespace(pt_pos=pt_pos, pt_valid=pt_valid, kf_pose=kf_pose,
                        keyframe_ids=lambda: np.arange(4))
    return SimpleNamespace(map=m, camera_trajectory=lambda: traj,
                           _object_system=SimpleNamespace(all_tracks=tracks))


def test_renderers_match_jax():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (120, 200)).astype(np.uint8)
    kp = rng.uniform([0, 0], [200, 120], (60, 2)).astype(np.float32)
    valid = rng.random(60) > 0.2
    bound = rng.random(60) > 0.5
    boxes = [(np.array([20.0, 30.0, 40.0, 25.0]), 3), (np.array([120.5, 10.0, 50.0, 60.0]), 9)]
    for args in ((img,), (img, kp, valid, bound, boxes, "frame 7"), (img, kp, None, None)):
        np.testing.assert_array_equal(render.draw_frame(*args), jrender.draw_frame(*args))
    rgb = render.draw_frame(img, kp, valid, bound, boxes, "frame 7")
    objects = []
    for k, (x, z, yaw) in enumerate(((-2.0, 9.0, 0.3), (3.0, 14.0, -0.5), (0.0, -3.0, 0.0))):
        T = np.eye(4)
        T[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        T[:3, 3] = [x, 0.5, z]
        objects.append((T, np.array([3.9, 1.5, 1.6]), k))
    for base in (img, rgb):
        np.testing.assert_array_equal(
            render.draw_frame_cuboids(base, objects, 150.0, 150.0, 100.0, 60.0),
            jrender.draw_frame_cuboids(base, objects, 150.0, 150.0, 100.0, 60.0))
    system = _map_system(rng)
    gt = rng.normal(size=(8, 3))
    for kw in ({}, dict(size=320, gt_trajectory=gt)):
        np.testing.assert_array_equal(render.draw_map_topdown(system, **kw),
                                      jrender.draw_map_topdown(system, **kw))
    empty = SimpleNamespace(map=SimpleNamespace(pt_pos=np.zeros((0, 3)), pt_valid=np.zeros(0, bool),
                                                kf_pose=np.zeros((0, 4, 4)),
                                                keyframe_ids=lambda: []),
                            camera_trajectory=lambda: [], _object_system=None)
    np.testing.assert_array_equal(render.draw_map_topdown(empty, size=16),
                                  jrender.draw_map_topdown(empty, size=16))


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_live_viewer_serves_frame_and_map_with_fixed_css():
    """The page is the JAX page with the CSS's percent sign single and the
    port's name; a pushed frame and map come back over localhost, and the
    MJPEG stream sends a part."""
    assert live._PAGE == (jlive._PAGE.replace(b"100%%", b"100%")
                          .replace(b"pointslot_tpu", b"pointslot_torch"))
    v = live.LiveViewer(port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{v.port}"
        status, ctype, body = _get(base + "/")
        assert status == 200 and "text/html" in ctype
        assert b"max-width:100%}" in body and b"%%" not in body
        img = np.zeros((32, 48, 3), np.uint8)
        img[8:24, 12:36] = (255, 64, 0)
        v.push_frame(img)
        v.push_map(np.full((20, 20, 3), 128, np.uint8))
        status, ctype, body = _get(base + "/frame.png")
        assert status == 200 and ctype == "image/png"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), img)
        status, ctype, body = _get(base + "/map.png")
        assert status == 200 and np.asarray(Image.open(io.BytesIO(body))).shape == (20, 20, 3)
        chunks = []

        def read_stream():
            with urllib.request.urlopen(base + "/stream", timeout=10) as r:
                chunks.append(r.read(64))

        t = threading.Thread(target=read_stream, daemon=True)
        t.start()
        for _ in range(50):
            v.push_frame(img)
            t.join(timeout=0.1)
            if not t.is_alive():
                break
        assert chunks and b"--frame" in chunks[0], chunks
    finally:
        v.close()
