"""The PNGs the port's decoder leaves to PIL: Adam7-interlaced files and
samples below 8 bits. The KITTI readers (``_imread_gray``, ``_imread_raw``)
read them through PIL and give the JAX readers' arrays exactly; the
decoder itself still refuses them (``png16.NeedsPil``), and without PIL
the readers raise an ImportError that names PIL. Files are built here from
seeded numpy arrays.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from pointslot_tpu.datasets import kitti as jkitti
from pointslot_torch.datasets import kitti, png16

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))     # (x0, y0, dx, dy) of the seven passes


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _rows(img: np.ndarray, depth: int) -> bytes:
    """Filter-0 scanlines of an (h, w[, c]) image at `depth` bits a sample."""
    h = img.shape[0]
    out = bytearray()
    for r in range(h):
        row = img[r].reshape(-1)
        if depth < 8:
            shifts = np.arange(depth - 1, -1, -1)
            data = np.packbits(((row[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1))
        elif depth == 16:
            data = row.astype(">u2").view(np.uint8)
        else:
            data = row.astype(np.uint8)
        out += b"\x00" + data.tobytes()
    return bytes(out)


def write_png(path, img: np.ndarray, color_type: int, depth: int, interlace: int,
              palette=None) -> None:
    h, w = img.shape[:2]
    if interlace:
        raw = b"".join(_rows(img[y0::dy, x0::dx], depth) for x0, y0, dx, dy in _ADAM7
                       if img[y0::dy, x0::dx].size)
    else:
        raw = _rows(img, depth)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                              color_type, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    out += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


# name: (colour type, bit depth, interlace, trailing shape)
CASES = {
    "gray1": (0, 1, 0, ()), "gray2": (0, 2, 0, ()), "gray4": (0, 4, 0, ()),
    "palette1": (3, 1, 0, ()), "palette2": (3, 2, 0, ()), "palette4": (3, 4, 0, ()),
    "gray4_adam7": (0, 4, 1, ()), "gray8_adam7": (0, 8, 1, ()), "rgb8_adam7": (2, 8, 1, (3,)),
    "rgba8_adam7": (6, 8, 1, (4,)), "gray16_adam7": (0, 16, 1, ()),
    "palette8_adam7": (3, 8, 1, ()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pil_only_pngs_read_as_reference(name, tmp_path):
    color_type, depth, interlace, trail = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    top = (1 << depth) - 1 if color_type in (0, 3) else 255
    img = rng.integers(0, top + 1, (13, 11) + trail).astype(np.uint16 if depth == 16
                                                            else np.uint8)
    palette = rng.integers(0, 256, (1 << min(depth, 8), 3)) if color_type == 3 else None
    path = str(tmp_path / f"{name}.png")
    write_png(path, img, color_type, depth, interlace, palette)
    with pytest.raises(png16.NeedsPil):
        png16.read_png(path)
    for port_fn, ref_fn in ((kitti._imread_gray, jkitti._imread_gray),
                            (kitti._imread_raw, jkitti._imread_raw)):
        got, want = port_fn(path), ref_fn(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pil_only_png_without_pil_names_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "adam7.png")
    write_png(path, np.arange(64, dtype=np.uint8).reshape(8, 8), 0, 8, 1)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for fn in (kitti._imread_gray, kitti._imread_raw):
        with pytest.raises(ImportError, match="needs PIL"):
            fn(path)
