"""PNG decoding without PIL, and the 16-bit PNG codec.

The port needs no PIL to read its datasets: every KITTI image, instance
mask and Virtual KITTI flow map is decoded here. ``zlib`` (C, in the
standard library) inflates the stream; the row unfiltering, a per-byte
recurrence, runs in the host C helper ``csrc/png_unfilter.c`` (built by
``kernels.load_host`` at first use). ``unfilter_plain`` is its numpy and
Python version, the oracle of the tests.

``read_png`` returns what ``np.asarray(PIL.Image.open(path))`` returns,
dtype and values, for the non-interlaced PNGs of 8 and 16 bits per sample:
gray (uint8, or uint16 at 16 bits), gray + alpha, RGB, RGBA (uint8; PIL
keeps the high byte of 16-bit samples, and opens 16-bit gray + alpha as
RGBA) and palette (the uint8 indices).
``read_png_gray`` is the readers' ``Image.open(path)``, then
``convert("L")`` unless the image is gray already, with PIL's integer
rounding (``to_gray``). Interlaced (Adam7) PNGs and samples below 8 bits
raise ``ValueError``.

``read_png16`` and ``write_png16`` keep the behaviour of
``pointslot_tpu/datasets/png16.py``: Virtual KITTI 2's forward flow maps
are 16-bit RGB PNGs, which PIL downcasts to uint8, so they are decoded
here to uint16 (bit depth 16, gray or RGB only).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from pointslot_torch import kernels

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}

_unfilter_fn = None


class PngImage(NamedTuple):
    array: np.ndarray                # as np.asarray(PIL.Image.open(path))
    mode: str                        # PIL's mode: L, LA, RGB, RGBA, P or I;16
    palette: Optional[np.ndarray]    # (256, 3) uint8 for mode P, else None
    samples: Optional[np.ndarray]    # (H, W, C) uint16 of a 16-bit image, else None


def _paeth(a, b, c):
    # a = left, b = up, c = up-left (per-byte predictor, PNG spec 9.4)
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _paeth_int(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Plain unfilter: (H, 1 + stride) uint8 filtered rows -> (H, stride)
    uint8. None, Sub and Up are numpy over the row; Average and Paeth,
    whose bytes depend on the byte just unfiltered, a Python loop."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ft = int(rows[r, 0])
        cur = rows[r, 1:]
        if ft == 0:
            out[r] = cur
        elif ft == 1:    # Sub: prefix sum (mod 256) over each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint32)
            lanes[:stride] = cur
            out[r] = np.cumsum(lanes.reshape(-1, bpp), axis=0).astype(np.uint8).reshape(-1)[:stride]
        elif ft == 2:    # Up
            out[r] = (cur.astype(np.int32) + prev).astype(np.uint8)
        elif ft in (3, 4):
            raw, up, row = cur.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                if ft == 3:    # Average
                    row[i] = (raw[i] + ((left + up[i]) >> 1)) & 0xFF
                else:          # Paeth
                    ul = up[i - bpp] if i >= bpp else 0
                    row[i] = (raw[i] + _paeth_int(left, up[i], ul)) & 0xFF
            out[r] = row
        else:
            raise ValueError(f"unknown PNG filter type {ft} on row {r}")
        prev = out[r]
    return out


def _unfilter_c(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The C helper on (H, 1 + stride) uint8 rows -> (H, stride) uint8."""
    global _unfilter_fn
    if _unfilter_fn is None:
        fn = kernels.load_host("png_unfilter").png_unfilter
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _unfilter_fn = fn
    rows = np.ascontiguousarray(rows, np.uint8)
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, stride), np.uint8)
    bad = _unfilter_fn(rows.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"unknown PNG filter type {rows[bad - 1, 0]} on row {bad - 1}")
    return out


def decode_png(path: str, plain: bool = False) -> PngImage:
    """Decode a non-interlaced PNG of 8 or 16 bits per sample. `plain`
    unfilters with ``unfilter_plain`` instead of the C helper."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    header, palette, idat = None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(body, np.uint8)[:768].reshape(-1, 3)
            palette[:len(entries)] = entries
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, bit_depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: unsupported color type {color_type}")
    if bit_depth not in (8, 16) or (color_type == 3 and bit_depth != 8):
        raise ValueError(f"{path}: bit depth {bit_depth} unsupported (8 or 16 bits per "
                         f"sample only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs unsupported")
    if color_type == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data ends early")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = (unfilter_plain if plain else _unfilter_c)(rows, bpp)
    img = out.reshape(height, width, channels, bit_depth // 8)
    samples = None
    if bit_depth == 16:
        samples = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        if color_type == 0:
            return PngImage(samples[:, :, 0], "I;16", None, samples)
        if color_type == 4:         # PIL opens 16-bit gray + alpha as RGBA
            hi = img[..., 0]
            rgba = np.ascontiguousarray(hi[:, :, [0, 0, 0, 1]])
            return PngImage(rgba, "RGBA", None, samples)
    img = img[..., 0]               # 16 bits: PIL keeps the high byte
    arr = img[:, :, 0] if channels == 1 else img
    return PngImage(np.ascontiguousarray(arr), _MODES[color_type],
                    palette if color_type == 3 else None, samples)


def read_png(path: str, plain: bool = False) -> np.ndarray:
    """What ``np.asarray(PIL.Image.open(path))`` returns for the PNG."""
    return decode_png(path, plain).array


def to_gray(arr: np.ndarray) -> np.ndarray:
    """(..., >=3) uint8 RGB[A] -> uint8 luma with ``Image.convert("L")``'s
    rounding: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = np.asarray(arr).astype(np.uint32)
    y = 19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000
    return (y >> 16).astype(np.uint8)


def read_png_gray(path: str, plain: bool = False) -> np.ndarray:
    """A PNG as the readers' gray image: ``Image.open`` and, unless the
    image is gray already, ``convert("L")`` (the palette's colours, the
    gray channel of gray + alpha); 16-bit gray scaled by its maximum to
    uint8."""
    img = decode_png(path, plain)
    arr = img.array
    if img.mode == "P":
        arr = to_gray(img.palette[arr])
    elif img.mode == "LA":
        arr = arr[..., 0].copy()
    elif img.mode in ("RGB", "RGBA"):
        arr = to_gray(arr)
    if arr.dtype != np.uint8:
        arr = (arr / max(arr.max(), 1) * 255).astype(np.uint8)
    return arr


def read_png16(path: str) -> np.ndarray:
    """Decode a 16-bit PNG -> (H, W) or (H, W, 3) uint16."""
    img = decode_png(path)
    if img.samples is None:
        raise ValueError(f"{path}: bit depth 8, expected 16")
    if img.mode not in ("I;16", "RGB"):
        raise ValueError(f"{path}: unsupported color type for a 16-bit map ({img.mode})")
    return img.array if img.mode == "I;16" else img.samples


def write_png(path: str, arr: np.ndarray, cycle_filters: bool = False) -> None:
    """Encode (H, W) or (H, W, 3) uint8 or uint16 -> an 8- or 16-bit gray or
    RGB PNG. Every row takes filter 0 (None), or with `cycle_filters` the
    five filter types in turn (PNG spec 9: None, Sub, Up, Average, Paeth)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {arr.dtype}")
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"unsupported shape {arr.shape}")
    h, w = arr.shape[:2]
    cur = (np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))
           .view(np.uint8).reshape(h, -1).astype(np.int32))
    ft = np.arange(h) % 5 if cycle_filters else np.zeros(h, np.int64)
    if cycle_filters:
        bpp = cur.shape[1] // w
        prev = np.vstack([np.zeros((1, cur.shape[1]), np.int32), cur[:-1]])
        left = np.hstack([np.zeros((h, bpp), np.int32), cur[:, :-bpp]])
        up_left = np.hstack([np.zeros((h, bpp), np.int32), prev[:, :-bpp]])
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        preds = [np.zeros_like(cur), left, prev, (left + prev) >> 1,
                 np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))]
        cur = (cur - np.choose(ft[:, None], preds)) & 0xFF
    raw = np.hstack([ft[:, None], cur]).astype(np.uint8).tobytes()

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * arr.itemsize, color_type,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def write_png16(path: str, arr: np.ndarray) -> None:
    """Encode (H, W) or (H, W, 3) uint16 -> 16-bit PNG (filter 0)."""
    write_png(path, np.asarray(arr, np.uint16))
