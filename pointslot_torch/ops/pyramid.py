"""Image pyramid as two dense resize matrices per level.

Port of ``pointslot_tpu/ops/pyramid.py``. The reference builds each level
as ``R @ prev @ C`` where R and C come from ``jax.image.resize`` of an
identity matrix (bilinear, antialiased triangle taps). This module rebuilds
the same weights in numpy from jax's formula (``compute_weight_mat`` in
``jax/_src/image/scale.py``), bit for bit: float32 throughout, and the
per-column weight sum taken in XLA's CPU order (windows of 32 input rows,
the padding split low/high, each window summed in order, then the windows
in order). ``torch.nn.functional.interpolate(antialias=True)`` is not the
same filter.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

_SUM_WINDOW = 32


def level_shapes(h: int, w: int, n_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def _column_sums(w: np.ndarray) -> np.ndarray:
    """Sum (n_in, n_out) float32 over axis 0 in XLA's CPU reduction order."""
    n = w.shape[0]
    pad = (-n) % _SUM_WINDOW
    lo = pad // 2
    wp = np.concatenate([
        np.zeros((lo, w.shape[1]), w.dtype), w,
        np.zeros((pad - lo, w.shape[1]), w.dtype),
    ]).reshape(-1, _SUM_WINDOW, w.shape[1])
    part = wp[:, 0]
    for j in range(1, _SUM_WINDOW):
        part = part + wp[:, j]
    total = part[0]
    for k in range(1, part.shape[0]):
        total = total + part[k]
    return total[None, :]


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a 1-D antialiased bilinear resize."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = _column_sums(w)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(np.float32)


def resize_mats(h_in: int, w_in: int, h_out: int, w_out: int):
    """R (h_out, h_in) and C (w_in, w_out) with resize(img) == R @ img @ C."""
    return _resize_weights(h_in, h_out).T.copy(), _resize_weights(w_in, w_out)


def pyramid_mats(h: int, w: int, n_levels: int, scale_factor: float,
                 device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-level (R, C) tensors on `device` for levels 1..n_levels-1."""
    shapes = level_shapes(h, w, n_levels, scale_factor)
    out = []
    for lvl in range(1, n_levels):
        R, C = resize_mats(*shapes[lvl - 1], *shapes[lvl])
        out.append((torch.from_numpy(R).to(device), torch.from_numpy(C).to(device)))
    return out


def build_pyramid(img: torch.Tensor, mats) -> List[torch.Tensor]:
    """img (..., H, W) float32 -> per-level images, each level a resize of
    the PREVIOUS level (the reference's cascade). `mats` from pyramid_mats."""
    out = [img]
    for R, C in mats:
        out.append(torch.matmul(torch.matmul(R, out[-1]), C))
    return out


@functools.lru_cache(maxsize=8)
def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)
