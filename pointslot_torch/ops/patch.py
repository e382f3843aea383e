"""Keypoint patch canvas and the 48x48 patch gather.

Port of ``pointslot_tpu/ops/pallas_patch.py``: the canvas builders
(``pad_for_patches``, ``stack_pyramid_for_patches``) and
``extract_patches_stack``, whose TPU kernel becomes the hand-written CUDA
kernel ``csrc/patch_gather.cu``.

``extract_patches_stack`` takes the plain PyTorch version only for a tensor
on the CPU. For a CUDA tensor it launches the kernel or raises; there is no
fallback. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pointslot_torch import kernels

PATCH = 48          # covers the 31x31 orientation disc and the rotated BRIEF pattern
HALF = PATCH // 2
_RX = 256           # right padding of the reference canvas (its DMA alignment slack)

LAUNCHES = 0        # launches of the CUDA kernel in this process

_fn = None


def pad_for_patches(img: torch.Tensor) -> torch.Tensor:
    """Pad (..., H, W) by HALF top/left, HALF + 16 bottom and HALF + 208
    right: the reference canvas geometry, (H + 64, W + 256)."""
    return F.pad(img, (HALF, HALF + _RX - PATCH, HALF, HALF + 16))


def stack_pyramid_for_patches(levels) -> torch.Tensor:
    """Pad every level onto level 0's padded canvas and stack along a new
    level axis: per-level (..., h, w) -> (..., n_levels, Hp, Wp)."""
    ref = pad_for_patches(levels[0])
    Hp, Wp = ref.shape[-2:]
    out = [ref]
    for im in levels[1:]:
        h, w = im.shape[-2:]
        out.append(F.pad(im, (HALF, Wp - w - HALF, HALF, Hp - h - HALF)))
    return torch.stack(out, dim=-3)


def _clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX indexing semantics: negative counts from the end, then clip."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def extract_patches_stack_plain(canvas: torch.Tensor, xyl: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's take path, pallas_patch.py:209-215):
    canvas (L, Hp, Wp), xyl (K, 3) int32 (x, y, level) -> (K, 48, 48)."""
    L, Hp, Wp = canvas.shape
    ar = torch.arange(PATCH, dtype=torch.int32, device=canvas.device)
    lvl = _clamp_index(xyl[:, 2], L).long()
    rows = _clamp_index(xyl[:, 1:2] + ar, Hp).long()
    cols = _clamp_index(xyl[:, 0:1] + ar, Wp).long()
    return canvas[lvl[:, None, None], rows[:, :, None], cols[:, None, :]]


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("patch_gather").patch_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def extract_patches_stack_cuda(canvas: torch.Tensor, xyl: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global LAUNCHES
    if canvas.device.type != "cuda" or xyl.device != canvas.device:
        raise ValueError("canvas and xyl must be on the same CUDA device")
    if canvas.dtype != torch.float32 or xyl.dtype != torch.int32:
        raise TypeError(f"need float32 canvas and int32 xyl, got {canvas.dtype}, {xyl.dtype}")
    if canvas.dim() != 3 or xyl.dim() != 2 or xyl.shape[1] != 3:
        raise ValueError(f"need canvas (L, Hp, Wp) and xyl (K, 3), got "
                         f"{tuple(canvas.shape)}, {tuple(xyl.shape)}")
    if not (canvas.is_contiguous() and xyl.is_contiguous()):
        raise ValueError("canvas and xyl must be contiguous")
    K = xyl.shape[0]
    out = torch.empty((K, PATCH, PATCH), dtype=torch.float32, device=canvas.device)
    if K == 0:
        return out
    L, Hp, Wp = canvas.shape
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    err = _kernel()(canvas.data_ptr(), xyl.data_ptr(), out.data_ptr(),
                    K, L, Hp, Wp, stream)
    if err != 0:
        raise RuntimeError(f"patch_gather launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def extract_patches_stack(canvas: torch.Tensor, xyl: torch.Tensor) -> torch.Tensor:
    """canvas (L, Hp, Wp) from stack_pyramid_for_patches, xyl (K, 3) int32
    (x, y, level) centers -> (K, 48, 48) float32 patches, keypoint at
    (24, 24). The CPU runs the plain version; CUDA runs the kernel."""
    if canvas.device.type == "cpu":
        return extract_patches_stack_plain(canvas, xyl)
    return extract_patches_stack_cuda(canvas, xyl)
