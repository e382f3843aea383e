"""Keypoint patch source and the 48x48 patch gather.

Port of ``pointslot_tpu/ops/pallas_patch.py``: the canvas builders
(``pad_for_patches``, ``stack_pyramid_for_patches``) and
``extract_patches_stack``, whose TPU kernel becomes the hand-written CUDA
kernel ``csrc/patch_gather.cu``.

A patch source is a sequence of L 2-D float32 planes (pyramid levels, or
the two level-0 images). It stands for the canvas that
``stack_pyramid_for_patches`` builds from it: every plane zero-padded onto
the first plane's padded canvas, (h0 + 64, w0 + 256). ``gather_patches``
reads that canvas without building it. On a CUDA tensor it launches the
kernel, which reads the planes in place and writes the padding as zeros;
the plain version, which builds the canvas and indexes it, runs only for
CPU tensors. There is no fallback. ``LAUNCHES`` counts the kernel's
launches, ``CANVAS_BUILDS`` the calls of ``stack_pyramid_for_patches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pointslot_torch import kernels

PATCH = 48          # covers the 31x31 orientation disc and the rotated BRIEF pattern
HALF = PATCH // 2
_RX = 256           # right padding of the reference canvas (its DMA alignment slack)
_RY = 64            # bottom + top padding of the reference canvas
MAX_PLANES = 8      # the kernel's parameter struct holds this many planes

LAUNCHES = 0        # launches of the CUDA kernel in this process
CANVAS_BUILDS = 0   # calls of stack_pyramid_for_patches in this process

_fn = None


def pad_for_patches(img: torch.Tensor) -> torch.Tensor:
    """Pad (..., H, W) by HALF top/left, HALF + 16 bottom and HALF + 208
    right: the reference canvas geometry, (H + 64, W + 256)."""
    return F.pad(img, (HALF, HALF + _RX - PATCH, HALF, HALF + _RY - PATCH))


def canvas_shape(planes: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(Hp, Wp) of the canvas a patch source stands for: the first plane's
    padded size."""
    h, w = planes[0].shape[-2:]
    return h + _RY, w + _RX


def stack_pyramid_for_patches(levels) -> torch.Tensor:
    """Pad every level onto level 0's padded canvas and stack along a new
    level axis: per-level (..., h, w) -> (..., n_levels, Hp, Wp)."""
    global CANVAS_BUILDS
    CANVAS_BUILDS += 1
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
    """The reference's take path (pallas_patch.py:209-215) on a built
    canvas (L, Hp, Wp), xyl (K, 3) int32 (x, y, level) -> (K, 48, 48)."""
    L, Hp, Wp = canvas.shape
    ar = torch.arange(PATCH, dtype=torch.int32, device=canvas.device)
    lvl = _clamp_index(xyl[:, 2], L).long()
    rows = _clamp_index(xyl[:, 1:2] + ar, Hp).long()
    cols = _clamp_index(xyl[:, 0:1] + ar, Wp).long()
    return canvas[lvl[:, None, None], rows[:, :, None], cols[:, None, :]]


def gather_patches_plain(planes: Sequence[torch.Tensor], xyl: torch.Tensor) -> torch.Tensor:
    """Plain version: build the canvas, then gather from it."""
    return extract_patches_stack_plain(stack_pyramid_for_patches(list(planes)), xyl)


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("patch_gather").patch_gather
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_patches_cuda(planes: Sequence[torch.Tensor], xyl: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global LAUNCHES
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"need 1 to {MAX_PLANES} planes, got {len(planes)}")
    dev = xyl.device
    if dev.type != "cuda" or any(p.device != dev for p in planes):
        raise ValueError("planes and xyl must be on the same CUDA device")
    if xyl.dtype != torch.int32 or any(p.dtype != torch.float32 for p in planes):
        raise TypeError(f"need float32 planes and int32 xyl, got "
                        f"{[p.dtype for p in planes]}, {xyl.dtype}")
    if xyl.dim() != 2 or xyl.shape[1] != 3 or not xyl.is_contiguous():
        raise ValueError(f"need contiguous xyl (K, 3), got {tuple(xyl.shape)}")
    if any(p.dim() != 2 or p.stride(1) != 1 for p in planes):
        raise ValueError("each plane must be 2-D with unit column stride")
    K = xyl.shape[0]
    out = torch.empty((K, PATCH, PATCH), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    L = len(planes)
    Hp, Wp = canvas_shape(planes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        (ctypes.c_void_p * L)(*[p.data_ptr() for p in planes]),
        (ctypes.c_longlong * L)(*[p.stride(0) for p in planes]),
        (ctypes.c_int * L)(*[p.shape[0] for p in planes]),
        (ctypes.c_int * L)(*[p.shape[1] for p in planes]),
        L, Hp, Wp, xyl.data_ptr(), out.data_ptr(), K, stream)
    if err != 0:
        raise RuntimeError(f"patch_gather launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def gather_patches(planes: Sequence[torch.Tensor], xyl: torch.Tensor) -> torch.Tensor:
    """Patch source `planes` (L 2-D float32 planes, the first setting the
    canvas size), xyl (K, 3) int32 (x, y, plane) centers in plane pixels ->
    (K, 48, 48) float32 patches, the center at (24, 24): equal to gathering
    from stack_pyramid_for_patches(planes). The CPU runs the plain version;
    CUDA runs the kernel."""
    if xyl.device.type == "cpu":
        return gather_patches_plain(planes, xyl)
    return gather_patches_cuda(planes, xyl)
