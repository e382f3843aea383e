"""Plain ORB and stereo, to judge the frontend's answers.

``run_frame`` works out a frame's whole answer again from the stereo pair
alone: the pyramids, the keypoints of both images (``detect.py``), their
orientations and descriptors, and the stereo search (``stereo.py``).
``judge_frame`` works out the answer at keypoints the program chose (the
object frontend's, whose gates follow the object system's state). What each
keypoint's answer is, at its position (its level and level coordinates):

- the orientation: the intensity-centroid angle over a disc of radius 15.5
  pixels of the level image (ORB; ORB-SLAM2's IC_Angle);
- the descriptor: steered BRIEF with ORB's learned pattern (the object
  frontend's: BRIEF's Gaussian pairs) on the level image
  blurred by a 7-tap Gaussian of sigma 2, bilinear samples, bit j of word w
  the test a < b of pair 32 w + j;
- the stereo disparity: the 11x11 SAD of centre-normalised windows along the
  row (ORB-SLAM2's ComputeStereoMatches), at the right image's same level,
  at the integer position the program's match rounds to and its two
  neighbours, with the parabola's vertex as the sub-pixel position; for
  coarse octaves the program may refine on level 0, so the level-0 fit is
  taken where it lies nearer.

The pyramid is ORB-SLAM2's cascade, each level resized from the one before by
the antialiased bilinear (triangle) filter of ``jax.image.resize``, whose
weights are written out here. ``dtype`` sets the precision of every step:
float32 is the reference, bfloat16 the lower-precision control.
Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slotbench.reference import detect as ref_detect
from slotbench.reference import stereo as ref_stereo
from slotbench.reference.brief_pattern import LEARNED_PATTERN, gaussian_pattern

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
DISC_RADIUS = 15.5
SAD_HALF = 5


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    return [(max(int(round(h / scale ** l)), 16), max(int(round(w / scale ** l)), 16))
            for l in range(n_levels)]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of the antialiased bilinear resize: a triangle
    of half-width max(n_in / n_out, 1) input samples around each output
    sample's centre, normalised per output sample."""
    if n_in == n_out:
        return np.eye(n_in)
    inv = n_in / n_out
    ks = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[None, :] - np.arange(n_in)[:, None]) / ks)
    w = w / w.sum(axis=0, keepdims=True)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def pyramid(img: torch.Tensor, n_levels: int, scale: float, dtype) -> List[torch.Tensor]:
    """img (H, W) -> n_levels images, each resized from the previous one."""
    shapes = level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    out = [img.to(dtype)]
    for l in range(1, n_levels):
        (h0, w0), (h1, w1) = shapes[l - 1], shapes[l]
        R = torch.as_tensor(resize_weights(h0, h1).T, device=img.device).to(dtype)
        C = torch.as_tensor(resize_weights(w0, w1), device=img.device).to(dtype)
        out.append(R @ out[-1] @ C)
    return out


def _at(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img[y, x], zero outside the image."""
    h, w = img.shape
    ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    v = img[y.clamp(0, h - 1), x.clamp(0, w - 1)]
    return torch.where(ok, v, torch.zeros_like(v))


def orientation(level: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of the disc around each (x, y) (level
    pixels, int64)."""
    r = int(math.floor(DISC_RADIUS))
    d = torch.arange(-r, r + 1, device=level.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    disc = (dx ** 2 + dy ** 2) <= DISC_RADIUS ** 2
    dy, dx = dy[disc], dx[disc]
    vals = _at(level, y[:, None] + dy[None, :], x[:, None] + dx[None, :])
    m10 = (vals * dx.to(level.dtype)[None, :]).sum(dim=1)
    m01 = (vals * dy.to(level.dtype)[None, :]).sum(dim=1)
    return torch.atan2(m01, m10)


def gaussian_blur(level: torch.Tensor) -> torch.Tensor:
    """7-tap sigma-2 Gaussian, separable, zero padding."""
    k = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    k = torch.as_tensor(k / k.sum(), device=level.device).to(level.dtype)
    x = level[None, None]
    x = F.conv2d(F.pad(x, (0, 0, 3, 3)), k.reshape(1, 1, 7, 1))
    x = F.conv2d(F.pad(x, (3, 3, 0, 0)), k.reshape(1, 1, 1, 7))
    return x[0, 0]


def _bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    xi, yi = x0.long(), y0.long()
    a0 = (1 - fy) * _at(img, yi, xi) + fy * _at(img, yi + 1, xi)
    a1 = (1 - fy) * _at(img, yi, xi + 1) + fy * _at(img, yi + 1, xi + 1)
    return (1 - fx) * a0 + fx * a1


def pattern(kind: str) -> np.ndarray:
    if kind == "learned":
        return LEARNED_PATTERN
    if kind == "gaussian":
        return gaussian_pattern()
    raise ValueError(f"unknown BRIEF pattern {kind!r}")


def brief(blurred: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
          angle: torch.Tensor, kind: str = "learned") -> torch.Tensor:
    """(K, 8) uint32-valued int64 words of steered BRIEF at (x, y)."""
    pat = torch.as_tensor(pattern(kind), device=blurred.device).to(blurred.dtype)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    def sample(px, py):
        sx = x.to(blurred.dtype)[:, None] + ca * px[None, :] - sa * py[None, :]
        sy = y.to(blurred.dtype)[:, None] + sa * px[None, :] + ca * py[None, :]
        return _bilinear(blurred, sx, sy)

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])     # (K, 256)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)


def sad_vertex(left: torch.Tensor, right: torch.Tensor, xl: torch.Tensor, yl: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Sub-pixel right position at level pixels: the parabola through the
    SADs of the centre-normalised 11x11 windows at c - 1, c, c + 1."""
    d = torch.arange(-SAD_HALF, SAD_HALF + 1, device=left.device)
    rows = yl[:, None, None] + d[None, :, None]
    lw = _at(left, rows, xl[:, None, None] + d[None, None, :])
    lw = lw - _at(left, yl, xl)[:, None, None]
    sads = []
    for off in (-1, 0, 1):
        cc = c + off
        rw = _at(right, rows, cc[:, None, None] + d[None, None, :])
        rw = rw - _at(right, yl, cc)[:, None, None]
        sads.append(torch.abs(lw - rw).sum(dim=(1, 2)))
    s_m, s_0, s_p = sads
    denom = s_m + s_p - 2 * s_0
    ok = torch.abs(denom) > 1e-6
    delta = torch.where(ok, (s_m - s_p) / (2 * torch.where(ok, denom, torch.ones_like(denom))),
                        torch.zeros_like(denom))
    return c.to(left.dtype) + delta


def judge_frame(left: np.ndarray, right: np.ndarray, xy: np.ndarray, level: np.ndarray,
                valid: np.ndarray, u_right: np.ndarray, n_levels: int, scale: float,
                fine_min_level: int, device, dtype=torch.float32,
                kind: str = "learned") -> dict:
    """The reference's answers at the frame's valid keypoints, in `dtype`:
    angle (K,), desc (K, 8) words, and for keypoints with a right match the
    sub-pixel right position (K,) at the keypoint's level and on level 0
    (NaN where not applicable)."""
    keep = np.nonzero(valid)[0]
    lv = torch.as_tensor(level[keep], device=device).long()
    scales = scale ** lv.double()
    xl = torch.round(torch.as_tensor(xy[keep, 0], device=device).double() / scales).long()
    yl = torch.round(torch.as_tensor(xy[keep, 1], device=device).double() / scales).long()
    L = pyramid(torch.as_tensor(left, device=device), n_levels, scale, dtype)
    R = pyramid(torch.as_tensor(right, device=device), n_levels, scale, dtype)
    K = len(keep)
    angle = torch.zeros(K, dtype=dtype, device=device)
    desc = torch.zeros((K, 8), dtype=torch.int64, device=device)
    u_lvl = torch.full((K,), float("nan"), dtype=torch.float64, device=device)
    u_l0 = torch.full((K,), float("nan"), dtype=torch.float64, device=device)
    ur = torch.as_tensor(u_right[keep], device=device).double()
    has = ur >= 0
    for l in range(n_levels):
        m = lv == l
        if not bool(m.any()):
            continue
        a = orientation(L[l], xl[m], yl[m])
        angle[m] = a
        desc[m] = brief(gaussian_blur(L[l]), xl[m], yl[m], a, kind)
        ms = m & has
        if bool(ms.any()):
            s = scale ** l
            c = torch.round(ur[ms] / s).long()
            u_lvl[ms] = s * sad_vertex(L[l], R[l], xl[ms], yl[ms], c).double()
            if l >= fine_min_level:
                x0 = torch.round(torch.as_tensor(xy[keep, 0], device=device)[ms].double()).long()
                y0 = torch.round(torch.as_tensor(xy[keep, 1], device=device)[ms].double()).long()
                u_l0[ms] = sad_vertex(L[0], R[0], x0, y0, torch.round(ur[ms]).long()).double()
    return dict(keep=keep, angle=angle.double().cpu().numpy(),
                desc=desc.cpu().numpy().astype(np.uint32),
                u_lvl=u_lvl.cpu().numpy(), u_l0=u_l0.cpu().numpy())


def frame_numbers(prog_angle: np.ndarray, prog_desc: np.ndarray, prog_ur: np.ndarray,
                  prog_depth: np.ndarray, ul: np.ndarray, ref: dict, bf: float) -> dict:
    """Per-frame raw gaps between answers and the reference: |angle gap|
    per keypoint, the differing descriptor bits, and per stereo keypoint the
    gap in pixels between the program's disparity (bf / depth) and the
    reference's (ul - its right position, the nearer of the two fits)."""
    gap = np.abs(np.angle(np.exp(1j * (prog_angle - ref["angle"]))))
    x = np.bitwise_xor(prog_desc.astype(np.uint32), ref["desc"])
    bits = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
    st = (prog_depth > 0) & (prog_ur >= 0)
    disp = bf / np.where(st, prog_depth, 1.0)
    e_lvl = np.abs(disp - (ul - ref["u_lvl"]))
    e_l0 = np.abs(disp - (ul - ref["u_l0"]))
    e = np.fmin(e_lvl, e_l0)[st]
    return dict(angle=gap, bits=bits, disparity=np.where(np.isnan(e), np.inf, e))


def describe(levels: List[torch.Tensor], level: np.ndarray, x: np.ndarray, y: np.ndarray,
             kind: str = "learned"):
    """Angles (n,) float64 and descriptors (n, 8) uint32 of keypoints at
    level pixels (x, y) of `level`."""
    dev = levels[0].device
    angle = np.zeros(len(level))
    desc = np.zeros((len(level), 8), np.uint32)
    for l, img in enumerate(levels):
        m = np.nonzero(level == l)[0]
        if not len(m):
            continue
        xl, yl = torch.as_tensor(x[m], device=dev), torch.as_tensor(y[m], device=dev)
        a = orientation(img, xl, yl)
        angle[m] = a.double().cpu().numpy()
        desc[m] = brief(gaussian_blur(img), xl, yl, a, kind).cpu().numpy().astype(np.uint32)
    return angle, desc


def run_frame(left: np.ndarray, right: np.ndarray, orb, fx: float, bf: float, device,
              dtype=torch.float32, gate=None) -> dict:
    """The frontend's answer for a stereo pair, worked out in `dtype`:
    every kept left keypoint, level by level and best first, with its level
    and level pixels (level, x, y), level-0 position xy (float32), angle,
    descriptor, right position and depth (-1 without a match), and `valid`.
    `gate`: the left image's (H, W) boolean allowed region, or None; the
    right image is not gated. Under a gate the frame keeps a keypoint only
    where the gate allows its rounded level-0 pixel."""
    L = pyramid(torch.as_tensor(left, device=device), orb.n_levels, orb.scale_factor, dtype)
    R = pyramid(torch.as_tensor(right, device=device), orb.n_levels, orb.scale_factor, dtype)
    budgets = ref_detect.level_budgets(orb.n_features, orb.n_levels, orb.scale_factor)
    sc = np.array([orb.scale_factor ** l for l in range(orb.n_levels)], np.float32)
    sides = []
    for levels, g in ((L, gate), (R, None)):
        kp = ref_detect.detect(levels, budgets, float(orb.min_th_fast), g)
        kp["xy"] = np.stack([kp["x"].astype(np.float32) * sc[kp["level"]],
                             kp["y"].astype(np.float32) * sc[kp["level"]]], axis=1)
        kp["angle"], kp["desc"] = describe(levels, kp["level"], kp["x"], kp["y"],
                                           orb.brief_pattern)
        kp["valid"] = np.ones(len(kp["level"]), bool)
        sides.append(kp)
    out, right_kp = sides
    out.update(ref_stereo.search(L, R, out, right_kp, orb.scale_factor, fx, bf,
                                 orb.stereo_match_th, orb.stereo_fine_min_level))
    if gate is not None:
        g = np.asarray(gate)
        yi = np.clip(np.round(out["xy"][:, 1]).astype(int), 0, g.shape[0] - 1)
        xi = np.clip(np.round(out["xy"][:, 0]).astype(int), 0, g.shape[1] - 1)
        out["valid"] = g[yi, xi]
    return out
