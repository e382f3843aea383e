"""Plain stereo matching, to judge which keypoints the frontend gives a depth
and at what disparity (ORB-SLAM2's ``Frame::ComputeStereoMatches`` as the
port's frontend runs it):

1. the candidate: among the right image's keypoints on a row band of twice
   the right keypoint's scale, on the left keypoint's level or one next to
   it, and between 0 and fx pixels to the left, the one of least Hamming
   distance (the first of equals); a match if under the threshold;
2. the search: at the left keypoint's level, the 11x11 window around the
   keypoint, less its centre pixel, against the right image's windows at the
   candidate's column (in the left keypoint's level pixels) shifted by -5 to
   +5, each less its own centre: the least sum of absolute differences, a
   parabola through it and its two neighbours, refused at the end of the
   range or a vertex a pixel or more off, or a disparity not under fx;
3. a match whose SAD exceeds 1.5 x 1.4 times the median of the frame's
   matched SADs is dropped; the depth is bf over the disparity;
4. a keypoint of level `fine_min_level` or above is searched again on level
   0 around the rounded right position, and takes that answer if it stays
   within 5 pixels.

``dtype`` sets the precision of the image arithmetic; positions are
float32, as the configuration states. Nothing here imports the program.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

W = 5          # window half-size
SLIDE = 5      # shifts either way
BIG = 1 << 20


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 8) and (m, 8) uint32 words -> (n, m) differing bits."""
    x = np.bitwise_xor(a[:, None, :].astype(np.uint32), b[None, :, :].astype(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int64)


def candidates(xy_l, lvl_l, desc_l, valid_l, xy_r, lvl_r, desc_r, valid_r,
               scales: np.ndarray, fx: float, threshold: int):
    """(best right index (n,), matched (n,)); `scales` the levels' float32
    scale factors."""
    f32 = np.float32
    band = f32(2.0) * scales[lvl_r]
    yl, yr = xy_l[:, 1].astype(f32), xy_r[:, 1].astype(f32)
    ul, ur = xy_l[:, 0].astype(f32), xy_r[:, 0].astype(f32)
    ok = (valid_l[:, None] & valid_r[None, :]
          & (np.abs(yl[:, None] - yr[None, :]) <= band[None, :])
          & (np.abs(lvl_l[:, None] - lvl_r[None, :]) <= 1)
          & (ur[None, :] <= ul[:, None]) & (ur[None, :] >= ul[:, None] - f32(fx)))
    dist = np.where(ok, hamming(desc_l, desc_r), BIG)
    best = np.argmin(dist, axis=1)
    return best, dist[np.arange(len(best)), best] < threshold


def _at(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    return img[y.clamp(0, h - 1), x.clamp(0, w - 1)]


def scan(left: torch.Tensor, right: torch.Tensor, xl: torch.Tensor, yl: torch.Tensor,
         xr: torch.Tensor):
    """SADs of the centre-normalised 11x11 left window at (xl, yl) against
    the right windows centred at xr - 5 .. xr + 5 on row yl: (best shift
    index k in 0..10, its SAD, interior, parabola vertex offset, vertex
    within a pixel)."""
    d = torch.arange(-W, W + 1, device=left.device)
    rows = yl[:, None, None] + d[None, :, None]
    lw = _at(left, rows, xl[:, None, None] + d[None, None, :])
    lw = lw - _at(left, yl, xl)[:, None, None]
    sads = []
    for k in range(2 * SLIDE + 1):
        c = xr + (k - SLIDE)
        rw = _at(right, rows, c[:, None, None] + d[None, None, :])
        rw = rw - _at(right, yl, c)[:, None, None]
        sads.append(torch.abs(lw - rw).sum(dim=(1, 2)).float())
    sads = torch.stack(sads, dim=1)
    best = torch.argmin(sads, dim=1)
    take = lambda i: sads.gather(1, i[:, None])[:, 0]   # noqa: E731
    s0 = take(best)
    s_m = take((best - 1).clamp(0, 2 * SLIDE))
    s_p = take((best + 1).clamp(0, 2 * SLIDE))
    denom = s_m + s_p - 2.0 * s0
    delta = torch.where(denom.abs() > 1e-6, (s_m - s_p) / (2.0 * denom), torch.zeros_like(denom))
    return (best, s0, (best > 0) & (best < 2 * SLIDE), delta, (delta > -1.0) & (delta < 1.0))


def median_of_matched(sad: np.ndarray) -> float:
    """The median, the mean of the two middle values of an even count; NaN
    when there is none."""
    return float(np.median(sad)) if len(sad) else float("nan")


def search(L: List[torch.Tensor], R: List[torch.Tensor], left: dict, right: dict,
           scale: float, fx: float, bf: float, threshold: int, fine_min_level: int) -> dict:
    """u_right (n,) and depth (n,) of the left keypoints, -1 without a
    match. `left` and `right`: xy (level-0 float32), level, desc, valid."""
    f32 = np.float32
    dev = L[0].device
    n = len(left["level"])
    sc = np.array([scale ** l for l in range(len(L))], f32)
    inv = f32(1.0) / sc
    best, matched = candidates(left["xy"], left["level"], left["desc"], left["valid"],
                               right["xy"], right["level"], right["desc"], right["valid"],
                               sc, fx, threshold)
    lvl = left["level"]
    ul = left["xy"][:, 0].astype(f32)
    vl = left["xy"][:, 1].astype(f32)
    ur0 = right["xy"][best, 0].astype(f32) if n else np.zeros(0, f32)
    xs = np.round(ul * inv[lvl]).astype(np.int64)
    ys = np.round(vl * inv[lvl]).astype(np.int64)
    xr = np.round(ur0 * inv[lvl]).astype(np.int64)
    shapes = np.array([img.shape for img in L])
    lh, lw = shapes[lvl, 0], shapes[lvl, 1]
    inb = ((ys - W >= 0) & (ys + W < lh) & (xs - W >= 0) & (xs + W < lw)
           & (xr - W - SLIDE >= 0) & (xr + W + SLIDE < lw))
    u_right = np.full(n, -1.0, f32)
    sad = np.full(n, np.inf, f32)
    ok = np.zeros(n, bool)
    for l in range(len(L)):
        m = np.nonzero(lvl == l)[0]
        if not len(m):
            continue
        t = lambda a: torch.as_tensor(a[m], device=dev)   # noqa: E731
        k, s0, interior, delta, dok = (x.cpu().numpy() for x in scan(L[l], R[l], t(xs), t(ys),
                                                                     t(xr)))
        u = sc[l] * (xr[m].astype(f32) + (k - SLIDE).astype(f32) + delta.astype(f32))
        disp = ul[m] - u
        disp = np.where(disp <= 0, f32(0.01), disp)
        u_right[m] = u
        sad[m] = s0
        ok[m] = matched[m] & inb[m] & interior & dok & (disp < f32(fx))
    med = median_of_matched(sad[ok])
    ok &= sad <= f32(1.5 * 1.4) * f32(med)
    disp = ul - u_right
    depth = np.where(ok, f32(bf) / np.where(disp <= 0, f32(0.01), disp), -1.0).astype(f32)
    u_right = np.where(ok, u_right, -1.0).astype(f32)
    fine = np.nonzero(ok & (lvl >= fine_min_level))[0]
    if len(fine):
        H0, W0 = L[0].shape
        u0 = np.round(u_right[fine]).astype(np.int64)
        v0 = np.round(vl[fine]).astype(np.int64)
        x0 = np.round(ul[fine]).astype(np.int64)
        margin = W + SLIDE + 1
        inb0 = ((v0 - margin >= 0) & (v0 + margin < H0) & (x0 - margin >= 0)
                & (x0 + margin < W0) & (u0 - margin >= 0) & (u0 + margin < W0))
        t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        k, _, interior, delta, dok = (x.cpu().numpy() for x in scan(L[0], R[0], t(x0), t(v0),
                                                                    t(u0)))
        uf = u0.astype(f32) + (k - SLIDE).astype(f32) + delta.astype(f32)
        dispf = ul[fine] - uf
        take = inb0 & interior & dok & (dispf > 0) & (np.abs(uf - u_right[fine]) <= SLIDE)
        u_right[fine] = np.where(take, uf, u_right[fine])
        depth[fine] = np.where(take, f32(bf) / np.maximum(dispf, f32(1e-3)), depth[fine])
    return dict(u_right=u_right, depth=depth)
