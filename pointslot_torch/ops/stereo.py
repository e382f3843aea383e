"""Stereo keypoint matching: masked Hamming argmin + SAD sub-pixel refine.

Port of ``pointslot_tpu/ops/stereo.py`` (the patch-fed functions the
frontend runs). Two semantics are kept on purpose:

- ``nanmedian`` averages the two middle values of an even count, as
  ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower one), and
  gives NaN for an all-NaN input, so that no match passes the SAD gate.
- ``argmin`` returns the first index among ties, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from pointslot_torch.ops.hamming import hamming_table_popcount

_W = 5          # SAD half-window (11x11 patch)
_L = 5          # max slide in pixels
_BIG = 1 << 20


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor with jnp.nanmedian's
    linear interpolation; NaN when every entry is NaN. No host sync."""
    a = torch.sort(x).values                    # NaN sorts to the end
    counts = (~torch.isnan(a)).sum().to(x.dtype)
    q = 0.5 * (counts - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1.0 - high_weight
    low = torch.clamp(torch.minimum(low, counts - 1.0), min=0.0).long()
    high = torch.clamp(torch.minimum(high, counts - 1.0), min=0.0).long()
    return (a.gather(0, low.reshape(1)) * low_weight
            + a.gather(0, high.reshape(1)) * high_weight)[0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, S), idx (N,) -> x[n, idx[n]]."""
    return x.gather(1, idx[:, None])[:, 0]


def stereo_candidates(xy_l, level_l, desc_l, valid_l,
                      xy_r, level_r, desc_r, valid_r,
                      scale_factors, fx: float, th_orb: int):
    """Masked Hamming argmin over the right features -> (best_idx, matched)."""
    max_d = fx
    dist = hamming_table_popcount(desc_l, desc_r)                  # (NL, NR)
    yl, yr = xy_l[:, 1], xy_r[:, 1]
    ul, ur = xy_l[:, 0], xy_r[:, 0]
    r_window = 2.0 * scale_factors[level_r]
    ok = (
        valid_l[:, None]
        & valid_r[None, :]
        & (torch.abs(yl[:, None] - yr[None, :]) <= r_window[None, :])
        & (torch.abs(level_l[:, None] - level_r[None, :]) <= 1)
        & (ur[None, :] <= ul[:, None])
        & (ur[None, :] >= ul[:, None] - max_d)
    )
    dist = torch.where(ok, dist, torch.full_like(dist, _BIG))
    best_idx = torch.argmin(dist, dim=1).to(torch.int32)
    best_dist = _take(dist, best_idx.long())
    return best_idx, best_dist < th_orb


def _sad_scan(norm_l: torch.Tensor, wide_r: torch.Tensor):
    """SADs of the centre-normalised left window against the 11 shifted
    right windows, argmin and parabolic sub-pixel fit. wide_r (N, 11, 21)."""
    sads = []
    for k in range(2 * _L + 1):
        win = wide_r[:, :, k: k + 2 * _W + 1]
        win = win - win[:, _W, _W][:, None, None]
        sads.append(torch.sum(torch.abs(norm_l - win), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)                                 # (N, 11)
    best_k = torch.argmin(sads, dim=1)
    best_sad = _take(sads, best_k)
    interior = (best_k > 0) & (best_k < 2 * _L)
    s_m = _take(sads, torch.clamp(best_k - 1, 0, 2 * _L))
    s_p = _take(sads, torch.clamp(best_k + 1, 0, 2 * _L))
    denom = s_m + s_p - 2.0 * best_sad
    delta = torch.where(torch.abs(denom) > 1e-6, (s_m - s_p) / (2.0 * denom),
                        torch.zeros_like(denom))
    delta_ok = (delta > -1.0) & (delta < 1.0)
    return best_k, best_sad, interior, delta, delta_ok


def sad_refine_from_patches(patch_l, patch_r, scaled_ul, scaled_vl, scaled_ur,
                            ul, matched, in_bounds, scale, fx: float, bf: float):
    """SAD scan over +-5 px with parabolic sub-pixel fit and the median-based
    outlier filter, from (N, 48, 48) patches centred at the scaled left
    keypoint / right candidate."""
    c = patch_l.shape[1] // 2
    lw = patch_l[:, c - _W: c + _W + 1, c - _W: c + _W + 1]
    norm_l = lw - lw[:, _W, _W][:, None, None]
    wide_r = patch_r[:, c - _W: c + _W + 1, c - _W - _L: c + _W + _L + 1]
    best_k, best_sad, interior, delta, delta_ok = _sad_scan(norm_l, wide_r)

    u_right = scale * (scaled_ur.to(torch.float32)
                       + (best_k - _L).to(torch.float32) + delta)
    disparity = ul - u_right
    disparity = torch.where(disparity <= 0.0, torch.full_like(disparity, 0.01),
                            disparity)
    disp_ok = disparity < fx

    valid = matched & in_bounds & interior & delta_ok & disp_ok
    med = nanmedian(torch.where(valid, best_sad, torch.full_like(best_sad, float("nan"))))
    valid = valid & (best_sad <= 1.5 * 1.4 * med)
    minus1 = torch.full_like(disparity, -1.0)
    depth = torch.where(valid, bf / disparity, minus1)
    u_right = torch.where(valid, u_right, minus1)
    return u_right, depth, valid


def fine_refine_from_patches(patch_l, patch_r, ul, u_right, depth, valid, bf: float):
    """Level-0 re-fit of the coarse-octave disparities from (N, 48, 48)
    level-0 windows centred at the rounded left keypoint / right estimate."""
    c = patch_l.shape[1] // 2
    u0 = torch.round(u_right).to(torch.int32)
    lw = patch_l[:, c - _W: c + _W + 1, c - _W: c + _W + 1]
    norm_l = lw - lw[:, _W, _W][:, None, None]
    wide_r = patch_r[:, c - _W: c + _W + 1, c - _W - _L: c + _W + _L + 1]
    best_k, _, interior, delta, delta_ok = _sad_scan(norm_l, wide_r)

    u_fine = u0.to(torch.float32) + (best_k - _L).to(torch.float32) + delta
    disparity = ul - u_fine
    accept = (valid & interior & delta_ok & (disparity > 0.0)
              & (torch.abs(u_fine - u_right) <= float(_L)))
    u_out = torch.where(accept, u_fine, u_right)
    d_out = torch.where(accept, bf / torch.clamp(disparity, min=1e-3), depth)
    return u_out, d_out, valid
