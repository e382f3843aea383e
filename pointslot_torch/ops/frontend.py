"""Stereo frame frontend: ORB on the left and right images + stereo matching.

Port of ``pointslot_tpu/ops/frontend.py::StereoFrontend`` (the
single-pair path, gated and ungated: ``_image_stage``, ``_frontend``,
``_stereo_from_patches`` and its ``_stereo_pre`` / ``_stereo_sad`` /
``_stereo_fine`` phases; ``batch``, the runner's ``--dp`` path) and
``dilate_mask_left``. The patch gather runs four times per pair: left
keypoints, right keypoints, right SAD windows and the level-0 fine windows.
On the card it reads the pyramid levels in place and no padded canvas is
built.

A gate (an allowed-region mask per image) multiplies each level's FAST
score map by the mask resized as ``jax.image.resize(..., "nearest")`` does.
That resize matches neither torch's ``nearest`` nor ``nearest-exact``; its
index map is rebuilt here in numpy from jax's formula (``nearest_index``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pointslot_torch.config import ORBConfig
from pointslot_torch.convert import to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops import stereo as st
from pointslot_torch.ops.orb import FeatureSet, ORBExtractor
from pointslot_torch.ops.patch import gather_patches


class StereoFrame(NamedTuple):
    """Everything the tracker needs about one stereo frame."""

    xy: torch.Tensor        # (N, 2) left keypoints, level-0 coords
    response: torch.Tensor  # (N,)
    angle: torch.Tensor     # (N,)
    level: torch.Tensor     # (N,) int32
    desc: torch.Tensor      # (N, 8) int32 words
    valid: torch.Tensor     # (N,) bool
    u_right: torch.Tensor   # (N,) float32 (-1 = no stereo)
    depth: torch.Tensor     # (N,) float32 (-1 = no stereo)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each of `n_out` samples along an axis of `n_in`, as
    jax.image.resize's "nearest" takes them: floor((i + 0.5) * n_in / n_out)
    in float32, where XLA folds the two constants into one factor,
    n_in * (1 / n_out) (a float32 factor of 1.19999993 for 1242 -> 1035,
    not 1.2); an axis whose size is kept is not resampled."""
    if n_in == n_out:
        return np.arange(n_out, dtype=np.int64)
    factor = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * factor
    return np.floor(offsets).astype(np.int64)


def dilate_mask_left(mask: np.ndarray, max_disparity: int = 128) -> np.ndarray:
    """Union of the mask shifted left by 0..max_disparity px: where an
    object can appear in the RIGHT stereo image (log-step doubling, as the
    reference)."""
    m = np.asarray(mask) != 0
    s = 1
    while s < max_disparity:
        shifted = np.zeros_like(m)
        shifted[:, :-s] = m[:, s:]
        m = m | shifted
        s *= 2
    return m


class StereoFrontend:
    """(left, right[, gate, gate_right]) -> StereoFrame at fixed geometry on
    one device."""

    def __init__(self, height: int, width: int, fx: float, bf: float,
                 config: Optional[ORBConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config or ORBConfig()
        self.extractor = ORBExtractor(height, width, self.config, device=self.device)
        self.fx = float(fx)
        self.bf = float(bf)
        cfg = self.config
        self._scales = torch.tensor(
            [cfg.scale_factor ** i for i in range(cfg.n_levels)],
            dtype=torch.float32).to(self.device)
        self._lshapes = torch.tensor(self.extractor.shapes, dtype=torch.int32).to(self.device)
        # the gate's nearest-resize index maps, (rows, cols) per level
        self._gate_index = [
            tuple(torch.from_numpy(nearest_index(n, m)).to(self.device)
                  for n, m in zip((height, width), shape))
            for shape in self.extractor.shapes]

    def __call__(self, left, right, gate=None, gate_right=None) -> StereoFrame:
        """gate / gate_right: (H, W) boolean allowed-region masks for the
        left and right images. With `gate` alone the right image is
        ungated (the background frontend); the object frontend passes a
        disparity-dilated `gate_right` as well."""
        d = self.device
        return self.run(to_tensor(left, None, d), to_tensor(right, None, d),
                        None if gate is None else to_tensor(gate, torch.bool, d),
                        None if gate_right is None else to_tensor(gate_right, torch.bool, d))

    def run(self, left: torch.Tensor, right: torch.Tensor,
            gate: Optional[torch.Tensor] = None,
            gate_right: Optional[torch.Tensor] = None) -> StereoFrame:
        """The frontend on device tensors (H, W), any real dtype; gates are
        (H, W) bool tensors on the same device."""
        return StereoFrame(*self._frontend(left, right, gate, gate_right))

    def batch(self, lefts, rights) -> StereoFrame:
        """A batch of ungated stereo pairs, (B, H, W) each -> a StereoFrame
        whose every field gains a leading batch axis. As the JAX package's
        ``batch`` (a ``lax.scan`` of the single-pair program), the
        single-pair frontend runs pair after pair on this frontend's
        device, 4 patch-gather launches per pair, so each frame equals the
        single-pair frontend's bit for bit."""
        d = self.device
        lefts, rights = to_tensor(lefts, None, d), to_tensor(rights, None, d)
        if lefts.shape != rights.shape or lefts.dim() != 3:
            raise ValueError(f"need two (B, H, W) batches of one shape, got "
                             f"{tuple(lefts.shape)} and {tuple(rights.shape)}")
        frames = [self.run(left, right) for left, right in zip(lefts, rights)]
        return StereoFrame(*[torch.stack(field) for field in zip(*frames)])

    def _gate_scores(self, scores: List[torch.Tensor], gate, gate_right):
        """Each level's (2, h, w) scores times the nearest-resized masks."""
        ones = torch.ones(self.extractor.shapes[0], dtype=torch.float32, device=self.device)
        g_both = torch.stack([ones if gate is None else gate.to(torch.float32),
                              ones if gate_right is None else gate_right.to(torch.float32)])
        return [s * g_both.index_select(1, rows).index_select(2, cols)
                for s, (rows, cols) in zip(scores, self._gate_index)]

    # ------------------------------------------------------------------
    def _image_stage(self, imgs: torch.Tensor):
        """Pyramid + dense FAST scores over a leading axis of images."""
        ext = self.extractor
        levels = ext.pyramid(imgs.to(torch.float32))
        return levels, ext.scores(levels)

    def _frontend(self, left: torch.Tensor, right: torch.Tensor, gate=None, gate_right=None):
        ext = self.extractor
        both = torch.stack([left.to(torch.float32), right.to(torch.float32)])
        levels, scores = self._image_stage(both)
        if gate is not None or gate_right is not None:
            scores = self._gate_scores(scores, gate, gate_right)
        # selection runs on both images at once; the patch gather runs per
        # image (one launch each), as the reference's single-pair path does
        xyl, xy, resp, lvl, valid = ext.detect(scores)
        # the gathers read each image's levels in place (views of `levels`)
        levels_l = [x[0] for x in levels]
        levels_r = [x[1] for x in levels]
        patches_l, angle_l, desc_l = ext.describe(levels_l, xyl[0])
        _, angle_r, desc_r = ext.describe(levels_r, xyl[1])
        fl = FeatureSet(xy[0], resp[0], angle_l, lvl[0], desc_l, valid[0])
        fr = FeatureSet(xy[1], resp[1], angle_r, lvl[1], desc_r, valid[1])
        u_right, depth, _ = self._stereo_from_patches(fl, fr, levels_l, levels_r, patches_l)
        return (fl.xy, fl.response, fl.angle, fl.level, fl.desc, fl.valid,
                u_right, depth)

    def _stereo_from_patches(self, fl: FeatureSet, fr: FeatureSet,
                             levels_l: List[torch.Tensor], levels_r: List[torch.Tensor],
                             patch_l: torch.Tensor):
        """Stereo matching with the SAD windows fetched by the patch gather.
        The left windows are the extractor's own patches; the right
        candidate windows and the level-0 fine windows are gathered here."""
        pre = self._stereo_pre(fl, fr)
        patch_r = gather_patches(levels_r, pre["xyl_r"])
        mid = self._stereo_sad(fl, pre, patch_l, patch_r)
        if self.config.stereo_fine_min_level >= len(self.extractor.budgets):
            return mid["u_right"], mid["depth"], mid["valid_st"]
        # one launch for both level-0 images: plane 0 is the left image,
        # plane 1 the right
        both = gather_patches((levels_l[0], levels_r[0]), mid["xyl_fine"])
        return self._stereo_fine(fl, mid, both)

    def _stereo_pre(self, fl: FeatureSet, fr: FeatureSet):
        """Candidate match + rounded per-level window coords."""
        ext = self.extractor
        best_idx, matched = st.stereo_candidates(
            fl.xy, fl.level, fl.desc, fl.valid,
            fr.xy, fr.level, fr.desc, fr.valid,
            self._scales, self.fx, th_orb=self.config.stereo_match_th,
        )
        ul, yl = fl.xy[:, 0], fl.xy[:, 1]
        inv_scale = 1.0 / self._scales[fl.level.long()]
        u0r = fr.xy[:, 0].gather(0, best_idx.long())
        scaled_ul = torch.round(ul * inv_scale).to(torch.int32)
        scaled_vl = torch.round(yl * inv_scale).to(torch.int32)
        scaled_ur = torch.round(u0r * inv_scale).to(torch.int32)
        xyl_r = []
        offset = 0
        for lvl, budget in enumerate(ext.budgets):
            seg = slice(offset, offset + budget)
            offset += budget
            h, w = ext.shapes[lvl]
            xyl_r.append(torch.stack([
                torch.clamp(scaled_ur[seg], 0, w - 1),
                torch.clamp(scaled_vl[seg], 0, h - 1),
                torch.full((budget,), lvl, dtype=torch.int32, device=ul.device),
            ], dim=1))
        return dict(matched=matched, scaled_ul=scaled_ul, scaled_vl=scaled_vl,
                    scaled_ur=scaled_ur, xyl_r=torch.cat(xyl_r))

    def _stereo_sad(self, fl: FeatureSet, pre, patch_l, patch_r):
        """SAD refine over the fetched windows + the level-0 fine-refine
        window coords (level column 0 = left image, 1 = right image)."""
        ext = self.extractor
        W, L = st._W, st._L
        ul, yl = fl.xy[:, 0], fl.xy[:, 1]
        scaled_ul, scaled_vl = pre["scaled_ul"], pre["scaled_vl"]
        scaled_ur = pre["scaled_ur"]
        lvl = fl.level.long()
        lh = self._lshapes[lvl, 0]
        lw = self._lshapes[lvl, 1]
        in_bounds = (
            (scaled_vl - W >= 0) & (scaled_vl + W < lh)
            & (scaled_ul - W >= 0) & (scaled_ul + W < lw)
            & (scaled_ur - W - L >= 0) & (scaled_ur + W + L < lw)
        )
        u_right, depth, valid_st = st.sad_refine_from_patches(
            patch_l, patch_r, scaled_ul, scaled_vl, scaled_ur,
            ul, pre["matched"], in_bounds, self._scales[lvl], self.fx, self.bf,
        )
        out = dict(u_right=u_right, depth=depth, valid_st=valid_st)
        fine_min = self.config.stereo_fine_min_level
        if fine_min < len(ext.budgets):
            # the per-level slot layout makes the coarse tail a static slice
            s0 = sum(ext.budgets[:fine_min])
            H0, W0 = ext.shapes[0]
            u0 = torch.round(u_right[s0:]).to(torch.int32)
            v0 = torch.round(yl[s0:]).to(torch.int32)
            ulr = torch.round(ul[s0:]).to(torch.int32)
            margin = W + L + 1
            out["fine_inb"] = (
                (v0 - margin >= 0) & (v0 + margin < H0)
                & (ulr - margin >= 0) & (ulr + margin < W0)
                & (u0 - margin >= 0) & (u0 + margin < W0)
            )
            out["xyl_fine"] = torch.cat([
                torch.stack([torch.clamp(ulr, 0, W0 - 1), torch.clamp(v0, 0, H0 - 1),
                             torch.zeros_like(ulr)], dim=1),
                torch.stack([torch.clamp(u0, 0, W0 - 1), torch.clamp(v0, 0, H0 - 1),
                             torch.ones_like(u0)], dim=1),
            ]).to(torch.int32)
        return out

    def _stereo_fine(self, fl: FeatureSet, mid, both_patches):
        """Apply the level-0 fine refine given its fetched windows."""
        s0 = sum(self.extractor.budgets[:self.config.stereo_fine_min_level])
        u_right, depth, valid_st = mid["u_right"], mid["depth"], mid["valid_st"]
        ul = fl.xy[:, 0]
        n_t = mid["xyl_fine"].shape[0] // 2
        uf, df, _ = st.fine_refine_from_patches(
            both_patches[:n_t], both_patches[n_t:], ul[s0:], u_right[s0:],
            depth[s0:], valid_st[s0:] & mid["fine_inb"], self.bf,
        )
        return (torch.cat([u_right[:s0], uf]), torch.cat([depth[:s0], df]), valid_st)
