"""2D template tracking for SLOT mode 2 (manual ROIs) and mode 1's
``dynaslam_mode=1`` mask carry.

Port of ``pointslot_tpu/detect/tracker2d.py`` (the reference's OpenCV CSRT
MultiTracker, src/Frame.cc:1529-1574, and DynaSLAM's CSRT trackers,
src/Tracking.cc:127-139): a normalized-cross-correlation tracker. Each
track's 48x48 template is matched over a 96x96 window, resampled from
twice its box around the last position; the template adapts by an
exponential average.

The template and window are resized with the antialiased bilinear weights
of ``ops/pyramid.py`` (jax.image.resize's formula, as the reference uses):
``R @ crop @ C`` on the device. ``_ncc_match`` unfolds the window into its
49x49 template-sized views. Each track's score map comes to the host once,
for the argmax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pointslot_torch.device import resolve_device
from pointslot_torch.ops.pyramid import resize_mats

TEMPLATE = 48         # template side (resampled)
SEARCH = 96           # search window side


def _ncc_match(template: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """template (T, T), window (S, S) -> (S-T+1, S-T+1) NCC scores."""
    T = template.shape[0]
    t = template - template.mean()
    tn = torch.sqrt(torch.clamp((t * t).sum(), min=1e-9))
    cols = window.unfold(0, T, 1).unfold(1, T, 1)          # (S-T+1, S-T+1, T, T)
    c = cols - cols.mean(dim=(2, 3), keepdim=True)
    cn = torch.sqrt(torch.clamp((c * c).sum(dim=(2, 3)), min=1e-9))
    return (c * t).sum(dim=(2, 3)) / (cn * tn)


def resize_bilinear(img: np.ndarray, h_out: int, w_out: int, device) -> torch.Tensor:
    """A (h, w) host image -> (h_out, w_out) float32 on `device`, by
    jax.image.resize's antialiased bilinear weights."""
    R, C = resize_mats(img.shape[0], img.shape[1], h_out, w_out)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
    return torch.from_numpy(R).to(device) @ x @ torch.from_numpy(C).to(device)


@dataclass
class Track2D:
    track_id: int
    bbox: np.ndarray          # (4,) x, y, w, h
    template: torch.Tensor    # (T, T) float32, on the tracker's device
    confidence: float = 1.0
    alive: bool = True


class MultiTracker2D:
    def __init__(self, adapt: float = 0.05, min_confidence: float = 0.25, device="cuda"):
        self.tracks: List[Track2D] = []
        self.adapt = adapt
        self.min_confidence = min_confidence
        self.device = resolve_device(device)
        self._next_id = 0

    def _extract_template(self, img: np.ndarray, bbox: np.ndarray) -> torch.Tensor:
        x, y, w, h = bbox
        H, W = img.shape
        x0, y0 = int(max(x, 0)), int(max(y, 0))
        x1, y1 = int(min(x + w, W)), int(min(y + h, H))
        patch = img[y0:y1, x0:x1].astype(np.float32)
        if patch.size == 0:
            patch = np.zeros((8, 8), np.float32)
        return resize_bilinear(patch, TEMPLATE, TEMPLATE, self.device)

    def add(self, img: np.ndarray, bbox) -> int:
        bbox = np.asarray(bbox, np.float64)
        t = Track2D(track_id=self._next_id, bbox=bbox,
                    template=self._extract_template(np.asarray(img), bbox))
        self.tracks.append(t)
        self._next_id += 1
        return t.track_id

    def update(self, img: np.ndarray) -> List[Track2D]:
        img = np.asarray(img)
        H, W = img.shape
        for t in self.tracks:
            if not t.alive:
                continue
            x, y, w, h = t.bbox
            cx, cy = x + w / 2, y + h / 2
            # search region = 2x the bbox, resampled so the object appears at
            # TEMPLATE scale; the peak offset maps back through the scale
            sw, sh = 2.0 * w, 2.0 * h
            sx0 = float(np.clip(cx - sw / 2, 0, max(W - sw, 0)))
            sy0 = float(np.clip(cy - sh / 2, 0, max(H - sh, 0)))
            sx1 = min(sx0 + sw, W)
            sy1 = min(sy0 + sh, H)
            crop = img[int(sy0):int(sy1), int(sx0):int(sx1)].astype(np.float32)
            if crop.shape[0] < 8 or crop.shape[1] < 8:
                t.alive = False
                continue
            window = resize_bilinear(crop, SEARCH, SEARCH, self.device)
            scores = _ncc_match(t.template, window).cpu().numpy()
            iy, ix = np.unravel_index(np.argmax(scores), scores.shape)
            best = float(scores[iy, ix])
            t.confidence = best
            if best < self.min_confidence:
                t.alive = False
                continue
            # template center in window coords -> image coords
            ucx = ix + TEMPLATE / 2
            ucy = iy + TEMPLATE / 2
            new_cx = sx0 + ucx * crop.shape[1] / SEARCH
            new_cy = sy0 + ucy * crop.shape[0] / SEARCH
            t.bbox = np.array([new_cx - w / 2, new_cy - h / 2, w, h])
            fresh = self._extract_template(img, t.bbox)
            t.template = (1 - self.adapt) * t.template + self.adapt * fresh
        return [t for t in self.tracks if t.alive]
