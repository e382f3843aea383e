"""ReID appearance-embedding network for DeepSORT.

Port of ``pointslot_tpu/detect/reid.py`` (the reference's TensorRT engine,
deepsort/src/featuretensor.cpp): a small conv net that embeds 128x64 grey
crops to an L2-normalised feature vector, all of a frame's crops in one
batched forward.

``ReIDNet`` is flax's network as a ``torch.nn.Module``: three stages of
(stride-2 3x3 conv, BN, ReLU, 3x3 conv, BN, ReLU), a mean pool, a dense
layer and the L2 norm. Convolutions pad as XLA's "SAME" does, which for a
stride-2 3x3 on an even side is (0, 1); BN runs in inference form with
flax's eps 1e-5. Weights come from the JAX package's flat npz (keys are
"/"-joined flax paths) through ``convert.reid_from_flax``.

The crops are cut and resized on the host, as the JAX package does with
PIL; ``pil_resize_bilinear`` is PIL's ``Image.BILINEAR`` resize of a
float32 ("F") image written in numpy, so that mode 3 needs no PIL.
"""

from __future__ import annotations

import os
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pointslot_torch.detect.layers import BatchNorm, Conv, Named, init_weights
from pointslot_torch.device import resolve_device

CROP_H, CROP_W = 128, 64
BN_EPS = 1e-5
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "pointslot_tpu", "detect", "weights")


class ReIDNet(Named):
    def __init__(self, features: int = 128):
        super().__init__()
        self.body, ci = [], 1
        for ch in (32, 64, 128):
            self.body += [self._child(Conv(ci, ch, 3, 2)), self._child(BatchNorm(ch, BN_EPS)),
                          self._child(Conv(ch, ch, 3)), self._child(BatchNorm(ch, BN_EPS))]
            ci = ch
        self._child(nn.Linear(128, features), "dense", "Dense")

    def forward(self, x):
        """x (N, 1, 128, 64) -> (N, features), unit rows."""
        for conv, bn in zip(self.body[::2], self.body[1::2]):
            x = F.relu(bn(conv(x)))
        x = self.dense(x.mean(dim=(2, 3)))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def _pil_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 taps of PIL's bilinear resample
    (Resample.c precompute_coeffs): support 1 scaled by the downscale
    factor, centre (i + 0.5) * scale, bounds rounded, rows normalised."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    out = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        x = np.arange(xmin, xmax)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) * (1.0 / filterscale)), 0.0)
        total = w.sum()
        out[i, xmin:xmax] = w / total if total != 0.0 else w
    return out


def pil_resize_bilinear(img: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """PIL ``Image.fromarray(img.astype(float32)).resize((w_out, h_out),
    Image.BILINEAR)``: the horizontal pass into a float32 image, then the
    vertical pass, each tap sum in float64."""
    x = np.asarray(img, np.float32).astype(np.float64)
    if x.shape[1] != w_out:
        x = (x @ _pil_weights(x.shape[1], w_out).T).astype(np.float32).astype(np.float64)
    if x.shape[0] != h_out:
        x = _pil_weights(x.shape[0], h_out) @ x
    return x.astype(np.float32)


def crop_batch(image: np.ndarray, bboxes: np.ndarray) -> np.ndarray:
    """(N, 128, 64) float32 crops in [0, 1] of the boxes (x, y, w, h),
    cut as the JAX package cuts them."""
    if image.ndim == 3:
        image = image.mean(axis=-1)
    H, W = image.shape
    crops = np.zeros((len(bboxes), CROP_H, CROP_W), np.float32)
    for i, (x, y, w, h) in enumerate(bboxes):
        x0 = int(np.clip(x, 0, W - 2))
        y0 = int(np.clip(y, 0, H - 2))
        x1 = int(np.clip(x + w, x0 + 1, W))
        y1 = int(np.clip(y + h, y0 + 1, H))
        crops[i] = pil_resize_bilinear(image[y0:y1, x0:x1].astype(np.float32),
                                       CROP_W, CROP_H) / 255.0
    return crops


class ReIDEmbedder:
    def __init__(self, feature_dim: int = 128, max_batch: int = 64, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.net = init_weights(ReIDNet(features=feature_dim), seed).to(self.device).eval()

    def load_npz(self, path: str):
        """Load trained weights: the flat npz of either package's
        ``train_reid.save_npz``."""
        from pointslot_torch.detect.train_reid import load_npz

        self.net = load_npz(path, self.device)

    @staticmethod
    def bundled_weights_path():
        """Path of the shipped synthetic-identity weights (or None)."""
        p = os.path.join(WEIGHTS_DIR, "synthetic_reid.npz")
        return p if os.path.isfile(p) else None

    @torch.no_grad()
    def __call__(self, image: np.ndarray, bboxes: np.ndarray) -> np.ndarray:
        """image (H, W) or (H, W, 3); bboxes (N, 4) xywh -> (min(N,
        max_batch), D) features of the first boxes, in one forward."""
        bboxes = np.asarray(bboxes, np.float64).reshape(-1, 4)[:self.max_batch]
        if not len(bboxes):
            return np.zeros((0, self.net.dense.out_features), np.float32)
        crops = torch.from_numpy(crop_batch(np.asarray(image), bboxes)).to(self.device)
        return self.net(crops[:, None]).cpu().numpy()
