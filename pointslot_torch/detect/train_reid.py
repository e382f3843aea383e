"""ReID embedder training on synthetic identity crops.

Port of ``pointslot_tpu/detect/train_reid.py``. The reference ships a
trained ReID engine (TensorRT, deepsort/src/featuretensor.cpp) and never
trains one. Here procedural textured identities are rendered under random
viewpoint, scale and photometric jitter, and the embedder learns a scaled
cosine softmax over the identities (16 * emb @ head, integer-label cross
entropy) with Adam at optax's defaults; the head is dropped at export.

- ``make_identity_bank`` upsamples 8x8 noise to 48x48 as
  ``jax.image.resize(..., "bicubic")`` does: Keys' cubic with a = -0.5,
  the weights of the taps that fall inside the image renormalised to sum
  to one (``F.interpolate(mode="bicubic")`` uses a = -0.75 and clamps at
  the borders). The weight matrices are built in numpy from jax's formula.
- ``_np_resize_bilinear`` and ``sample_crops`` are the JAX package's numpy
  code, drawing from the same ``np.random.Generator`` in the same order.
- ``train`` initialises the network from a seeded ``torch.Generator``, or
  takes the JAX training's initial network and head through ``init``
  (``convert.reid_training_from_flax``).

Run: ``python -m pointslot_torch.detect.train_reid [out.npz] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pointslot_torch.detect.layers import init_weights
from pointslot_torch.detect.reid import CROP_H, CROP_W, ReIDNet
from pointslot_torch.device import resolve_device

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "weights", "synthetic_reid.npz")
LOGIT_SCALE = 16.0


def _keys_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize's "bicubic" along
    one axis (jax compute_weight_mat with the Keys kernel, a = -0.5)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = f32(max(float(inv_scale), 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def make_identity_bank(n_ids: int, seed: int = 0, tex: int = 48) -> np.ndarray:
    """Per-identity base texture: smooth random pattern, (n, tex, tex)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, size=(n_ids, 8, 8)).astype(np.float32).astype(np.float64)
    wy = _keys_cubic_weights(8, tex).astype(np.float64)
    wx = _keys_cubic_weights(8, tex).astype(np.float64)
    big = np.einsum("nab,ai,bj->nij", base, wy, wx).astype(np.float32)
    return np.clip(big, 0, 1)


def _np_resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize (keeps crop sampling off the device)."""
    h, w = img.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def sample_crops(bank: np.ndarray, rng: np.random.Generator, batch: int):
    """Random (identity, view) pairs: scaled/shifted/jittered sub-windows
    resized to the ReID crop geometry. Returns (crops (batch, 128, 64, 1)
    float32, ids (batch,))."""
    n_ids, tex, _ = bank.shape
    ids = rng.integers(0, n_ids, size=batch)
    crops = np.zeros((batch, CROP_H, CROP_W, 1), np.float32)
    for i, k in enumerate(ids):
        s = rng.uniform(0.5, 1.0)
        w = max(int(tex * s), 8)
        h = max(int(tex * s), 8)
        x0 = rng.integers(0, tex - w + 1)
        y0 = rng.integers(0, tex - h + 1)
        win = bank[k, y0 : y0 + h, x0 : x0 + w]
        img = _np_resize_bilinear(win, CROP_H, CROP_W)
        gain = rng.uniform(0.5, 1.4)
        bias = rng.uniform(-0.15, 0.15)
        noise = rng.normal(scale=0.03, size=img.shape)
        crops[i, :, :, 0] = np.clip(img * gain + bias + noise, 0, 1)
    return crops, ids


class ReIDTrainer:
    """The network in its training form, the softmax head and one Adam
    over both (optax ``adam``: lr, betas (0.9, 0.999), eps 1e-8)."""

    def __init__(self, net: ReIDNet, head: torch.Tensor, lr: float = 1e-3, device="cuda"):
        self.device = resolve_device(device)
        self.net = net.to(self.device).train()
        self.head = torch.nn.Parameter(head.detach().to(self.device, torch.float32, copy=True))
        self.opt = torch.optim.Adam([*self.net.parameters(), self.head], lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)

    def step_tensors(self, x: torch.Tensor, y: torch.Tensor):
        """One step on device tensors: crops (B, 1, 128, 64), ids (B,).
        Returns (loss, accuracy) as device scalars."""
        self.opt.zero_grad(set_to_none=True)
        logits = LOGIT_SCALE * self.net(x) @ self.head
        loss = F.cross_entropy(logits, y)
        loss.backward()
        self.opt.step()
        acc = (logits.detach().argmax(-1) == y).to(torch.float32).mean()
        return loss.detach(), acc

    def step(self, crops: np.ndarray, ids: np.ndarray):
        """One step on host arrays (crops (B, 128, 64, 1) of sample_crops)."""
        x = torch.from_numpy(crops).to(self.device).permute(0, 3, 1, 2)
        return self.step_tensors(x, torch.from_numpy(np.asarray(ids, np.int64)).to(self.device))


def train(n_ids: int = 64, steps: int = 800, batch: int = 64, feature_dim: int = 128,
          seed: int = 0, lr: float = 1e-3, device="cuda",
          init: Optional[Tuple[ReIDNet, torch.Tensor]] = None):
    """Returns (net, accuracy): the trained ``ReIDNet`` in eval mode on
    `device` (the softmax head dropped) and the last step's identity
    accuracy. `init` (net, head) replaces the seeded initialisation."""
    rng = np.random.default_rng(seed)
    bank = make_identity_bank(n_ids, seed)
    if init is None:
        g = torch.Generator().manual_seed(seed)
        net = init_weights(ReIDNet(features=feature_dim), generator=g)
        head = torch.randn((feature_dim, n_ids), generator=g) * 0.05
    else:
        net, head = init
    trainer = ReIDTrainer(net, head, lr, device)
    acc = torch.zeros(())
    for _ in range(steps):
        x, y = sample_crops(bank, rng, batch)
        _, acc = trainer.step(x, y)
    return trainer.net.eval(), float(acc)


def save_npz(path: str, net: ReIDNet):
    """The network in the JAX package's flat npz layout ("params/..." and
    "batch_stats/..." keys), which both packages' ``ReIDEmbedder.load_npz``
    read."""
    from pointslot_torch import convert

    np.savez(path, **convert.flax_from_module(net))


def load_npz(path: str, device="cuda") -> ReIDNet:
    """A flat npz of either package as a ``ReIDNet`` in eval mode."""
    from pointslot_torch import convert

    return convert.reid_from_flax(dict(np.load(path))).to(resolve_device(device)).eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=800)
    args = ap.parse_args(argv)
    net, acc = train(steps=args.steps, device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_npz(args.out, net)
    print(f"saved {args.out} (train id-accuracy {acc:.3f})")


if __name__ == "__main__":
    main()
