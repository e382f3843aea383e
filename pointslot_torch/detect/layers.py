"""Layers shared by the detector and the ReID network, in flax's terms.

Convolutions pad as XLA's "SAME" does (for a stride-2 3x3 on an even side,
(0, 1)); BatchNorm is flax's, in inference form under ``eval()`` and in
its training form under ``train()``; ``Named`` gives children
flax's automatic names (``Conv_0``, ``BatchNorm_1``, ``C3_2``, ...) in call
order, so that ``convert.detector_from_flax`` and ``convert.reid_from_flax``
map the JAX package's variables onto a module name for name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int):
    """XLA "SAME" padding (lo, hi) of one spatial side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NCHW conv with XLA "SAME" padding: symmetric pads go to the conv,
    asymmetric ones to an explicit zero pad first."""
    k = weight.shape[-1]
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if hl == hh and wl == wh:
        return F.conv2d(x, weight, bias, stride, (hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), weight, bias, stride)


class BatchNorm(nn.Module):
    """Flax BatchNorm over the channel axis of NCHW (momentum 0.97).

    In eval mode, the inference form: (x - mean) / sqrt(var + eps) * scale +
    bias. In train mode, flax's ``train=True`` form: the batch mean and the
    biased "fast" variance max(0, E[x^2] - E[x]^2) normalise as
    (x - mu) * (rsqrt(var + eps) * scale) + bias, and the running
    statistics move as ra = 0.97 ra + 0.03 batch, with the biased variance
    (``F.batch_norm(training=True)`` would store the unbiased one)."""

    MOMENTUM = 0.97

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                                self.eps)
        mu = x.mean(dim=(0, 2, 3))
        var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mu.square(), min=0.0)
        with torch.no_grad():
            self.mean.copy_(self.MOMENTUM * self.mean + (1 - self.MOMENTUM) * mu)
            self.var.copy_(self.MOMENTUM * self.var + (1 - self.MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mu[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class Conv(nn.Module):
    """A bias-free k x k conv with "SAME" padding (flax nn.Conv layout
    carried over as OIHW)."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1, bias: bool = False):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k))
        self.bias = nn.Parameter(torch.zeros(co)) if bias else None

    def forward(self, x):
        return conv_same(x, self.weight, self.stride, self.bias)


class Named(nn.Module):
    """Children named as flax names them, ``<Type>_<k>`` in call order; a
    child is also reachable under `attr`, which registers nothing."""

    def _child(self, module: nn.Module, attr: Optional[str] = None,
               kind: Optional[str] = None) -> nn.Module:
        kind = kind or type(module).__name__
        counts = self.__dict__.setdefault("_counts", {})
        k = counts.get(kind, 0)
        counts[kind] = k + 1
        self.add_module(f"{kind}_{k}", module)
        if attr is not None:
            self.__dict__[attr] = module
        return module


def init_weights(model: nn.Module, seed: int = 0,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded weights: conv and dense kernels normal with variance 1 /
    fan-in (flax's default lecun scaling), BN at identity, biases zero.
    They are drawn from `generator` if given, else from one seeded with
    `seed`."""
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model
