"""State carried across between the JAX package's layout and the port's.

The reference keeps descriptors as (N, 8) uint32; the port keeps the same
bits in (N, 8) int32 words (torch has no uint32 shifts on the CPU). These
helpers move map tables, object tables, poses and step results between the
two layouts, so that "the same inputs" means the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def to_tensor(x, dtype, device) -> torch.Tensor:
    """numpy array / tensor -> tensor on `device` (dtype None keeps it).
    uint32 descriptor words are reinterpreted as int32, bits unchanged."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(device)
    return x if dtype is None else x.to(dtype)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 words -> (..., 8) uint32, bits unchanged."""
    return desc.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def map_tables(pos, desc, level, valid, device):
    """Map tables in the JAX layout (desc uint32) -> port tensors."""
    return (to_tensor(pos, torch.float32, device), to_tensor(desc, torch.int32, device),
            to_tensor(level, torch.int32, device), to_tensor(valid, torch.bool, device))


def object_tables(pos, desc, valid, device):
    """Object tables (O, Mo, ...) in the JAX layout -> port tensors."""
    return (to_tensor(pos, torch.float32, device), to_tensor(desc, torch.int32, device),
            to_tensor(valid, torch.bool, device))


def to_numpy(result: NamedTuple) -> NamedTuple:
    """A port result (FusedStepResult, StereoFrame, FeatureSet, ...) -> the
    same NamedTuple of numpy arrays in the JAX layout (desc as uint32)."""
    out = {}
    for name, value in result._asdict().items():
        out[name] = (desc_to_numpy(value) if name == "desc"
                     else value.detach().cpu().numpy())
    return type(result)(**out)
