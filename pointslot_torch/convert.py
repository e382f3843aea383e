"""State carried across between the JAX package's layout and the port's.

The reference keeps descriptors as (N, 8) uint32; the port keeps the same
bits in (N, 8) int32 words (torch has no uint32 shifts on the CPU). These
helpers move map tables, object tables, poses and step results between the
two layouts, so that "the same inputs" means the same bits, and bring
device results to the host in one transfer.
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


def host(*tensors) -> tuple:
    """Tensors -> numpy arrays with one wait for the device: every copy is
    queued (asynchronous into pinned memory on a card), then one
    synchronisation. The arrays keep the tensors' dtypes (descriptor words
    stay int32; see `desc_to_numpy`)."""
    outs = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    for t in tensors:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            break
    return tuple(o.numpy() for o in outs)


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


def frame_record(sf, frame_id: int):
    """The port's StereoFrame (device tensors) -> a host FrameRecord, in one
    device-to-host transfer; descriptors come back as uint32 words."""
    from pointslot_torch.slam.tracking import FrameRecord

    xy, level, desc, angle, depth, u_right, valid = host(
        sf.xy, sf.level, sf.desc, sf.angle, sf.depth, sf.u_right, sf.valid)
    return FrameRecord(
        frame_id=frame_id, xy=xy, level=level, desc=desc.view(np.uint32),
        angle=angle, depth=depth, u_right=u_right, valid=valid,
        point_idx=np.full(xy.shape[0], -1, np.int64),
    )


def map_state_from_arrays(other):
    """The port's MapState with every table of `other` (the reference's
    MapState, or any object with the same numpy fields) copied field by
    field, allocation counter included."""
    import dataclasses

    from pointslot_torch.slam.map_state import MapState

    m = MapState(max_kfs=other.max_kfs, max_points=other.max_points,
                 feats_per_kf=other.feats_per_kf)
    for f in dataclasses.fields(MapState):
        value = getattr(other, f.name)
        setattr(m, f.name, value.copy() if isinstance(value, np.ndarray) else value)
    m._next_uid = other._next_uid
    return m
