"""State carried across between the JAX package's layout and the port's.

The reference keeps descriptors as (N, 8) uint32; the port keeps the same
bits in (N, 8) int32 words (torch has no uint32 shifts on the CPU). These
helpers move map tables, object tables, poses and step results between the
two layouts, so that "the same inputs" means the same bits, bring device
results to the host in one transfer, and build the port's map, object and
loop-closing state from the reference's numpy tables.
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
    return frame_record_with(sf, frame_id)[0]


def frame_record_with(sf, frame_id: int, *extra):
    """`frame_record`, with the `extra` tensors brought to the host in the
    same transfer: (FrameRecord, tuple of arrays)."""
    from pointslot_torch.slam.tracking import FrameRecord

    xy, level, desc, angle, depth, u_right, valid, *rest = host(
        sf.xy, sf.level, sf.desc, sf.angle, sf.depth, sf.u_right, sf.valid, *extra)
    return FrameRecord(
        frame_id=frame_id, xy=xy, level=level, desc=desc.view(np.uint32),
        angle=angle, depth=depth, u_right=u_right, valid=valid,
        point_idx=np.full(xy.shape[0], -1, np.int64),
    ), tuple(rest)


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


def copy_loop_state(other, closer):
    """Copy the loop-closing state of `other` (the reference's LoopCloser,
    or any object with the same fields) into the port's LoopCloser
    `closer`: the keyframe database's tf-idf vectors and presence flags,
    the consistent covisibility groups, the last loop keyframe and the loop
    count. The map is copied apart (``map_state_from_arrays``)."""
    closer.db.vectors = np.array(other.db.vectors, np.float32)
    closer.db.present = np.array(other.db.present, bool)
    closer._consistent_groups = [(set(g), int(c)) for g, c in other._consistent_groups]
    closer.last_loop_kf = other.last_loop_kf
    closer.loops_closed = other.loops_closed
    return closer


def copy_object_state(value):
    """A deep copy of object-layer host state (arrays, dicts, lists, and
    records: a Detection, an ObjectKeyFrameRec, an ObjectTrack) whose
    records become the port's classes of the same name."""
    import dataclasses

    from pointslot_torch.slam import objects

    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, dict):
        return {k: copy_object_state(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(copy_object_state(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = getattr(objects, type(value).__name__)
        out = cls.__new__(cls)   # no __post_init__: it would reset the tables
        for f in dataclasses.fields(cls):
            setattr(out, f.name, copy_object_state(getattr(value, f.name)))
        return out
    return value


def object_tracks_from_arrays(tracks) -> list:
    """The port's ObjectTracks with every field of `tracks` (the reference's
    ObjectTracks, or any objects with the same fields) copied: point
    tables, keyframes, per-frame states, velocity, votes, epoch."""
    return [copy_object_state(t) for t in tracks]


def object_system_from_arrays(other, config, device="cuda"):
    """The port's ObjectSystem (without a System: own frontend, synchronous
    object mapping) holding a copy of `other`'s tracks, with the same
    track objects shared between its `tracks` dict and its `all_tracks`
    list as in `other`, and its pending-keyframe counts and BA count."""
    from pointslot_torch.slam.object_system import ObjectSystem

    o = ObjectSystem(config, None, device=device)
    copies = dict(zip(map(id, other.all_tracks), object_tracks_from_arrays(other.all_tracks)))
    o.all_tracks = [copies[id(t)] for t in other.all_tracks]
    o.tracks = {k: copies[id(t)] for k, t in other.tracks.items()}
    o._pending_okfs = dict(other._pending_okfs)
    o.ba_calls = other.ba_calls
    return o


def flat_flax(variables) -> dict:
    """Flax variables ({"params": ..., "batch_stats": ...}, nested, numpy
    or jax arrays) or their flat npz dict -> {"params/a/b/leaf": array}."""
    flat = {}

    def walk(prefix, value):
        if isinstance(value, dict) or hasattr(value, "items"):
            for k, v in value.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(value)

    walk("", variables)
    return flat


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy flax variables into `module`, whose children carry flax's
    names (detect/layers.py): kernels HWIO -> OIHW (a dense kernel is
    transposed), BN scale and bias from "params", mean and var from
    "batch_stats". Raises KeyError on a tensor missing or left over and
    ValueError on a shape that differs. The module comes back in eval mode
    (BatchNorm's inference form), as flax's ``apply`` defaults to
    ``train=False``."""
    flat = flat_flax(variables)
    used = set()
    state = {}
    for key, ref in module.state_dict().items():
        *path, leaf = key.split(".")
        path = "/".join(path)
        if leaf == "weight":
            src = f"params/{path}/kernel"
        elif leaf in ("mean", "var"):
            src = f"batch_stats/{path}/{leaf}"
        else:
            src = f"params/{path}/{leaf}"
        if src not in flat:
            raise KeyError(f"flax variables are missing '{src}'")
        value = flat[src]
        if leaf == "weight":
            value = value.T if value.ndim == 2 else np.transpose(value, (3, 2, 0, 1))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"'{src}' has shape {value.shape}, the module wants {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.array(value, np.float32))
        used.add(src)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"flax variables hold tensors the module lacks: {extra[:4]}")
    module.load_state_dict(state)
    return module.eval()


def flax_from_module(module: torch.nn.Module) -> dict:
    """The inverse of `load_flax`: the module's weights as the flat
    "params/..." / "batch_stats/..." dict the JAX package saves."""
    out = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        path = "/".join(path)
        value = value.detach().cpu().numpy()
        if leaf == "weight":
            value = value.T if value.ndim == 2 else np.transpose(value, (2, 3, 1, 0))
            out[f"params/{path}/kernel"] = np.ascontiguousarray(value)
        elif leaf in ("mean", "var"):
            out[f"batch_stats/{path}/{leaf}"] = value
        else:
            out[f"params/{path}/{leaf}"] = value
    return out


def detector_from_flax(variables, torch_pad: bool = False):
    """The port's YOLOv5 holding the JAX package's detector variables (its
    ``Detector.variables``, or the flat npz of ``save_npz``). Width, depth
    and class count are read from the shapes."""
    from pointslot_torch.detect.yolo import YOLOv5

    flat = flat_flax(variables)
    width = flat["params/ConvBnSiLU_0/Conv_0/kernel"].shape[-1]
    depth = sum(1 for k in flat if k.startswith("params/C3_0/Bottleneck_")
                and k.endswith("ConvBnSiLU_0/Conv_0/kernel"))
    n_classes = flat["params/Conv_0/kernel"].shape[-1] // 3 - 5
    return load_flax(YOLOv5(width=width, depth=depth, n_classes=n_classes,
                            torch_pad=torch_pad), flat)


def reid_from_flax(variables):
    """The port's ReIDNet holding the JAX package's ReID variables (its
    ``ReIDEmbedder.variables``, or the flat npz of train_reid.save_npz)."""
    from pointslot_torch.detect.reid import ReIDNet

    flat = flat_flax(variables)
    return load_flax(ReIDNet(features=flat["params/Dense_0/kernel"].shape[-1]), flat)


def yolo_trainer_from_flax(variables, input_size: int = 320, lr: float = 1e-3,
                           device="cuda"):
    """A ``detect.train.YoloTrainer`` starting from the JAX package's
    detector variables (its trainer's ``variables``, or the flat npz)."""
    from pointslot_torch.detect.train import YoloTrainer

    return YoloTrainer(input_size=input_size, lr=lr, device=device,
                       model=detector_from_flax(variables))


def reid_training_from_flax(variables, head) -> tuple:
    """The JAX ReID training's initial state -- its network's variables and
    the (features, n_ids) softmax head -- as the port's (ReIDNet, head
    tensor), for ``detect.train_reid.train(init=...)``."""
    return reid_from_flax(variables), torch.from_numpy(np.array(head, np.float32))
