"""YOLOv5 checkpoint converter: an ultralytics state dict -> the port's
``YOLOv5(width=32, torch_pad=True)``.

Port of ``pointslot_tpu/detect/convert.py`` (the reference loads trained
YOLOv5 weights as a TorchScript module, src/YOLOdetector.cc:13-24).
``YOLOv5(width=32, depth=1)`` is layer for layer the ultralytics yolov5s
graph (width_multiple 0.5, depth_multiple 0.33); the map below names each
ultralytics layer's module in flax's terms, which the port's modules carry
(detect/layers.py), and ``convert.load_flax`` copies them in:

    torch layer                      module
    model.0   Conv(32, 6, s2)        ConvBnSiLU_0
    model.1   Conv(64, 3, s2)        ConvBnSiLU_1
    model.2   C3(64, n=1)            C3_0
    model.3   Conv(128, 3, s2)       ConvBnSiLU_2
    model.4   C3(128, n=2)           C3_1
    model.5   Conv(256, 3, s2)       ConvBnSiLU_3
    model.6   C3(256, n=3)           C3_2
    model.7   Conv(512, 3, s2)       ConvBnSiLU_4
    model.8   C3(512, n=1)           C3_3
    model.9   SPPF(512)              SPPF_0
    model.10  Conv(256, 1)           ConvBnSiLU_5
    model.13  C3(256, n=1, -sc)      C3_4
    model.14  Conv(128, 1)           ConvBnSiLU_6
    model.17  C3(128, n=1, -sc)      C3_5
    model.18  Conv(128, 3, s2)       ConvBnSiLU_7
    model.20  C3(256, n=1, -sc)      C3_6
    model.21  Conv(256, 3, s2)       ConvBnSiLU_8
    model.23  C3(512, n=1, -sc)      C3_7
    model.24  Detect (m.0/m.1/m.2)   Conv_0 / Conv_1 / Conv_2

Loading a raw ``.pt``: ``torch.load(path, map_location="cpu")`` works when
the file is a plain state dict or a dict with a ``model`` entry exposing
``state_dict()``/``float()``; full ultralytics pickles also need the
ultralytics package importable at unpickle time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pointslot_torch.convert import detector_from_flax

# (torch layer index, flax module name, number of C3 bottlenecks or None)
_LAYER_MAP = [
    (0, "ConvBnSiLU_0", None),
    (1, "ConvBnSiLU_1", None),
    (2, "C3_0", 1),
    (3, "ConvBnSiLU_2", None),
    (4, "C3_1", 2),
    (5, "ConvBnSiLU_3", None),
    (6, "C3_2", 3),
    (7, "ConvBnSiLU_4", None),
    (8, "C3_3", 1),
    (9, "SPPF_0", None),
    (10, "ConvBnSiLU_5", None),
    (13, "C3_4", 1),
    (14, "ConvBnSiLU_6", None),
    (17, "C3_5", 1),
    (18, "ConvBnSiLU_7", None),
    (20, "C3_6", 1),
    (21, "ConvBnSiLU_8", None),
    (23, "C3_7", 1),
]
_HEADS = [(24, "m.0", "Conv_0"), (24, "m.1", "Conv_1"), (24, "m.2", "Conv_2")]


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


class _TreeBuilder:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.params: dict = {}
        self.stats: dict = {}

    def need(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"checkpoint is missing '{key}'")
        return self.sd[key]

    def conv_bn(self, torch_prefix: str, flax_path: tuple):
        """One Conv-BN pair (ultralytics Conv block: .conv + .bn)."""
        p = self._dig(self.params, flax_path)
        s = self._dig(self.stats, flax_path)
        p["Conv_0"] = {"kernel": _conv_kernel(self.need(f"{torch_prefix}.conv.weight"))}
        p["BatchNorm_0"] = {
            "scale": self.need(f"{torch_prefix}.bn.weight"),
            "bias": self.need(f"{torch_prefix}.bn.bias"),
        }
        s["BatchNorm_0"] = {
            "mean": self.need(f"{torch_prefix}.bn.running_mean"),
            "var": self.need(f"{torch_prefix}.bn.running_var"),
        }

    @staticmethod
    def _dig(tree: dict, path: tuple) -> dict:
        for k in path:
            tree = tree.setdefault(k, {})
        return tree

    def c3(self, torch_prefix: str, flax_name: str, n_bottleneck: int):
        self.conv_bn(f"{torch_prefix}.cv1", (flax_name, "ConvBnSiLU_0"))
        self.conv_bn(f"{torch_prefix}.cv2", (flax_name, "ConvBnSiLU_1"))
        self.conv_bn(f"{torch_prefix}.cv3", (flax_name, "ConvBnSiLU_2"))
        for i in range(n_bottleneck):
            self.conv_bn(f"{torch_prefix}.m.{i}.cv1",
                         (flax_name, f"Bottleneck_{i}", "ConvBnSiLU_0"))
            self.conv_bn(f"{torch_prefix}.m.{i}.cv2",
                         (flax_name, f"Bottleneck_{i}", "ConvBnSiLU_1"))

    def sppf(self, torch_prefix: str, flax_name: str):
        self.conv_bn(f"{torch_prefix}.cv1", (flax_name, "ConvBnSiLU_0"))
        self.conv_bn(f"{torch_prefix}.cv2", (flax_name, "ConvBnSiLU_1"))

    def head(self, torch_key: str, flax_name: str):
        self.params[flax_name] = {
            "kernel": _conv_kernel(self.need(f"{torch_key}.weight")),
            "bias": self.need(f"{torch_key}.bias"),
        }


def convert_yolov5_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Ultralytics yolov5s state_dict -> variables in flax's layout
    {"params": ..., "batch_stats": ...} for ``YOLOv5(width=32, depth=1)``.
    Raises KeyError naming the first missing tensor on layout mismatch."""
    b = _TreeBuilder(sd)
    for idx, flax_name, n_bn in _LAYER_MAP:
        prefix = f"model.{idx}"
        if flax_name.startswith("ConvBnSiLU"):
            b.conv_bn(prefix, (flax_name,))
        elif flax_name.startswith("C3"):
            b.c3(prefix, flax_name, n_bn)
        elif flax_name.startswith("SPPF"):
            b.sppf(prefix, flax_name)
    for idx, sub, flax_name in _HEADS:
        b.head(f"model.{idx}.{sub}", flax_name)
    return {"params": b.params, "batch_stats": b.stats}


def yolov5_from_state_dict(sd) -> "YOLOv5":
    """The port's ``YOLOv5(width=32, torch_pad=True)`` holding an
    ultralytics yolov5s state dict (tensors or numpy arrays)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}
    return detector_from_flax(convert_yolov5_state_dict(sd), torch_pad=True)


def load_yolov5_pt(path: str) -> "YOLOv5":
    """Load a ``.pt`` checkpoint (see the module docstring for the pickle
    caveat) into the port's ``YOLOv5(width=32, torch_pad=True)``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        sd = obj["model"].float().state_dict()
    elif isinstance(obj, dict) and all(hasattr(v, "numpy") for v in obj.values()):
        sd = obj
    else:
        raise ValueError(f"unrecognized checkpoint structure in {path}")
    return yolov5_from_state_dict(sd)
