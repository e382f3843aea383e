"""YOLOv5-style one-stage detector, with decode and class-aware NMS.

Port of ``pointslot_tpu/detect/yolo.py`` (the reference's TorchScript
YOLOv5 runtime, src/YOLOdetector.cc: letterbox :51/:106, forward :81, NMS
to Detection{bbox, score, class}; classes car (2) and truck (7) kept at
src/Frame.cc:2557): an anchor-based CSP backbone, a PAN neck and three
stride-8/16/32 heads of Conv-BN-SiLU blocks, in NCHW.

The modules carry flax's automatic names (``ConvBnSiLU_0``, ``C3_1``,
``Bottleneck_0``, ...) in call order, so that ``convert.detector_from_flax``
maps the JAX package's variables onto them name for name.

- Padding: XLA "SAME" by default, (0, 1) for a stride-2 3x3 on an even
  side, as the bundled weights were trained; ``torch_pad`` (converted
  ultralytics checkpoints) pads symmetrically and uses BN eps 1e-3.
- SPPF's 5x5 max pools pad with -inf; the neck upsamples by 2x nearest.
- The heads are permuted to (b, hy, hx, 3 * (5 + C)) before the reshape,
  so that decoded rows come in the JAX package's order.
- ``nms`` sorts stably (``lax.top_k``'s lower-index tie order), builds the
  (512, 512) suppression matrix on the device and runs the greedy loop on
  the host after one transfer: a device loop would be 512 dependent steps.
- ``letterbox`` resizes with jax.image.resize's antialiased bilinear
  weights (``ops/pyramid.py``), on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pointslot_torch.convert import host
from pointslot_torch.detect.layers import BatchNorm, Conv, Named, conv_same, init_weights
from pointslot_torch.device import resolve_device
from pointslot_torch.ops.pyramid import resize_mats

# COCO anchor priors per stride (w, h), YOLOv5s layout
ANCHORS = {
    8: ((10, 13), (16, 30), (33, 23)),
    16: ((30, 61), (62, 45), (59, 119)),
    32: ((116, 90), (156, 198), (373, 326)),
}
N_CLASSES = 80


class ConvBnSiLU(Named):
    def __init__(self, ci: int, co: int, kernel: int = 3, stride: int = 1,
                 torch_pad: bool = False):
        super().__init__()
        self.stride = stride
        self.pad = None
        if torch_pad and stride > 1:
            # odd k: p = k//2 (ultralytics autopad); the yolov5 stem's 6x6
            # passes p = 2 (= k//2 - 1)
            self.pad = kernel // 2 if kernel % 2 else kernel // 2 - 1
        self._child(Conv(ci, co, kernel, stride), "conv")
        self._child(BatchNorm(co, 1e-3 if torch_pad else 1e-5), "bn")

    def forward(self, x):
        if self.pad is None:
            x = conv_same(x, self.conv.weight, self.stride)
        else:
            x = F.conv2d(x, self.conv.weight, None, self.stride, self.pad)
        return F.silu(self.bn(x))


class Bottleneck(Named):
    def __init__(self, ci: int, co: int, shortcut: bool = True, torch_pad: bool = False):
        super().__init__()
        self._child(ConvBnSiLU(ci, co, 1, torch_pad=torch_pad), "cv1")
        self._child(ConvBnSiLU(co, co, 3, torch_pad=torch_pad), "cv2")
        self.add = shortcut and ci == co

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(Named):
    """CSP bottleneck block with 3 convolutions (YOLOv5's C3)."""

    def __init__(self, ci: int, co: int, n: int = 1, shortcut: bool = True,
                 torch_pad: bool = False):
        super().__init__()
        h = co // 2
        self._child(ConvBnSiLU(ci, h, 1, torch_pad=torch_pad), "cv1")
        self.m = [self._child(Bottleneck(h, h, shortcut, torch_pad)) for _ in range(n)]
        self._child(ConvBnSiLU(ci, h, 1, torch_pad=torch_pad), "cv2")
        self._child(ConvBnSiLU(2 * h, co, 1, torch_pad=torch_pad), "cv3")

    def forward(self, x):
        a = self.cv1(x)
        for b in self.m:
            a = b(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class SPPF(Named):
    """Spatial pyramid pooling (fast): three chained 5x5 max pools."""

    def __init__(self, ci: int, co: int, torch_pad: bool = False):
        super().__init__()
        h = co // 2
        self._child(ConvBnSiLU(ci, h, 1, torch_pad=torch_pad), "cv1")
        self._child(ConvBnSiLU(4 * h, co, 1, torch_pad=torch_pad), "cv2")

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], 1))


def _up2(x):
    """2x nearest upsampling (jax.image.resize "nearest" at an exact 2x)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv5(Named):
    """Compact CSP backbone + PAN neck + 3 anchor heads."""

    def __init__(self, width: int = 16, depth: int = 1, n_classes: int = N_CLASSES,
                 torch_pad: bool = False):
        super().__init__()
        w, d, tp = width, depth, torch_pad
        self.width, self.torch_pad, self.n_classes = width, torch_pad, n_classes
        no = 3 * (5 + n_classes)
        layers = (
            ("stem", ConvBnSiLU(3, w, 6, 2, tp)),                     # /2
            ("down1", ConvBnSiLU(w, w * 2, 3, 2, tp)),                # /4
            ("c3_1", C3(w * 2, w * 2, d, torch_pad=tp)),
            ("down2", ConvBnSiLU(w * 2, w * 4, 3, 2, tp)),            # /8
            ("c3_p3", C3(w * 4, w * 4, d * 2, torch_pad=tp)),
            ("down3", ConvBnSiLU(w * 4, w * 8, 3, 2, tp)),            # /16
            ("c3_p4", C3(w * 8, w * 8, d * 3, torch_pad=tp)),
            ("down4", ConvBnSiLU(w * 8, w * 16, 3, 2, tp)),           # /32
            ("c3_5", C3(w * 16, w * 16, d, torch_pad=tp)),
            ("sppf", SPPF(w * 16, w * 16, tp)),
            ("u5", ConvBnSiLU(w * 16, w * 8, 1, torch_pad=tp)),       # PAN neck
            ("n4", C3(w * 16, w * 8, d, shortcut=False, torch_pad=tp)),
            ("u4", ConvBnSiLU(w * 8, w * 4, 1, torch_pad=tp)),
            ("n3", C3(w * 8, w * 4, d, shortcut=False, torch_pad=tp)),
            ("d3", ConvBnSiLU(w * 4, w * 4, 3, 2, tp)),
            ("n4b", C3(w * 8, w * 8, d, shortcut=False, torch_pad=tp)),
            ("d4", ConvBnSiLU(w * 8, w * 8, 3, 2, tp)),
            ("n5", C3(w * 16, w * 16, d, shortcut=False, torch_pad=tp)),
        )
        for attr, module in layers:
            self._child(module, attr)
        self.heads = [self._child(Conv(ch, no, 1, bias=True)) for ch in (w * 4, w * 8, w * 16)]

    def forward(self, x):
        """x (b, 3, s, s) -> three heads (b, hy, hx, 3 * (5 + C))."""
        x = self.c3_1(self.down1(self.stem(x)))
        p3 = self.c3_p3(self.down2(x))
        p4 = self.c3_p4(self.down3(p3))
        p5 = self.sppf(self.c3_5(self.down4(p4)))
        u5 = self.u5(p5)
        u4 = self.u4(self.n4(torch.cat([_up2(u5), p4], 1)))
        n3 = self.n3(torch.cat([_up2(u4), p3], 1))
        n4b = self.n4b(torch.cat([self.d3(n3), u4], 1))
        n5 = self.n5(torch.cat([self.d4(n4b), u5], 1))
        return tuple(h(f).permute(0, 2, 3, 1) for h, f in zip(self.heads, (n3, n4b, n5)))


def decode_predictions(heads, img_size: int, n_classes: int = N_CLASSES) -> torch.Tensor:
    """Raw heads (b, hy, hx, 3 * (5 + C)) -> (b, N, 4 + 1 + C): xywh in
    image px, objectness, class scores."""
    outs = []
    for head, stride in zip(heads, (8, 16, 32)):
        b, hy, hx, _ = head.shape
        p = torch.sigmoid(head.reshape(b, hy, hx, 3, 5 + n_classes))
        gy = torch.arange(hy, dtype=torch.float32, device=p.device)[:, None]
        gx = torch.arange(hx, dtype=torch.float32, device=p.device)[None, :]
        anchors = torch.tensor(ANCHORS[stride], dtype=torch.float32, device=p.device)
        cx = (p[..., 0] * 2 - 0.5 + gx[None, :, :, None]) * stride
        cy = (p[..., 1] * 2 - 0.5 + gy[None, :, :, None]) * stride
        wh = (p[..., 2:4] * 2) ** 2 * anchors
        box = torch.stack([cx, cy, wh[..., 0], wh[..., 1]], -1)
        outs.append(torch.cat([box, p[..., 4:]], -1).reshape(b, -1, 5 + n_classes))
    return torch.cat(outs, dim=1)


def nms_candidates(pred: torch.Tensor, conf_threshold: float = 0.4,
                   iou_threshold: float = 0.5, max_candidates: int = 512):
    """The device half of ``nms``: the top candidates by score (a stable
    descending sort, so ties keep the lower index as ``lax.top_k`` does),
    their boxes and classes, and the (k, k) suppression matrix."""
    scores_all = pred[:, 4:5] * pred[:, 5:]
    score, cls = scores_all.max(dim=1)
    # argmax's first maximum, as jnp.argmax
    cls = (scores_all == score[:, None]).to(torch.int8).argmax(dim=1)
    score = torch.where(score >= conf_threshold, score, torch.zeros_like(score))
    k = min(max_candidates, pred.shape[0])
    top_score, idx = torch.sort(score, descending=True, stable=True)
    top_score, idx = top_score[:k], idx[:k]
    boxes = pred[idx, :4]
    classes = cls[idx]
    x0 = boxes[:, 0] - boxes[:, 2] / 2
    y0 = boxes[:, 1] - boxes[:, 3] / 2
    x1 = boxes[:, 0] + boxes[:, 2] / 2
    y1 = boxes[:, 1] + boxes[:, 3] / 2
    area = boxes[:, 2] * boxes[:, 3]
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    order = torch.arange(k, device=pred.device)
    suppress = ((iou > iou_threshold) & (classes[:, None] == classes[None, :])
                & (order[:, None] < order[None, :]))
    return boxes, top_score, classes, suppress


def greedy_keep(top_score: np.ndarray, suppress: np.ndarray) -> np.ndarray:
    """The greedy suppression in score order, on the host: candidate i
    survives if no higher-scoring same-class survivor overlaps it. Only
    the positive-score prefix can survive (scores are sorted)."""
    k = len(top_score)
    keep = np.zeros(k, bool)
    for i in range(int((top_score > 0).sum())):
        keep[i] = not np.any(suppress[:i, i] & keep[:i])
    return keep


def nms(pred: torch.Tensor, conf_threshold: float = 0.4, iou_threshold: float = 0.5,
        max_out: int = 64, max_candidates: int = 512):
    """Class-aware NMS. pred: (N, 5 + C). Returns host arrays (boxes
    (max_out, 4) cxcywh, scores (max_out,), classes (max_out,), valid
    (max_out,)), the kept candidates first in score order."""
    boxes, top_score, classes, suppress = nms_candidates(
        pred, conf_threshold, iou_threshold, max_candidates)
    boxes, top_score, classes, suppress = host(boxes, top_score, classes, suppress)
    keep = greedy_keep(top_score, suppress)
    keep_score = np.where(keep, top_score, np.float32(-1.0))
    fidx = np.argsort(-keep_score, kind="stable")[:max_out]
    final = keep_score[fidx]
    return boxes[fidx], np.maximum(final, 0.0), classes[fidx], final > 0


def letterbox(img: np.ndarray, size: int = 640, device="cuda"):
    """Resize keeping aspect, pad to (size, size) with 114-grey
    (reference src/YOLOdetector.cc:51): ((size, size, C) float32 tensor on
    `device` (the card by default), scale r, (left, top))."""
    device = resolve_device(device)
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    R, C = resize_mats(h, w, nh, nw)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(torch.float32)
    x = x.reshape(h, w, -1).permute(2, 0, 1)                       # (C, h, w)
    resized = torch.from_numpy(R).to(device) @ x @ torch.from_numpy(C).to(device)
    out = torch.full((x.shape[0], size, size), 114.0, dtype=torch.float32, device=device)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out[:, top:top + nh, left:left + nw] = resized
    out = out.permute(1, 2, 0)
    return (out if img.ndim == 3 else out[..., 0]), r, (left, top)


class Detector:
    """End-to-end detector: letterbox -> network -> decode -> NMS -> image
    coords, keeping the configured classes (reference Detector::Run)."""

    def __init__(self, input_size: int = 640, conf: float = 0.4, iou: float = 0.5,
                 keep_classes: Sequence[int] = (2, 7), seed: int = 0,
                 model: Optional[YOLOv5] = None, width: int = 16,
                 torch_pad: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if model is None:
            model = init_weights(YOLOv5(width=width, torch_pad=torch_pad), seed)
        self.model = model.to(self.device).eval()
        self.input_size = input_size
        self.conf, self.iou = conf, iou
        self.keep_classes = tuple(keep_classes)

    @classmethod
    def from_ultralytics(cls, path_or_state_dict, input_size: int = 640,
                         conf: float = 0.4, iou: float = 0.5,
                         keep_classes: Sequence[int] = (2, 7), device="cuda") -> "Detector":
        """A yolov5s-geometry detector (width 32, torch padding) from a
        public ultralytics checkpoint: a ``.pt`` path or a state dict
        (detect/convert.py). The reference loads the TorchScript export
        (src/YOLOdetector.cc:13)."""
        from pointslot_torch.detect import convert

        if isinstance(path_or_state_dict, (str, bytes)):
            model = convert.load_yolov5_pt(path_or_state_dict)
        else:
            model = convert.yolov5_from_state_dict(path_or_state_dict)
        return cls(input_size=input_size, conf=conf, iou=iou, keep_classes=keep_classes,
                   model=model, device=device)

    def load_npz(self, path: str):
        """Load the JAX package's flat npz of flax variables (its
        ``save_npz``): the architecture is taken from the file."""
        from pointslot_torch import convert

        self.model = convert.detector_from_flax(
            dict(np.load(path)), torch_pad=self.model.torch_pad).to(self.device).eval()

    def save_npz(self, path: str):
        """Save in the JAX package's flat npz layout."""
        from pointslot_torch import convert

        np.savez(path, **convert.flax_from_module(self.model))

    @torch.no_grad()
    def heads(self, x: torch.Tensor):
        return self.model(x)

    @torch.no_grad()
    def run(self, img: np.ndarray):
        """img: (H, W) grey or (H, W, 3) uint8. Returns a list of {bbox
        (x, y, w, h) in image coords, score, class_id}."""
        boxed, r, (left, top) = letterbox(img, self.input_size, self.device)
        if img.ndim == 2:   # grey: the three equal channels made on the device
            boxed = boxed[..., None].expand(-1, -1, 3)
        x = (boxed / 255.0).permute(2, 0, 1)[None]
        pred = decode_predictions(self.model(x), self.input_size)[0]
        boxes, scores, classes, valid = nms(pred, self.conf, self.iou)
        out = []
        for b, s, c, v in zip(boxes, scores, classes, valid):
            if not v or int(c) not in self.keep_classes:
                continue
            cx, cy, w, h = b
            out.append({
                "bbox": np.array([(cx - w / 2 - left) / r, (cy - h / 2 - top) / r,
                                  w / r, h / r]),
                "score": float(s),
                "class_id": int(c),
            })
        return out
