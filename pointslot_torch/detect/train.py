"""YOLO training: anchor assignment, the composite detection loss and the
optimizer step.

Port of ``pointslot_tpu/detect/train.py``. The reference consumes trained
TorchScript engines and trains nothing; here the compact YOLOv5 trains on
labelled frames (the synthetic box scenes, ``detect/train_synthetic.py``)
or fine-tunes converted weights.

- ``build_targets`` is the JAX package's numpy code as it is: a later box
  overwrites an earlier one in the same cell and anchor, and the cell
  index truncates (``int(np.clip(...))``).
- ``detection_loss`` reads the heads in the (B, gh, gw, 3 * (5 + C)) row
  order that ``YOLOv5`` returns: a DIoU box term over the positives, an
  objectness BCE against the detached IoU at the positives and 0 elsewhere
  (a mean over every cell, weighted 4.0 / 1.0 / 0.4 by level), the class
  BCE at the positives, each of the box and class terms divided by the
  level's positive count.
- ``YoloTrainer`` trains with the network in its training form (flax's
  BatchNorm with batch statistics, ``detect/layers.py``) and
  ``torch.optim.AdamW`` with optax ``adamw``'s defaults: betas (0.9,
  0.999), eps 1e-8, weight decay 1e-4 on every parameter.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pointslot_torch.detect.layers import init_weights
from pointslot_torch.detect.yolo import ANCHORS, N_CLASSES, YOLOv5
from pointslot_torch.device import resolve_device

STRIDES = (8, 16, 32)
LEVEL_BALANCE = (4.0, 1.0, 0.4)   # objectness weight per level (YOLOv5)


def build_targets(boxes: np.ndarray, classes: np.ndarray, n_boxes, img_size: int):
    """Host-side anchor assignment.

    boxes: (B, M, 4) cxcywh in image px (zero rows beyond n_boxes[b]);
    classes: (B, M) int; n_boxes: (B,).
    Returns per level: (B, H, W, 3, 6) targets [tx, ty, tw, th, obj, class]
    with the YOLOv5 wh-ratio anchor match (ratio < 4).
    """
    B, M, _ = boxes.shape
    out = []
    for stride, lvl_anchors in zip(STRIDES, (ANCHORS[8], ANCHORS[16], ANCHORS[32])):
        gs = img_size // stride
        t = np.zeros((B, gs, gs, 3, 6), np.float32)
        for b in range(B):
            for m in range(int(n_boxes[b])):
                cx, cy, w, h = boxes[b, m]
                if w <= 2 or h <= 2:
                    continue
                gi = int(np.clip(cx / stride, 0, gs - 1))
                gj = int(np.clip(cy / stride, 0, gs - 1))
                for a, (aw, ah) in enumerate(lvl_anchors):
                    r = np.array([w / aw, h / ah])
                    if np.max(np.maximum(r, 1 / r)) < 4.0:
                        t[b, gj, gi, a] = [cx, cy, w, h, 1.0, classes[b, m]]
        out.append(t)
    return out


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, term for term."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def detection_loss(heads: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
                   n_classes: int = N_CLASSES, box_gain: float = 0.5):
    """Composite YOLO loss from the raw heads (B, gh, gw, 3 * (5 + C)) and
    the assigned targets (B, gh, gw, 3, 6): (loss, {"box", "obj", "cls"})."""
    total_box = total_obj = total_cls = 0.0
    for head, tgt, stride, balance in zip(heads, targets, STRIDES, LEVEL_BALANCE):
        B, gh, gw, _ = head.shape
        p = head.reshape(B, gh, gw, 3, 5 + n_classes)
        ps = torch.sigmoid(p)
        dev = head.device
        gy = torch.arange(gh, dtype=torch.float32, device=dev)[None, :, None, None]
        gx = torch.arange(gw, dtype=torch.float32, device=dev)[None, None, :, None]
        anchors = torch.tensor(ANCHORS[stride], dtype=torch.float32, device=dev)
        pred_cx = (ps[..., 0] * 2 - 0.5 + gx) * stride
        pred_cy = (ps[..., 1] * 2 - 0.5 + gy) * stride
        pred_wh = (ps[..., 2:4] * 2) ** 2 * anchors

        obj_mask = tgt[..., 4] > 0.5
        t_box = tgt[..., :4]

        # DIoU between predicted and target boxes (positive cells only)
        px0 = pred_cx - pred_wh[..., 0] / 2
        py0 = pred_cy - pred_wh[..., 1] / 2
        px1 = pred_cx + pred_wh[..., 0] / 2
        py1 = pred_cy + pred_wh[..., 1] / 2
        tx0 = t_box[..., 0] - t_box[..., 2] / 2
        ty0 = t_box[..., 1] - t_box[..., 3] / 2
        tx1 = t_box[..., 0] + t_box[..., 2] / 2
        ty1 = t_box[..., 1] + t_box[..., 3] / 2
        iw = torch.clamp(torch.minimum(px1, tx1) - torch.maximum(px0, tx0), min=0)
        ih = torch.clamp(torch.minimum(py1, ty1) - torch.maximum(py0, ty0), min=0)
        inter = iw * ih
        area_p = torch.clamp(px1 - px0, min=0) * torch.clamp(py1 - py0, min=0)
        area_t = torch.clamp(tx1 - tx0, min=0) * torch.clamp(ty1 - ty0, min=0)
        union = torch.clamp(area_p + area_t - inter, min=1e-9)
        iou = inter / union
        cw = torch.maximum(px1, tx1) - torch.minimum(px0, tx0)
        ch = torch.maximum(py1, ty1) - torch.minimum(py0, ty0)
        c2 = cw ** 2 + ch ** 2 + 1e-9
        rho2 = (pred_cx - t_box[..., 0]) ** 2 + (pred_cy - t_box[..., 1]) ** 2
        diou = iou - rho2 / c2
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        box_loss = torch.where(obj_mask, 1.0 - diou, zero)
        n_pos = torch.clamp(obj_mask.sum(), min=1)
        total_box = total_box + box_loss.sum() / n_pos

        # objectness: IoU-aware target at positives, 0 elsewhere
        obj_target = torch.where(obj_mask, torch.clamp(iou.detach(), 0, 1), zero)
        total_obj = total_obj + balance * _bce_with_logits(p[..., 4], obj_target).mean()

        # classification at positives
        cls_target = F.one_hot(tgt[..., 5].to(torch.int64), n_classes).to(torch.float32)
        cls_bce = _bce_with_logits(p[..., 5:], cls_target)
        total_cls = total_cls + torch.where(obj_mask[..., None], cls_bce, zero).sum() / n_pos

    loss = box_gain * total_box + 1.0 * total_obj + 0.3 * total_cls
    return loss, {"box": total_box, "obj": total_obj, "cls": total_cls}


class YoloTrainer:
    """One optimizer over a YOLOv5 in its training form.

    ``model`` (or, if None, a seeded ``YOLOv5(width)``) is moved to
    `device`; ``convert.yolo_trainer_from_flax`` starts one from the JAX
    package's variables ({"params", "batch_stats"})."""

    def __init__(self, input_size: int = 320, width: int = 8, lr: float = 1e-3,
                 seed: int = 0, device="cuda", model: Optional[YOLOv5] = None):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.lr = lr
        if model is None:
            model = init_weights(YOLOv5(width=width), seed)
        self.model = model.to(self.device).train()
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)

    def targets(self, boxes: np.ndarray, classes: np.ndarray, n_boxes) -> list:
        """build_targets on the host, then one upload per level."""
        return [torch.from_numpy(t).to(self.device)
                for t in build_targets(boxes, classes, n_boxes, self.input_size)]

    def step_tensors(self, images: torch.Tensor, targets: Sequence[torch.Tensor]):
        """One step on device tensors: images (B, 3, S, S) in [0, 1], the
        targets of ``targets``. Returns (loss, aux) as device scalars."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss, aux = detection_loss(self.model(images), targets)
        loss.backward()
        self.opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def step(self, images: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
             n_boxes: np.ndarray):
        """One optimization step. images (B, S, S, 3) in [0, 1]. Returns
        (loss, {"box", "obj", "cls"}) as floats."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        loss, aux = self.step_tensors(x.permute(0, 3, 1, 2),
                                      self.targets(boxes, classes, n_boxes))
        vals = torch.stack([loss, aux["box"], aux["obj"], aux["cls"]]).cpu().tolist()
        return vals[0], dict(zip(("box", "obj", "cls"), vals[1:]))

    def save_npz(self, path: str):
        """The trained network in the JAX package's flat npz layout (what
        both packages' ``Detector.load_npz`` read)."""
        from pointslot_torch import convert

        np.savez(path, **convert.flax_from_module(self.model))
