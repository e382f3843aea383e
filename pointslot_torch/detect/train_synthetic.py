"""Train the compact YOLO on synthetic scenes and save its weights.

The port's copy of ``scripts/train_synthetic_detector.py``, the recipe of
the bundled ``pointslot_tpu/detect/weights/synthetic_yolo_w8.npz``: the
left views of 12 scenes (seeds 201-212, 8 frames each, 2 objects,
0.8 m/frame) with their offline boxes, letterboxed to the input size and
staged on the device once; batches of B = 4 frames (at most M = 8 boxes
each) drawn by ``np.random.default_rng(0)`` in the script's order, a
horizontal flip with probability 0.5, AdamW at lr 2e-3, width 8. The
output is the flat npz that both packages' ``Detector.load_npz`` read.

The scenes are rendered on host threads (the renderer's numpy releases
the interpreter lock).

    python -m pointslot_torch.detect.train_synthetic [--steps 300] [--size 320]
        [--out build/weights/synthetic_yolo_w8.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pointslot_torch.datasets.synthetic import (SyntheticRenderer, make_scene,
                                                offline_detection_rows)
from pointslot_torch.detect.train import YoloTrainer
from pointslot_torch.detect.yolo import letterbox

SEEDS = tuple(range(201, 213))
SCENE = dict(n_frames=8, n_objects=2, forward_speed=0.8)
BATCH, MAX_BOXES, LR, WIDTH = 4, 8, 2e-3, 8
CAR = 2
RENDER_THREADS = 8
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "weights", "synthetic_yolo_w8.npz")


def letterbox_boxes(boxes_xywh: np.ndarray, r: float, pad) -> np.ndarray:
    out = boxes_xywh.copy()
    out[:, 0] = boxes_xywh[:, 0] * r + pad[0]
    out[:, 1] = boxes_xywh[:, 1] * r + pad[1]
    out[:, 2:] = boxes_xywh[:, 2:] * r
    return out


def _scene_views(seed: int):
    """One scene's (left view, its offline boxes (n, 4) xywh) per frame
    with at least one box."""
    scene = make_scene(seed=seed, **SCENE)
    renderer = SyntheticRenderer(scene)
    rows = offline_detection_rows(scene)
    out = []
    for i in range(scene.n_frames):
        frame_rows = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
        if len(frame_rows):
            out.append((renderer.render_left(i), frame_rows[:, 5:9].copy()))
    return out


def training_set(size: int = 320, device="cuda"):
    """(images (n, 3, size, size) float32 in [0, 1] on `device`, per-image
    letterboxed boxes (k, 4) cxcywh in input px) of the SEEDS scenes."""
    with ThreadPoolExecutor(min(RENDER_THREADS, len(SEEDS))) as pool:
        views = [v for scene in pool.map(_scene_views, SEEDS) for v in scene]
    imgs, boxes = [], []
    for left, bb in views:
        boxed, r, pad = letterbox(np.stack([left] * 3, axis=-1), size, device)
        bb[:, 0] += bb[:, 2] / 2   # xywh -> cxcywh
        bb[:, 1] += bb[:, 3] / 2
        imgs.append(boxed / 255.0)
        boxes.append(letterbox_boxes(bb, r, pad))
    return torch.stack(imgs).permute(0, 3, 1, 2).contiguous(), boxes


def train(trainer: YoloTrainer, imgs: torch.Tensor, frame_boxes, steps: int = 300,
          log_every: int = 50) -> np.ndarray:
    """The recipe's loop over a staged training set; returns the per-step
    losses (one transfer at the end, and one per logged step)."""
    size = trainer.input_size
    rng = np.random.default_rng(0)
    losses = []
    for step in range(steps):
        sel = rng.choice(len(frame_boxes), BATCH)
        batch = imgs[torch.from_numpy(sel).to(imgs.device)]
        boxes = np.zeros((BATCH, MAX_BOXES, 4), np.float32)
        classes = np.full((BATCH, MAX_BOXES), CAR, np.int64)
        n_boxes = np.zeros(BATCH, np.int64)
        for bi, s in enumerate(sel):
            bb = frame_boxes[s][:MAX_BOXES]
            boxes[bi, : len(bb)] = bb
            n_boxes[bi] = len(bb)
        if rng.uniform() < 0.5:  # horizontal flip augmentation
            batch = batch.flip(3)
            for bi in range(BATCH):
                boxes[bi, : n_boxes[bi], 0] = size - boxes[bi, : n_boxes[bi], 0]
        loss, aux = trainer.step_tensors(batch, trainer.targets(boxes, classes, n_boxes))
        losses.append(loss)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step}: loss {float(loss):.4f} box {float(aux['box']):.3f} "
                  f"obj {float(aux['obj']):.4f} cls {float(aux['cls']):.4f}", flush=True)
    return torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    imgs, frame_boxes = training_set(args.size, args.device)
    print(f"training frames: {len(frame_boxes)}")
    trainer = YoloTrainer(input_size=args.size, width=WIDTH, lr=LR, device=args.device)
    train(trainer, imgs, frame_boxes, args.steps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    trainer.save_npz(args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
