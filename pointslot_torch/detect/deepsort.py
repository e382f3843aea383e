"""DeepSORT-style multi-object tracking: Kalman + cascade association.

A copy of ``pointslot_tpu/detect/deepsort.py`` (the reference's vendored
deepsort library: deepsort/src/ kalmanfilter.cpp 8-state filter,
nn_matching.cpp cosine appearance metric with budget,
linear_assignment.cpp + munkres.cpp cascade matching, track.cpp lifecycle,
deepsort.cpp entry ``DeepSort::sort``).

Host numpy: the per-frame track count is small (< 100), so the Kalman
updates and the assignment solves take microseconds on the CPU; the card
runs the ReID network (detect/reid.py). ``hungarian`` is
``scipy.optimize.linear_sum_assignment`` with the reference's (R <= C)
contract, where the JAX package calls its C++ solver.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from pointslot_torch.config import DetectorConfig

# chi-square 0.95 quantile for 4 dof — the Mahalanobis gate
# (reference deepsort kalmanfilter.cpp chi2inv95)
GATING_THRESHOLD = 9.4877
INFTY_COST = 1e5


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment: (R, C) cost with R <= C -> col index per row
    (-1 for a row left unassigned)."""
    cost = np.ascontiguousarray(cost, np.float64)
    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, np.int32)
    out[rows] = cols
    return out


class KalmanFilter:
    """Constant-velocity filter over (cx, cy, aspect, height) + velocities,
    with the standard DeepSORT noise heuristics (std proportional to h)."""

    def __init__(self):
        dt = 1.0
        self._F = np.eye(8)
        for i in range(4):
            self._F[i, 4 + i] = dt
        self._H = np.eye(4, 8)
        self._std_weight_pos = 1.0 / 20
        self._std_weight_vel = 1.0 / 160

    def initiate(self, xyah: np.ndarray):
        mean = np.zeros(8)
        mean[:4] = xyah
        h = xyah[3]
        std = np.array([
            2 * self._std_weight_pos * h, 2 * self._std_weight_pos * h,
            1e-2, 2 * self._std_weight_pos * h,
            10 * self._std_weight_vel * h, 10 * self._std_weight_vel * h,
            1e-5, 10 * self._std_weight_vel * h,
        ])
        return mean, np.diag(std ** 2)

    def predict(self, mean, cov):
        h = mean[3]
        q = np.array([
            self._std_weight_pos * h, self._std_weight_pos * h, 1e-2,
            self._std_weight_pos * h,
            self._std_weight_vel * h, self._std_weight_vel * h, 1e-5,
            self._std_weight_vel * h,
        ])
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + np.diag(q ** 2)
        return mean, cov

    def project(self, mean, cov):
        h = mean[3]
        r = np.array([
            self._std_weight_pos * h, self._std_weight_pos * h, 1e-1,
            self._std_weight_pos * h,
        ])
        m = self._H @ mean
        S = self._H @ cov @ self._H.T + np.diag(r ** 2)
        return m, S

    def update(self, mean, cov, xyah):
        m, S = self.project(mean, cov)
        K = cov @ self._H.T @ np.linalg.inv(S)
        innovation = xyah - m
        mean = mean + K @ innovation
        cov = (np.eye(8) - K @ self._H) @ cov
        return mean, cov

    def gating_distance(self, mean, cov, measurements: np.ndarray):
        m, S = self.project(mean, cov)
        d = measurements - m[None, :]
        Sinv = np.linalg.inv(S)
        return np.einsum("ni,ij,nj->n", d, Sinv, d)


def bbox_to_xyah(bbox: np.ndarray) -> np.ndarray:
    """(x, y, w, h) -> (cx, cy, aspect, h)."""
    x, y, w, h = bbox
    return np.array([x + w / 2, y + h / 2, w / max(h, 1e-6), h])


def xyah_to_bbox(xyah: np.ndarray) -> np.ndarray:
    cx, cy, a, h = xyah
    w = a * h
    return np.array([cx - w / 2, cy - h / 2, w, h])


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 4) xywh x (M, 4) xywh -> (N, M) IoU."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    ax0, ay0 = boxes_a[:, 0], boxes_a[:, 1]
    ax1, ay1 = ax0 + boxes_a[:, 2], ay0 + boxes_a[:, 3]
    bx0, by0 = boxes_b[:, 0], boxes_b[:, 1]
    bx1, by1 = bx0 + boxes_b[:, 2], by0 + boxes_b[:, 3]
    ix0 = np.maximum(ax0[:, None], bx0[None, :])
    iy0 = np.maximum(ay0[:, None], by0[None, :])
    ix1 = np.minimum(ax1[:, None], bx1[None, :])
    iy1 = np.minimum(ay1[:, None], by1[None, :])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


class TrackState:
    TENTATIVE = 0
    CONFIRMED = 1
    DELETED = 2


@dataclass
class SortTrack:
    track_id: int
    mean: np.ndarray
    cov: np.ndarray
    state: int = TrackState.TENTATIVE
    hits: int = 1
    age: int = 1
    time_since_update: int = 0
    features: List[np.ndarray] = field(default_factory=list)
    class_id: int = 0

    @property
    def bbox(self) -> np.ndarray:
        return xyah_to_bbox(self.mean[:4])


class DeepSort:
    """Track-by-detection with appearance + motion cascade matching."""

    def __init__(self, config: Optional[DetectorConfig] = None, embedder=None):
        self.cfg = config or DetectorConfig()
        self.kf = KalmanFilter()
        self.tracks: List[SortTrack] = []
        self._next_id = 0
        self.embedder = embedder  # callable(image, bboxes) -> (N, D) features

    # ------------------------------------------------------------------
    def _appearance_cost(self, features: np.ndarray, tracks: List[SortTrack]):
        """min cosine distance to each track's feature gallery."""
        cost = np.full((len(tracks), len(features)), INFTY_COST)
        for i, t in enumerate(tracks):
            if not t.features or len(features) == 0:
                continue
            gallery = np.stack(t.features[-self.cfg.nn_budget:])
            g = gallery / np.maximum(
                np.linalg.norm(gallery, axis=1, keepdims=True), 1e-9
            )
            f = features / np.maximum(
                np.linalg.norm(features, axis=1, keepdims=True), 1e-9
            )
            cost[i] = 1.0 - (g @ f.T).max(axis=0)
        return cost

    def _match(self, detections, features):
        det_boxes = np.array([d["bbox"] for d in detections]) if detections else np.zeros((0, 4))
        det_xyah = np.array([bbox_to_xyah(b) for b in det_boxes]) if len(det_boxes) else np.zeros((0, 4))

        confirmed = [i for i, t in enumerate(self.tracks) if t.state == TrackState.CONFIRMED]
        others = [i for i, t in enumerate(self.tracks) if t.state != TrackState.CONFIRMED]

        matches, unmatched_dets = [], list(range(len(detections)))
        unmatched_tracks = []

        # cascade: confirmed tracks by increasing time_since_update,
        # appearance cost with Mahalanobis gating
        if confirmed and len(detections):
            for depth in range(1, self.cfg.max_age + 1):
                level = [i for i in confirmed if self.tracks[i].time_since_update == depth]
                if not level or not unmatched_dets:
                    continue
                sub = [self.tracks[i] for i in level]
                feats = features[unmatched_dets] if features is not None else np.zeros((len(unmatched_dets), 1))
                cost = (
                    self._appearance_cost(feats, sub)
                    if features is not None
                    else 1.0 - iou_matrix(np.stack([t.bbox for t in sub]), det_boxes[unmatched_dets])
                )
                for r, ti in enumerate(level):
                    gd = self.kf.gating_distance(
                        self.tracks[ti].mean, self.tracks[ti].cov,
                        det_xyah[unmatched_dets],
                    )
                    cost[r, gd > GATING_THRESHOLD] = INFTY_COST
                    cost[r, cost[r] > self.cfg.max_cosine_distance] = INFTY_COST
                assign = hungarian(cost) if cost.shape[0] <= cost.shape[1] else None
                if assign is None:
                    pairs = [(c, r) for r, c in enumerate(hungarian(cost.T))]
                else:
                    pairs = list(enumerate(assign))
                for r, c in pairs:
                    if c >= 0 and cost[r, c] < INFTY_COST:
                        matches.append((level[r], unmatched_dets[c]))
                for ti, di in matches:
                    if di in unmatched_dets:
                        unmatched_dets.remove(di)
        matched_tracks = {m[0] for m in matches}
        unmatched_confirmed_recent = [
            i for i in confirmed
            if i not in matched_tracks and self.tracks[i].time_since_update == 1
        ]

        # IoU matching for tentative + recently-lost confirmed
        iou_candidates = others + unmatched_confirmed_recent
        if iou_candidates and unmatched_dets:
            t_boxes = np.stack([self.tracks[i].bbox for i in iou_candidates])
            cost = 1.0 - iou_matrix(t_boxes, det_boxes[unmatched_dets])
            cost[cost > self.cfg.max_iou_distance] = INFTY_COST
            assign = hungarian(cost) if cost.shape[0] <= cost.shape[1] else None
            if assign is None:
                pairs = [(c, r) for r, c in enumerate(hungarian(cost.T))]
            else:
                pairs = list(enumerate(assign))
            for r, c in pairs:
                if c >= 0 and cost[r, c] < INFTY_COST:
                    matches.append((iou_candidates[r], unmatched_dets[c]))
            for ti, di in matches:
                if di in unmatched_dets:
                    unmatched_dets.remove(di)

        matched_tracks = {m[0] for m in matches}
        unmatched_tracks = [
            i for i in range(len(self.tracks)) if i not in matched_tracks
        ]
        return matches, unmatched_tracks, unmatched_dets

    # ------------------------------------------------------------------
    def update(self, detections: List[dict], image: Optional[np.ndarray] = None):
        """detections: list of {bbox: (x,y,w,h), score, class_id}.
        Returns list of {track_id, bbox, class_id} for confirmed tracks.
        """
        for t in self.tracks:
            t.mean, t.cov = self.kf.predict(t.mean, t.cov)
            t.age += 1
            t.time_since_update += 1

        features = None
        if self.embedder is not None and image is not None and detections:
            features = np.asarray(
                self.embedder(image, np.array([d["bbox"] for d in detections]))
            )

        matches, unmatched_tracks, unmatched_dets = self._match(detections, features)

        for ti, di in matches:
            t = self.tracks[ti]
            t.mean, t.cov = self.kf.update(
                t.mean, t.cov, bbox_to_xyah(np.asarray(detections[di]["bbox"]))
            )
            t.hits += 1
            t.time_since_update = 0
            t.class_id = detections[di].get("class_id", t.class_id)
            if features is not None:
                t.features.append(features[di])
            if t.state == TrackState.TENTATIVE and t.hits >= self.cfg.n_init:
                t.state = TrackState.CONFIRMED

        for ti in unmatched_tracks:
            t = self.tracks[ti]
            if t.state == TrackState.TENTATIVE:
                t.state = TrackState.DELETED
            elif t.time_since_update > self.cfg.max_age:
                t.state = TrackState.DELETED

        for di in unmatched_dets:
            mean, cov = self.kf.initiate(bbox_to_xyah(np.asarray(detections[di]["bbox"])))
            tr = SortTrack(
                track_id=self._next_id, mean=mean, cov=cov,
                class_id=detections[di].get("class_id", 0),
            )
            if features is not None:
                tr.features.append(features[di])
            self.tracks.append(tr)
            self._next_id += 1

        self.tracks = [t for t in self.tracks if t.state != TrackState.DELETED]
        return [
            {"track_id": t.track_id, "bbox": t.bbox, "class_id": t.class_id}
            for t in self.tracks
            if t.state == TrackState.CONFIRMED and t.time_since_update == 0
        ]
