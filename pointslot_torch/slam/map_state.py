"""Host-side map storage: fixed-capacity SoA tables with free lists.

A copy of ``pointslot_tpu/slam/map_state.py`` (``MapState``): numpy tables
indexed by integer ids in place of the reference's pointer-graph Map /
KeyFrame / MapPoint classes. The covisibility graph is derived from the
observation incidence matrix. Descriptors stay (N, 8) uint32 here, as in
the reference; the solvers and matchers see int32 words on the device
(``convert.to_tensor`` reinterprets the bits).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MapState:
    max_kfs: int = 256
    max_points: int = 32768
    feats_per_kf: int = 1200

    # --- keyframes -----------------------------------------------------
    kf_pose: np.ndarray = None          # (K, 4, 4) T_cw
    kf_valid: np.ndarray = None         # (K,) bool
    kf_uid: np.ndarray = None           # (K,) int64 monotonic id (slots recycle)
    kf_frame_id: np.ndarray = None      # (K,) int64
    kf_xy: np.ndarray = None            # (K, N, 2) float32
    kf_level: np.ndarray = None         # (K, N) int32
    kf_desc: np.ndarray = None          # (K, N, 8) uint32
    kf_angle: np.ndarray = None         # (K, N) float32
    kf_depth: np.ndarray = None         # (K, N) float32 (-1 no stereo)
    kf_uright: np.ndarray = None        # (K, N) float32
    kf_feat_valid: np.ndarray = None    # (K, N) bool
    kf_point_idx: np.ndarray = None     # (K, N) int32 bound map point or -1
    # spanning-tree parent: the tracking reference KF at creation (the
    # reference's KeyFrame::mpParent analog; correction propagation to
    # keyframes created during a background GBA walks this chain,
    # src/LoopClosing.cc:686-745)
    kf_parent: np.ndarray = None        # (K,) int32, -1 = root/none

    # --- map points ----------------------------------------------------
    pt_pos: np.ndarray = None           # (M, 3) float64 world
    pt_desc: np.ndarray = None          # (M, 8) uint32 representative descriptor
    pt_valid: np.ndarray = None         # (M,) bool
    pt_normal: np.ndarray = None        # (M, 3) mean viewing direction
    pt_min_dist: np.ndarray = None      # (M,) scale-invariance range
    pt_max_dist: np.ndarray = None
    pt_first_kf: np.ndarray = None      # (M,) int32 creating keyframe
    pt_visible: np.ndarray = None       # (M,) int32 frames where in frustum
    pt_found: np.ndarray = None         # (M,) int32 frames where matched
    pt_dynamic: np.ndarray = None       # (M,) bool (mnDynamicFlag analog)

    # --- incidence: observation matrix (point x keyframe) ---------------
    obs: np.ndarray = None              # (M, K) bool

    def __post_init__(self):
        K, M, N = self.max_kfs, self.max_points, self.feats_per_kf
        self.kf_pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        self.kf_valid = np.zeros(K, bool)
        self.kf_uid = np.full(K, -1, np.int64)
        self.kf_frame_id = np.zeros(K, np.int64)
        self._next_uid = 0
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_depth = np.full((K, N), -1.0, np.float32)
        self.kf_uright = np.full((K, N), -1.0, np.float32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_point_idx = np.full((K, N), -1, np.int32)
        self.kf_parent = np.full(K, -1, np.int32)
        self.pt_pos = np.zeros((M, 3), np.float64)
        self.pt_desc = np.zeros((M, 8), np.uint32)
        self.pt_valid = np.zeros(M, bool)
        self.pt_normal = np.zeros((M, 3), np.float32)
        self.pt_min_dist = np.zeros(M, np.float32)
        self.pt_max_dist = np.zeros(M, np.float32)
        self.pt_first_kf = np.full(M, -1, np.int32)
        self.pt_visible = np.zeros(M, np.int32)
        self.pt_found = np.zeros(M, np.int32)
        self.pt_dynamic = np.zeros(M, bool)
        self.obs = np.zeros((M, K), bool)

    # ------------------------------------------------------------------
    def reset(self):
        """Clear everything (System/Tracking::Reset analog)."""
        self.__post_init__()

    def alloc_keyframe(self) -> int:
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            # table full: evict the least-connected keyframe, protecting
            # (a) the oldest (it anchors the gauge) and (b) the most recent
            # ones — fresh keyframes start with few covisibility links, and
            # evicting them collapses the live local map and loses tracking
            valid = self.keyframe_ids()
            oldest = valid[np.argmin(self.kf_frame_id[valid])]
            # protect at most so many recents that a candidate always remains
            n_protect = min(max(5, self.max_kfs // 8), max(len(valid) - 2, 0))
            recent = set(
                int(k) for k in valid[np.argsort(-self.kf_frame_id[valid])][:n_protect]
            )
            weights = [
                (int(self.covisibility_weights(int(k)).sum()), int(k))
                for k in valid if k != oldest and int(k) not in recent
            ]
            if not weights:   # tiny table: only the gauge anchor is safe
                weights = [
                    (int(self.covisibility_weights(int(k)).sum()), int(k))
                    for k in valid if k != oldest
                ]
            weights.sort()
            self.remove_keyframe(weights[0][1])
            free = np.nonzero(~self.kf_valid)[0]
        k = int(free[0])
        self.kf_valid[k] = True
        self.kf_uid[k] = self._next_uid
        self.kf_parent[k] = -1
        self._next_uid += 1
        return k

    def alloc_points(self, n: int) -> np.ndarray:
        """Allocate up to n point rows (fewer when the table is near full —
        callers must size their writes to the returned array).

        When ``pt_alloc_range`` is set (pipeline-stage partitioning,
        parallel/pipeline.py), allocation is confined to that arena so the
        two hosts never race on a row."""
        lo, hi = getattr(self, "pt_alloc_range", None) or (0, self.max_points)
        free = lo + np.nonzero(~self.pt_valid[lo:hi])[0][:n]
        self.pt_valid[free] = True
        return free

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def keyframe_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    # ------------------------------------------------------------------
    def bind(self, kf: int, feat_idx: np.ndarray, pt_idx: np.ndarray):
        """Associate features of keyframe kf with map points."""
        self.kf_point_idx[kf, feat_idx] = pt_idx
        self.obs[pt_idx, kf] = True

    def unbind_point(self, pt_idx: np.ndarray):
        """Remove points entirely (SetBadFlag analog)."""
        pt_idx = np.atleast_1d(pt_idx)
        if len(pt_idx) == 0:
            return
        self.pt_valid[pt_idx] = False
        kfs = np.nonzero(self.obs[pt_idx].any(axis=0))[0]
        for k in kfs:
            sel = np.isin(self.kf_point_idx[k], pt_idx)
            self.kf_point_idx[k, sel] = -1
        self.obs[pt_idx, :] = False

    def replace_point(self, src: int, dst: int):
        """Merge point src into dst (MapPoint::Replace analog, reference
        src/MapPoint.cc): every observation of src rebinds onto dst except
        in keyframes where dst is already observed, then src is dropped.
        Used by loop-closing fuse to collapse duplicate structure."""
        if src == dst or not self.pt_valid[src] or not self.pt_valid[dst]:
            return
        for k in np.nonzero(self.obs[src])[0]:
            feats = np.nonzero(self.kf_point_idx[k] == src)[0]
            if self.obs[dst, k]:
                self.kf_point_idx[k, feats] = -1
            else:
                self.kf_point_idx[k, feats] = dst
                self.obs[dst, k] = True
        self.pt_found[dst] += self.pt_found[src]
        self.pt_visible[dst] += self.pt_visible[src]
        self.obs[src, :] = False
        self.pt_valid[src] = False

    def remove_keyframe(self, kf: int):
        if getattr(self, "on_remove_keyframe", None):
            self.on_remove_keyframe(kf)
        pts = self.kf_point_idx[kf]
        bound = pts[pts >= 0]
        self.obs[bound, kf] = False
        self.kf_point_idx[kf, :] = -1
        self.kf_feat_valid[kf, :] = False
        self.kf_valid[kf] = False
        # re-hang children on the removed KF's own parent (the reference's
        # ChangeParent walk in KeyFrame::SetBadFlag)
        self.kf_parent[self.kf_parent == kf] = self.kf_parent[kf]
        self.kf_parent[kf] = -1
        # cull points that lost all observations
        orphan = bound[~self.obs[bound].any(axis=1)]
        if len(orphan):
            self.pt_valid[orphan] = False

    # ------------------------------------------------------------------
    def covisibility_weights(self, kf: int) -> np.ndarray:
        """(K,) number of map points shared with keyframe kf."""
        pts = self.kf_point_idx[kf]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return np.zeros(self.max_kfs, np.int32)
        w = self.obs[pts].sum(axis=0).astype(np.int32)
        w[kf] = 0
        w[~self.kf_valid] = 0
        return w

    def covisible_keyframes(self, kf: int, min_weight: int = 15,
                            max_n: Optional[int] = None) -> np.ndarray:
        w = self.covisibility_weights(kf)
        ids = np.nonzero(w >= min_weight)[0]
        order = np.argsort(-w[ids])
        ids = ids[order]
        if max_n is not None:
            ids = ids[:max_n]
        return ids

    def point_obs_count(self) -> np.ndarray:
        return self.obs.sum(axis=1).astype(np.int32)

    # ------------------------------------------------------------------
    def points_of_keyframes(self, kf_ids) -> np.ndarray:
        """Unique valid map points observed by the given keyframes."""
        idx = self.kf_point_idx[kf_ids].reshape(-1)
        idx = np.unique(idx[idx >= 0])
        return idx[self.pt_valid[idx]]

    def update_point_stats(self, pt_idx: np.ndarray):
        """Refresh representative descriptor + normal/depth range from
        observations (MapPoint::ComputeDistinctiveDescriptors /
        UpdateNormalAndDepth analog, batched)."""
        for p in np.atleast_1d(pt_idx):
            kfs = np.nonzero(self.obs[p])[0]
            if len(kfs) == 0:
                continue
            descs, dirs, dists, levels = [], [], [], []
            for k in kfs:
                f = np.nonzero(self.kf_point_idx[k] == p)[0]
                if len(f) == 0:
                    continue
                f = f[0]
                descs.append(self.kf_desc[k, f])
                T = self.kf_pose[k]
                cam_center = -T[:3, :3].T @ T[:3, 3]
                d = self.pt_pos[p] - cam_center
                dirs.append(d / max(np.linalg.norm(d), 1e-9))
                dists.append(np.linalg.norm(d))
                levels.append(self.kf_level[k, f])
            if not descs:
                continue
            D = np.stack(descs)
            bits = np.unpackbits(D.view(np.uint8), axis=1)
            ham = (bits[:, None, :] != bits[None, :, :]).sum(-1)
            self.pt_desc[p] = D[np.argmin(np.median(ham, axis=1))]
            self.pt_normal[p] = np.mean(dirs, axis=0)
            # scale range from the last observation's level
            scale = 1.2 ** levels[-1]
            self.pt_max_dist[p] = dists[-1] * scale
            self.pt_min_dist[p] = self.pt_max_dist[p] / (1.2 ** 7)

    def predict_scale(self, dists: np.ndarray, pt_idx: np.ndarray) -> np.ndarray:
        """Predicted octave from distance ratio (MapPoint::PredictScale)."""
        ratio = self.pt_max_dist[pt_idx] / np.maximum(dists, 1e-9)
        lvl = np.ceil(np.log(np.maximum(ratio, 1e-9)) / np.log(1.2)).astype(np.int32)
        return np.clip(lvl, 0, 7)
