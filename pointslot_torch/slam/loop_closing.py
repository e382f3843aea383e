"""Loop detection, geometric verification, loop correction, global BA and
relocalization.

Port of ``pointslot_tpu/slam/loop_closing.py``: ``KeyFrameDatabase`` and
``make_database`` (the reference's KeyFrameDatabase, src/KeyFrameDatabase.cc,
the dense representation), ``LoopCloser`` (the LoopClosing thread,
src/LoopClosing.cc: DetectLoop :106 with 3-consistent covisibility groups,
ComputeSim3 :234 as a 3D-3D RANSAC + IRLS refine, CorrectLoop :405 with
pose propagation, SearchAndFuse and the essential graph, then the global
BA of :648 on its own thread) and ``Relocalizer`` (Tracking::
Relocalization, src/Tracking.cc:3502-3663: BoW candidates, brute match,
PnP RANSAC).

The control flow, the database queries and the map edits are the
reference's host numpy, copied; the device work (word assignment,
``brute_match``, the batched RANSACs, the pose graph, ``project_and_match``
and the global BA) runs on ``device`` (the card by default), each step's
results coming back in one transfer. The RANSACs' minimal sets are drawn
from a ``torch.Generator`` seeded with the reference's key integer (the
keyframe slot for a loop, the frame id for a relocalization) by the
``draw_index_sets`` attribute, which the tests replace with JAX's own
draws. The port passes real point counts where the reference pads to
powers of two (padded rows match nothing and are never drawn).

The global BA's solve runs, when ``LoopConfig.background_gba``, on a thread
of its own without the map lock, on a CUDA stream of its own; its results
are on the host before the merge takes the lock. A failure there is
recorded and raised by ``wait_for_gba``. A newer loop does not wait for a
superseded solve (the reference waits for it under the map lock, which
that solve's merge needs); the superseded merge is dropped by its epoch.

A tree vocabulary (vocab/tree.py) gets the sparse inverted-index
database; the flat one the dense database. Not ported: the mesh branches
of the essential graph and the global BA (ROADMAP item 15).
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from typing import List, Optional, Set

import numpy as np
import torch

from pointslot_torch.config import SystemConfig
from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.geometry import pnp
from pointslot_torch.slam import matchers
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.solvers import local_ba, posegraph
from pointslot_torch.utils.profiling import PROFILER
from pointslot_torch.vocab.bow import BinaryVocabulary
from pointslot_torch.vocab.tree import SparseKeyFrameDatabase, TreeVocabulary

MATCH_CAP = 512      # correspondences a RANSAC takes, the first ones


def _next_pow2(n: int, lo: int, hi: int) -> int:
    p = lo
    while p < min(n, hi):
        p *= 2
    return p


class KeyFrameDatabase:
    """Dense BoW database over the keyframe table (a whole-database query is
    one matvec): host (K, W) tf-idf rows, filled by the vocabulary's
    device transform."""

    def __init__(self, vocab: BinaryVocabulary, max_kfs: int):
        self.vocab = vocab
        self.vectors = np.zeros((max_kfs, vocab.n_words), np.float32)
        self.present = np.zeros(max_kfs, bool)

    def transform(self, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
        vec, _ = self.vocab.transform(desc, valid)
        return vec

    def add(self, kf: int, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
        self.vectors[kf] = self.transform(desc, valid)
        self.present[kf] = True
        return self.vectors[kf]

    def remove(self, kf: int):
        self.present[kf] = False

    def clear(self):
        self.present[:] = False

    def pair_score(self, kf: int, vec: np.ndarray) -> float:
        if not self.present[kf]:
            return -1.0
        return float(1.0 - 0.5 * np.abs(self.vectors[kf] - vec).sum())

    def query(self, vec: np.ndarray, exclude: Set[int], min_score: float) -> List[int]:
        scores = 1.0 - 0.5 * np.abs(self.vectors - vec[None, :]).sum(axis=1)
        scores[~self.present] = -1.0
        for k in exclude:
            if 0 <= k < len(scores):
                scores[k] = -1.0
        ids = np.nonzero(scores >= min_score)[0]
        return list(ids[np.argsort(-scores[ids])])


def make_database(vocab, max_kfs: int):
    """The database for `vocab`: the dense (K, W) tf-idf matrix for a flat
    vocabulary, the sparse inverted index for a tree vocabulary (bounded
    memory at ORBvoc's ~1M words; the reference's KeyFrameDatabase design,
    src/KeyFrameDatabase.cc). Both answer transform, add, remove, clear,
    pair_score and query."""
    if isinstance(vocab, TreeVocabulary):
        return SparseKeyFrameDatabase(vocab, max_kfs)
    return KeyFrameDatabase(vocab, max_kfs)


def gba_pregate(prob: local_ba.BAProblem, cam: dict) -> local_ba.BAProblem:
    """The global BA's pre-gate: drop grossly-inconsistent observations
    (wrong associations made while the map was drifted: chi2 over 10x its
    gate, or behind the camera) at the corrected state BEFORE optimizing,
    so the robust stage starts clean."""
    one = local_ba.stack_problems([prob])     # the solver's problem axis
    res, behind = local_ba._residuals_only(prob.poses[None], prob.points[None], one, **cam)
    chi2 = local_ba._chi2(res[0], prob.obs_stereo, prob.obs_inv_sigma2)
    gate = torch.where(prob.obs_stereo, local_ba.CHI2_STEREO, local_ba.CHI2_MONO) * 10.0
    return prob._replace(obs_valid=prob.obs_valid & (chi2 <= gate) & ~behind[0])


class LoopCloser:
    def __init__(self, config: SystemConfig, map_state: MapState,
                 vocab: BinaryVocabulary, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.map = map_state
        self.vocab = vocab
        self.db = make_database(vocab, map_state.max_kfs)
        self._consistent_groups: List[tuple] = []  # (set_of_kfs, count)
        self.loops_closed = 0
        self.last_loop_kf = -10 ** 9
        self.on_loop_closed = None  # callback(corrections dict)
        self.last_gba_stats = None  # set by the GBA merge-back
        # the RANSAC's minimal sets: (valid (N,) bool, H, m, seed) -> (H, m)
        self.draw_index_sets = pnp.draw_index_sets
        # background global BA (the reference's detached thread + abort
        # flag, src/LoopClosing.cc:648-752 mbStopGBA/mnFullBAIdx): the
        # solve runs WITHOUT the map lock; the merge-back re-takes it and
        # is discarded if the epoch moved (a newer loop/reset superseded it)
        self.map_lock = threading.RLock()  # System replaces with its lock
        self._gba_threads: List[threading.Thread] = []
        self._gba_threads_lock = threading.Lock()   # launches vs wait_for_gba
        self._gba_epoch = 0
        # what the background GBA failed on, raised by wait_for_gba
        self.gba_errors: List[Exception] = []
        self._gba_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        cam = config.camera
        self._cam_args = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                              cy=float(cam.cy), bf=float(cam.bf))
        self._scales = np.asarray(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)], np.float32)
        self._scales_dev = torch.from_numpy(self._scales).to(self.device)

    # ------------------------------------------------------------------
    def on_keyframe(self, kf: int) -> bool:
        """Add to database; attempt detection + correction. Returns True if
        a loop was closed."""
        m = self.map
        lc = self.cfg.loop
        vec = self.db.add(kf, m.kf_desc[kf], m.kf_feat_valid[kf])
        if not lc.enabled:
            return False
        if (m.n_keyframes() < lc.min_kfs_before_detect
                or kf - self.last_loop_kf < lc.cooldown_kfs):
            return False

        candidate = self._detect_loop(kf, vec)
        if candidate is None:
            return False
        ok, T_lc = self._geometric_verification(kf, candidate)
        if not ok:
            return False
        self._correct_loop(kf, candidate, T_lc)
        self.loops_closed += 1
        self.last_loop_kf = kf
        return True

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int, vec: np.ndarray) -> Optional[int]:
        m = self.map
        lc = self.cfg.loop
        neighbors = m.covisible_keyframes(kf, min_weight=15)
        if len(neighbors) == 0:
            return None
        # min similarity to the covisible neighborhood sets the query floor
        neigh_scores = [self.db.pair_score(n, vec) for n in neighbors]
        min_score = max(min(neigh_scores), 0.0)
        exclude = set(int(n) for n in neighbors) | {kf}
        candidates = self.db.query(vec, exclude, min_score)
        # drop candidates too recent in time (KITTI: avoid adjacent frames)
        candidates = [
            c for c in candidates
            if abs(int(m.kf_frame_id[c]) - int(m.kf_frame_id[kf]))
            > lc.min_frame_distance
        ]
        if not candidates:
            self._consistent_groups = []
            return None

        # covisibility-consistency across consecutive detections (the
        # reference requires 3 consecutive consistent detections); a group is
        # the candidate + its covisible neighborhood and its two neighbours
        # in time, and its count is the best chain it extends
        confirmed = None
        new_groups = []
        by_time = sorted(m.keyframe_ids(), key=lambda k: m.kf_frame_id[k])
        pos = {int(k): i for i, k in enumerate(by_time)}
        for c in candidates[: lc.max_candidates]:
            group = set(int(x) for x in m.covisible_keyframes(c, min_weight=5))
            group.add(int(c))
            i = pos.get(int(c))
            if i is not None:
                for j in (i - 1, i + 1):
                    if 0 <= j < len(by_time):
                        group.add(int(by_time[j]))
            count = 0
            for prev_group, prev_count in self._consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count + 1 >= lc.covisibility_consistency_th and confirmed is None:
                confirmed = int(c)
        self._consistent_groups = new_groups
        return confirmed

    # ------------------------------------------------------------------
    def _unproject(self, k: int, feats: np.ndarray) -> np.ndarray:
        m, cam = self.map, self.cfg.camera
        z = m.kf_depth[k, feats]
        x = (m.kf_xy[k, feats, 0] - cam.cx) * z / cam.fx
        y = (m.kf_xy[k, feats, 1] - cam.cy) * z / cam.fy
        return np.stack([x, y, z], axis=1)

    def _geometric_verification(self, kf: int, cand: int):
        """Brute descriptor match + stereo-unprojected 3D-3D RANSAC,
        followed by inlier-weighted IRLS refinement (the reference's
        OptimizeSim3 role, src/Optimizer.cc:1684). Returns (ok, T_lc) with
        X_cand = T_lc @ X_cur (camera frames)."""
        m, d = self.map, self.device
        res = matchers.brute_match(
            to_tensor(m.kf_desc[kf], torch.int32, d), to_tensor(m.kf_angle[kf], None, d),
            to_tensor(m.kf_feat_valid[kf] & (m.kf_depth[kf] > 0), None, d),
            to_tensor(m.kf_desc[cand], torch.int32, d), to_tensor(m.kf_angle[cand], None, d),
            to_tensor(m.kf_feat_valid[cand] & (m.kf_depth[cand] > 0), None, d),
            nn_ratio=0.75, th_desc=matchers.TH_LOW, check_rotation=True,
        )
        idx, = host(res.idx_b_for_a)
        sel = np.nonzero(idx >= 0)[0]
        lc = self.cfg.loop
        if len(sel) < lc.min_sim3_inliers:
            return False, None
        sel = sel[:MATCH_CAP]
        src = self._unproject(kf, sel)                # current cam frame
        dst = self._unproject(cand, idx[sel])         # candidate cam frame
        valid = np.ones(len(sel), bool)
        draws = self.draw_index_sets(valid, lc.sim3_ransac_iters, 3, kf)
        src_d, dst_d = to_tensor(src, torch.float32, d), to_tensor(dst, torch.float32, d)
        valid_d = to_tensor(valid, None, d)
        result = pnp.rigid_ransac(src_d, dst_d, valid_d, to_tensor(draws, None, d),
                                  inlier_threshold=0.4, with_scale=not lc.fix_scale,
                                  min_inliers=lc.min_sim3_inliers)
        # IRLS refinement on the inlier set (used only when RANSAC is ok)
        T_ref = pnp.rigid_refine(src_d, dst_d, result.inliers, result.T, huber_delta=0.15,
                                 n_iters=lc.refine_transform_iters,
                                 with_scale=not lc.fix_scale)
        ok, T_ref = host(result.ok, T_ref)
        if not bool(ok):
            return False, None
        return True, T_ref.astype(np.float64)

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, cand: int, T_lc: np.ndarray):
        """Essential-graph optimization with the loop constraint; map points
        move with their reference keyframes; duplicate structure across the
        loop is merged before global BA."""
        m = self.map
        kf_ids = m.keyframe_ids()
        row = {int(k): i for i, k in enumerate(kf_ids)}
        old_poses = m.kf_pose[kf_ids].astype(np.float64).copy()

        e_i, e_j, meas, weight = [], [], [], []
        # sequential (spanning-tree analog) edges in frame order
        order = np.argsort(m.kf_frame_id[kf_ids])
        seq = [int(kf_ids[o]) for o in order]
        for a, b in zip(seq[1:], seq[:-1]):
            e_i.append(row[a]); e_j.append(row[b])
            meas.append(m.kf_pose[a].astype(np.float64) @ np.linalg.inv(m.kf_pose[b]))
            weight.append(1.0)
        # strong covisibility edges
        for k in kf_ids:
            for c in m.covisible_keyframes(int(k), min_weight=100):
                if int(c) > int(k):
                    e_i.append(row[int(k)]); e_j.append(row[int(c)])
                    meas.append(
                        m.kf_pose[int(k)].astype(np.float64)
                        @ np.linalg.inv(m.kf_pose[int(c)])
                    )
                    weight.append(1.0)
        # the loop edge: corrected T_cur = inv(T_lc) @ T_cand
        e_i.append(row[kf]); e_j.append(row[cand])
        meas.append(np.linalg.inv(T_lc))
        weight.append(20.0)

        new_poses = self._optimize_essential_graph(
            old_poses, kf_ids == cand, e_i, e_j, meas, weight
        )

        # move map points with their reference keyframe's correction
        # (vectorized — runs under the map lock)
        corrections = {}
        for i, k in enumerate(kf_ids):
            corrections[int(k)] = (old_poses[i], new_poses[i])
            m.kf_pose[int(k)] = new_poses[i].astype(np.float32)
        A = np.einsum("kij,kjl->kil", np.linalg.inv(new_poses), old_poses)
        row_of_slot = np.full(m.max_kfs, -1, np.int64)
        for k, i in row.items():
            row_of_slot[k] = i
        pts = np.nonzero(m.pt_valid)[0]
        if len(pts):
            ref = m.pt_first_kf[pts]
            rows_p = np.where(ref >= 0, row_of_slot[np.maximum(ref, 0)], -1)
            for j in np.nonzero(rows_p < 0)[0]:
                obs_kfs = np.nonzero(m.obs[pts[j]])[0]
                if len(obs_kfs):
                    rows_p[j] = row_of_slot[int(obs_kfs[0])]
            sel = rows_p >= 0
            rp, rr = pts[sel], rows_p[sel]
            X = m.pt_pos[rp]
            m.pt_pos[rp] = (
                np.einsum("rij,rj->ri", A[rr, :3, :3], X) + A[rr, :3, 3]
            )

        # merge duplicate structure across the loop (SearchAndFuse analog,
        # reference src/LoopClosing.cc:590) so global BA ties the loop
        # together instead of keeping two copies of the revisited scene
        self._search_and_fuse(kf, cand)

        if self.cfg.loop.run_global_ba:
            self._launch_global_ba(cand)

        if self.on_loop_closed:
            self.on_loop_closed(corrections)

    # ------------------------------------------------------------------
    def _launch_global_ba(self, fixed_kf: int):
        """Run the full-map BA off the tracking critical path (reference
        LoopClosing::RunGlobalBundleAdjustment detached thread,
        src/LoopClosing.cc:648). The snapshot is taken under the map lock;
        the LM solve runs lock-free on a background thread and its own
        stream; the merge-back re-takes the lock with uid staleness guards
        and is discarded if a newer loop closure/reset bumped the epoch
        (the mnFullBAIdx check)."""
        self._gba_epoch += 1
        snap = self._gba_snapshot(fixed_kf)
        if snap is None:
            return
        if not self.cfg.loop.background_gba:
            self._gba_run(snap, self._gba_epoch)
            return
        # a superseded solve is not waited for here: this runs under the
        # map lock, which that solve's merge takes (the reference waits,
        # and would deadlock); its merge sees the new epoch and is dropped
        if self._gba_stream is not None:
            # the snapshot was uploaded on this thread's stream
            self._gba_stream.wait_stream(torch.cuda.current_stream(self.device))
        t = threading.Thread(target=self._gba_thread_main, args=(snap, self._gba_epoch),
                             daemon=True)
        with self._gba_threads_lock:
            self._gba_threads = [x for x in self._gba_threads if x.is_alive()] + [t]
        t.start()

    def _gba_thread_main(self, snap, epoch: int):
        """The background GBA: the solve on the loop closer's own stream."""
        try:
            with (torch.cuda.stream(self._gba_stream) if self._gba_stream is not None
                  else contextlib.nullcontext()):
                self._gba_run(snap, epoch)
        except Exception as e:
            traceback.print_exc()
            self.gba_errors.append(e)

    def _gba_run(self, snap, epoch: int):
        result, stats = self._gba_solve(snap)
        with self.map_lock:
            if epoch != self._gba_epoch:
                PROFILER.count("gba_aborted")
                return
            self._gba_merge(snap, result)
            self.last_gba_stats = stats

    @property
    def gba_running(self) -> bool:
        """A background GBA is solving or merging."""
        with self._gba_threads_lock:
            return any(t.is_alive() for t in self._gba_threads)

    def wait_for_gba(self, timeout: Optional[float] = None):
        """Block until every background GBA has merged or been discarded;
        raise if one failed."""
        with self._gba_threads_lock:
            threads = list(self._gba_threads)
        for t in threads:
            t.join(timeout)
        with self._gba_threads_lock:
            self._gba_threads = [t for t in self._gba_threads if t.is_alive()]
        if self.gba_errors:
            raise RuntimeError(
                f"global BA failed {len(self.gba_errors)} time(s) on its thread"
            ) from self.gba_errors[0]

    def abort_gba(self):
        """Invalidate any in-flight global BA (map reset / superseding
        event) — its merge-back will be discarded."""
        self._gba_epoch += 1

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, old_poses, fixed_mask,
                                  e_i, e_j, meas, weight) -> np.ndarray:
        """Dense GN pose graph on the loop closer's device (the mesh branch
        is ROADMAP item 15)."""
        K = len(old_poses)
        E = len(e_i)
        d = self.device
        prob = posegraph.PoseGraphProblem(
            poses=to_tensor(old_poses, torch.float32, d),
            fixed=to_tensor(np.asarray(fixed_mask), torch.bool, d),
            valid=torch.ones(K, dtype=torch.bool, device=d),
            e_i=to_tensor(np.asarray(e_i, np.int64), None, d),
            e_j=to_tensor(np.asarray(e_j, np.int64), None, d),
            e_meas=to_tensor(np.stack(meas), torch.float32, d),
            e_weight=to_tensor(np.asarray(weight, np.float32), None, d),
            e_valid=torch.ones(E, dtype=torch.bool, device=d),
        )
        out, = host(posegraph.optimize_pose_graph(
            prob, n_iters=self.cfg.loop.pose_graph_cg_iters // 5))
        return out.astype(np.float64)

    # ------------------------------------------------------------------
    def _search_and_fuse(self, kf: int, cand: int):
        """Project the loop side's map points into the current side's
        keyframes (at their corrected poses) and merge matches: features
        bound to a different point have that point replaced by the loop
        point; unbound features gain a binding."""
        m, d = self.map, self.device
        cam = self.cfg.camera
        loop_kfs = [cand] + [int(c) for c in m.covisible_keyframes(cand, min_weight=15)]
        cur_kfs = [kf] + [int(c) for c in m.covisible_keyframes(kf, min_weight=15)]
        loop_pts = m.points_of_keyframes(loop_kfs)
        if len(loop_pts) == 0:
            return
        merged = 0
        for k in cur_kfs:
            # per-point predicted octave from viewing distance (the same
            # scale prediction tracking and neighbor-fuse use)
            T = m.kf_pose[k]
            cam_center = -T[:3, :3].T @ T[:3, 3]
            dists = np.linalg.norm(m.pt_pos[loop_pts] - cam_center, axis=1)
            pred_level = m.predict_scale(dists, loop_pts)
            res = matchers.project_and_match(
                to_tensor(m.pt_pos[loop_pts].astype(np.float32), None, d)[None],
                to_tensor(m.pt_desc[loop_pts], torch.int32, d)[None],
                to_tensor(m.pt_valid[loop_pts], None, d)[None],
                to_tensor(m.kf_pose[k], torch.float32, d)[None],
                to_tensor(m.kf_xy[k], torch.float32, d),
                to_tensor(m.kf_level[k], torch.int32, d),
                to_tensor(m.kf_desc[k], torch.int32, d),
                to_tensor(m.kf_feat_valid[k], None, d),
                8.0, self._scales_dev,
                to_tensor(pred_level.astype(np.int32), None, d)[None],
                fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
                width=cam.width, height=cam.height,
                th_desc=matchers.TH_LOW, level_window=2,
            )
            pf, = host(res.point_for_feature[0])
            for f in np.nonzero(pf >= 0)[0]:
                dst = int(loop_pts[pf[f]])
                cur = int(m.kf_point_idx[k, f])
                if cur < 0:
                    m.bind(k, np.asarray([f]), np.asarray([dst]))
                elif cur != dst:
                    m.replace_point(cur, dst)
                    merged += 1
        PROFILER.count("loop_points_merged", merged)

    # ------------------------------------------------------------------
    def _gba_snapshot(self, fixed_kf: int) -> Optional[dict]:
        """Pack the full-map BA problem from the current map state (runs
        under the map lock; array packing and one upload). ALL keyframes
        participate; structure is capped at loop.gba_max_points
        well-observed points (the rest are corrected at merge time by their
        reference keyframe's pose delta). The point rows are the real count
        (the reference pads them to a power of two of at least 1024)."""
        m = self.map
        lc = self.cfg.loop
        kf_ids = list(m.keyframe_ids())
        P_cap = _next_pow2(len(kf_ids), 16, m.max_kfs)
        kf_row = {int(k): i for i, k in enumerate(kf_ids)}

        # structure selection: prefer well-observed points
        pts_all = np.nonzero(m.pt_valid)[0]
        if len(pts_all) == 0:
            return None
        obs_count = m.point_obs_count()[pts_all]
        if len(pts_all) > lc.gba_max_points:
            keep = np.argsort(-obs_count)[: lc.gba_max_points]
            PROFILER.count("gba_points_propagated_only",
                           len(pts_all) - lc.gba_max_points)
            pts = np.sort(pts_all[keep])
        else:
            pts = pts_all
        pt_row = np.full(m.max_points, -1, np.int64)
        pt_row[pts] = np.arange(len(pts))

        e_pose, e_point, e_obs, e_stereo, e_inv2 = [], [], [], [], []
        for k in kf_ids:
            bound = np.nonzero(m.kf_point_idx[k] >= 0)[0]
            p_idx = m.kf_point_idx[k, bound]
            sel = pt_row[p_idx] >= 0
            bound, p_idx = bound[sel], p_idx[sel]
            e_pose.append(np.full(len(bound), kf_row[int(k)]))
            e_point.append(pt_row[p_idx])
            e_obs.append(np.stack(
                [m.kf_xy[k, bound, 0], m.kf_xy[k, bound, 1],
                 m.kf_uright[k, bound]], axis=1))
            e_stereo.append(m.kf_depth[k, bound] > 0)
            e_inv2.append(1.0 / self._scales[m.kf_level[k, bound]] ** 2)
        e_pose = np.concatenate(e_pose)
        e_point = np.concatenate(e_point)
        e_obs = np.concatenate(e_obs)
        e_stereo = np.concatenate(e_stereo)
        e_inv2 = np.concatenate(e_inv2)
        if len(e_pose) < 100:
            return None

        fixed_flags = [int(k) == int(fixed_kf) for k in kf_ids]
        if not any(fixed_flags):
            fixed_flags[0] = True

        prob, _ = local_ba.build_problem(
            poses=m.kf_pose[kf_ids].astype(np.float32),
            pose_fixed=np.asarray(fixed_flags),
            points=m.pt_pos[pts].astype(np.float32),
            e_pose=e_pose, e_point=e_point, e_obs=e_obs, e_stereo=e_stereo,
            e_inv_sigma2=e_inv2,
            P_cap=P_cap, L_cap=len(pts), K=lc.gba_obs_per_point, device=self.device,
        )
        return dict(
            prob=prob, kf_ids=kf_ids, kf_row=kf_row,
            fixed_flags=fixed_flags,
            kf_uid=m.kf_uid[kf_ids].copy(),
            old_kf_poses=m.kf_pose[kf_ids].astype(np.float64).copy(),
            pts=pts, pt_first_kf=m.pt_first_kf[pts].copy(),
            n_kfs=len(kf_ids),
        )

    def _gba_solve(self, snap: dict):
        """The expensive LM solve: touches ONLY the snapshot (no map state,
        no lock). Returns (BAResult on the host, stats)."""
        cam = self._cam_args
        prob = gba_pregate(snap["prob"], cam)
        result = local_ba.bundle_adjust(prob, **cam)

        # structure-level improvement for observability/tests: robust cost
        # of the SAME observation set before vs after the joint solve
        one = local_ba.stack_problems([prob])         # the solver's problem axis
        delta2 = torch.where(prob.obs_stereo, local_ba.CHI2_STEREO, local_ba.CHI2_MONO)

        def cost(poses, points):
            res = local_ba._residuals_only(poses[None], points[None], one, **cam)[0][0]
            chi2 = local_ba._chi2(res, prob.obs_stereo, prob.obs_inv_sigma2)
            return torch.where(prob.obs_valid, local_ba._robust_cost(chi2, delta2),
                               torch.zeros_like(chi2)).sum()

        cost_before = cost(prob.poses, prob.points)
        cost_after = cost(result.poses, result.points)
        out = host(*result, cost_before, cost_after, prob.obs_valid.sum())
        stats = {
            "cost_before": float(out[4]),
            "cost_after": float(out[5]),
            "n_obs": int(out[6]),
            "n_kfs": snap["n_kfs"],
            "n_points": len(snap["pts"]),
        }
        return local_ba.BAResult(*out[:4]), stats

    def _gba_merge(self, snap: dict, result):
        """Write the GBA result back under the map lock. The map may have
        moved on during the solve (keyframes culled + slots recycled, points
        culled, new keyframes/points created) — the reference handles the
        same window with uid/spanning-tree propagation (src/LoopClosing.cc:
        686-745). Guards: keyframe slots are verified by uid; point slots by
        first-keyframe identity; keyframes created DURING the solve are
        corrected by their spanning-tree ancestor's delta (nearest frame id
        when the chain never reaches a solved keyframe), and non-solved
        points ride their reference keyframe's delta."""
        m = self.map
        kf_ids = snap["kf_ids"]
        kf_row = snap["kf_row"]
        fixed_flags = snap["fixed_flags"]
        old_kf_poses = snap["old_kf_poses"]
        pts = snap["pts"]

        new_poses = np.asarray(result.poses, np.float64)
        live = np.zeros(len(kf_ids), bool)
        for i, k in enumerate(kf_ids):
            if m.kf_uid[int(k)] != snap["kf_uid"][i]:
                continue  # slot recycled during the solve
            live[i] = True
            if not fixed_flags[i]:
                m.kf_pose[int(k)] = new_poses[i].astype(np.float32)

        # keyframes created during the solve: propagate the correction
        # through the spanning tree (T_k' = (T_k T_parent^-1) T_parent_gba)
        solved_set = {int(k) for i, k in enumerate(kf_ids) if live[i]}
        solved_fids = {int(k): int(m.kf_frame_id[int(k)]) for k in solved_set}

        def _solved_ancestor(k: int):
            seen = set()
            p = int(m.kf_parent[k])
            while p >= 0 and p not in seen:
                if p in solved_set:
                    return p
                seen.add(p)
                p = int(m.kf_parent[p])
            return None

        for k in m.keyframe_ids():
            k = int(k)
            if k in solved_set or not solved_set:
                continue
            ref = _solved_ancestor(k)
            if ref is None:
                fid = int(m.kf_frame_id[k])
                ref = min(solved_set, key=lambda s: abs(solved_fids[s] - fid))
            i = kf_row[ref]
            if fixed_flags[i]:
                continue
            T_rel = m.kf_pose[k].astype(np.float64) @ np.linalg.inv(
                old_kf_poses[i])
            m.kf_pose[k] = (T_rel @ new_poses[i]).astype(np.float32)

        # solved points: write back where the slot still holds that point
        ok = m.pt_valid[pts] & (m.pt_first_kf[pts] == snap["pt_first_kf"])
        m.pt_pos[pts[ok]] = np.asarray(result.points, np.float64)[: len(pts)][ok]

        # propagate the GBA pose deltas to points that were not in the solve
        # (vectorized — this runs under the map lock)
        in_solve = np.zeros(m.max_points, bool)
        in_solve[pts[ok]] = True
        rest = np.nonzero(m.pt_valid & ~in_solve)[0]
        if len(rest):
            # per-solved-KF correction: p' = inv(T_new) @ T_old @ p
            A = np.empty((len(kf_ids), 4, 4))
            for i in range(len(kf_ids)):
                T_old = old_kf_poses[i]
                T_new = new_poses[i] if not fixed_flags[i] else T_old
                A[i] = np.linalg.inv(T_new) @ T_old
            row_of_slot = np.full(m.max_kfs, -1, np.int64)
            for k, i in kf_row.items():
                if live[i]:
                    row_of_slot[k] = i
            ref = m.pt_first_kf[rest]
            rows = np.where(ref >= 0, row_of_slot[np.maximum(ref, 0)], -1)
            # fallback (rare): reference keyframe gone — first live observer
            for j in np.nonzero(rows < 0)[0]:
                for c in np.nonzero(m.obs[rest[j]])[0]:
                    if row_of_slot[int(c)] >= 0:
                        rows[j] = row_of_slot[int(c)]
                        break
            sel = rows >= 0
            rp, rr = rest[sel], rows[sel]
            X = m.pt_pos[rp]
            m.pt_pos[rp] = (
                np.einsum("rij,rj->ri", A[rr, :3, :3], X) + A[rr, :3, 3]
            )


class Relocalizer:
    """BoW candidate search + PnP-RANSAC recovery from LOST
    (reference Tracking::Relocalization src/Tracking.cc:3502-3663)."""

    def __init__(self, config: SystemConfig, map_state: MapState,
                 db: KeyFrameDatabase, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.map = map_state
        self.db = db
        # the RANSAC's minimal sets: (valid (N,) bool, H, m, seed) -> (H, m)
        self.draw_index_sets = pnp.draw_index_sets

    def relocalize(self, frame) -> bool:
        m, d = self.map, self.device
        lc = self.cfg.loop
        vec = self.db.transform(frame.desc, frame.valid)
        candidates = self.db.query(
            vec, set(), min_score=lc.reloc_min_score
        )[: lc.reloc_max_candidates]
        cam = self.cfg.camera
        for cand in candidates:
            res = matchers.brute_match(
                to_tensor(frame.desc, torch.int32, d), to_tensor(frame.angle, None, d),
                to_tensor(frame.valid, None, d),
                to_tensor(m.kf_desc[cand], torch.int32, d), to_tensor(m.kf_angle[cand], None, d),
                to_tensor(m.kf_feat_valid[cand] & (m.kf_point_idx[cand] >= 0), None, d),
                nn_ratio=0.75, th_desc=matchers.TH_LOW, check_rotation=True,
            )
            idx, = host(res.idx_b_for_a)
            sel = np.nonzero(idx >= 0)[0]
            if len(sel) < 15:
                continue
            pts = m.kf_point_idx[cand, idx[sel]]
            ok = m.pt_valid[pts]
            sel, pts = sel[ok], pts[ok]
            if len(sel) < 15:
                continue
            n = min(len(sel), MATCH_CAP)
            valid = np.ones(n, bool)
            draws = self.draw_index_sets(valid, 128, 6, int(frame.frame_id))
            result = pnp.pnp_ransac(
                to_tensor(m.pt_pos[pts[:n]], torch.float32, d),
                to_tensor(frame.xy[sel[:n]], torch.float32, d),
                to_tensor(valid, None, d), to_tensor(draws, None, d),
                float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                min_inliers=15,
            )
            ok, T, inl = host(result.ok, result.T, result.inliers)
            if bool(ok):
                frame.T_cw = T.astype(np.float32)
                bind = np.full(len(frame.xy), -1, np.int64)
                bind[sel[:n][inl]] = pts[:n][inl]
                frame.point_idx = bind
                return True
        return False
