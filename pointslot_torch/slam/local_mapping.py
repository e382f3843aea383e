"""Camera local mapping: culling, triangulation, fuse, windowed Schur BA.

Port of ``pointslot_tpu/slam/local_mapping.py::LocalMapper`` (the
reference's LocalMapping thread body, src/LocalMapping.cc:169-263):
MapPointCulling, multi-view triangulation of the far features, the
SearchInNeighbors fuse, the windowed LocalBundleAdjustment and
KeyFrameCulling at 90 % redundancy.

The snapshot / compute / merge split and the lock discipline are the
reference's: the lock covers only host snapshots and staleness-guarded
merges; descriptor matching, triangulation, projection matching and the BA
solve run on the mapper's device with the lock released, and every result
is on the host before the lock is taken again (a solve still queued on the
card would otherwise be waited for inside the merge).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pointslot_torch.config import SystemConfig
from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.geometry import triangulation as tri
from pointslot_torch.slam import matchers
from pointslot_torch.slam.map_state import MapState
from pointslot_torch.solvers import local_ba
from pointslot_torch.utils.profiling import PROFILER


@dataclass
class RecentPoint:
    pt: int
    created_kf: int


class LocalMapper:
    def __init__(self, config: SystemConfig, map_state: MapState, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.map = map_state
        self.recent_points: List[RecentPoint] = []
        self._kf_counter = 0
        cam = config.camera
        self._cam_args = dict(
            fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
            bf=float(cam.bf),
        )
        self._scales = np.asarray(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)],
            np.float32,
        )
        self._scales_dev = torch.from_numpy(self._scales).to(self.device)
        self.ba_calls = 0
        # System replaces with its map lock; the BA SOLVE runs outside it
        # (the reference takes mMutexMapUpdate only to APPLY LocalBA
        # results, src/Optimizer.cc LocalBundleAdjustment 'get map mutex')
        self.lock = contextlib.nullcontext()

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, skip_ba: bool = False):
        """Every device-compute stage (triangulation matching, fuse
        projection, the BA solve) runs with the map lock RELEASED: the
        lock covers only cheap array snapshots and staleness-guarded
        merges. Tracking holds the same lock for its whole frame, so an
        in-lock device call here would stall it for the call's duration
        (the reference's finer-grained Map mutexes have the same effect,
        src/LocalMapping.cc:169-263).

        ``skip_ba``: drop the windowed BA for this keyframe (the caller
        saw more keyframes queued — reference InterruptBA semantics,
        src/LocalMapping.cc:219)."""
        self._kf_counter += 1
        m = self.map
        with self.lock:
            new_pts = np.nonzero(m.pt_first_kf == kf)[0]
            for p in new_pts:
                self.recent_points.append(
                    RecentPoint(pt=int(p), created_kf=self._kf_counter))

            self._cull_points()
            tri_snap = self._tri_snapshot(kf)
        if tri_snap is not None:
            batches = self._tri_compute(tri_snap)      # device, no lock
            if batches:
                with self.lock:
                    self._tri_merge(tri_snap, batches)

        with self.lock:
            fuse_snap = self._fuse_snapshot(kf)
        if fuse_snap is not None:
            pf = self._fuse_compute(fuse_snap)         # device, no lock
            with self.lock:
                self._fuse_merge(fuse_snap, pf)

        with self.lock:
            snap = (self._local_ba_snapshot(kf)
                    if m.n_keyframes() > 2 and not skip_ba else None)
        if snap is not None:
            # the expensive LM solve holds NO lock — tracking proceeds.
            # Launches are asynchronous: the result comes to the host
            # BEFORE the lock is taken, so the merge never waits for the
            # solve inside the locked section.
            result = local_ba.bundle_adjust(snap["prob"], **self._cam_args)
            result = local_ba.BAResult(*host(*result))
            self.ba_calls += 1
            with self.lock:
                self._local_ba_merge(snap, result)
        with self.lock:
            self._cull_keyframes(kf)

    # ------------------------------------------------------------------
    # Multi-view triangulation of features without stereo depth — the far
    # tail beyond th_depth (LocalMapping::CreateNewMapPoints, reference
    # src/LocalMapping.cc:414; close points come directly from stereo
    # unprojection at keyframe creation). Split snapshot/compute/merge so
    # the device matching + triangulation never run under the map lock.

    def _tri_snapshot(self, kf: int):
        """Copy everything the lock-free compute needs (cheap row copies;
        runs under the map lock)."""
        m = self.map
        neighbors = [int(n) for n in
                     m.covisible_keyframes(kf, min_weight=15, max_n=5)]
        if not neighbors:
            return None
        # candidate features: valid, unbound, no stereo depth (far)
        far = {
            k: (m.kf_feat_valid[k] & (m.kf_point_idx[k] < 0)
                & (m.kf_depth[k] <= 0)).copy()
            for k in [kf] + neighbors
        }
        if far[kf].sum() < 10:
            return None
        ids = [kf] + neighbors
        return dict(
            kf=int(kf), neighbors=neighbors, far=far,
            uid={k: int(m.kf_uid[k]) for k in ids},
            pose={k: m.kf_pose[k].astype(np.float64).copy() for k in ids},
            desc={k: m.kf_desc[k].copy() for k in ids},
            angle={k: m.kf_angle[k].copy() for k in ids},
            xy={k: m.kf_xy[k].copy() for k in ids},
            level=m.kf_level[kf].copy(),
        )

    def _tri_compute(self, snap):
        """Per-neighbor match + triangulate + geometric validation against
        the snapshot (device compute — holds NO lock). Returns candidate
        batches for the guarded merge."""
        cam = self.cfg.camera
        d = self.device
        K = np.asarray(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64
        )
        kf = snap["kf"]
        far_k = snap["far"][kf]
        batches = []
        created = 0
        for n in snap["neighbors"]:
            far_n = snap["far"][n]
            if far_n.sum() < 10:
                continue
            baseline = np.linalg.norm(
                (np.linalg.inv(snap["pose"][kf]) @ snap["pose"][n])[:3, 3]
            )
            if baseline < 0.3:
                continue
            res = matchers.brute_match(
                to_tensor(snap["desc"][kf], torch.int32, d),
                to_tensor(snap["angle"][kf], None, d), to_tensor(far_k, None, d),
                to_tensor(snap["desc"][n], torch.int32, d),
                to_tensor(snap["angle"][n], None, d), to_tensor(far_n, None, d),
                nn_ratio=0.6, th_desc=matchers.TH_LOW, check_rotation=True,
            )
            idx, = host(res.idx_b_for_a)
            sel = np.nonzero(idx >= 0)[0]
            if len(sel) < 5:
                continue
            # the reference pads the pairs to a power of two only to bound
            # XLA recompiles; each pair is solved on its own
            uv1 = snap["xy"][kf][sel].astype(np.float32)
            uv2 = snap["xy"][n][idx[sel]].astype(np.float32)
            P1 = to_tensor(K @ snap["pose"][kf][:3, :4], torch.float32, d)
            P2 = to_tensor(K @ snap["pose"][n][:3, :4], torch.float32, d)
            X, well_posed = host(*tri.triangulate(
                P1.expand(len(sel), 3, 4), P2.expand(len(sel), 3, 4),
                to_tensor(uv1, None, d), to_tensor(uv2, None, d),
            ))
            X = X.astype(np.float64)
            ok = well_posed.copy()
            # validate: positive depth + reprojection error in both views
            for T, uv in ((snap["pose"][kf], uv1), (snap["pose"][n], uv2)):
                pc = X @ T[:3, :3].T + T[:3, 3]
                z = pc[:, 2]
                u = cam.fx * pc[:, 0] / np.maximum(z, 1e-9) + cam.cx
                v = cam.fy * pc[:, 1] / np.maximum(z, 1e-9) + cam.cy
                err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
                ok &= (z > cam.depth_threshold * 0.5) & (err2 < 5.991 * 4.0)
            good = np.nonzero(ok)[0]
            if len(good) == 0:
                continue
            # mark as consumed so later neighbors don't re-create them
            far_k[sel[good]] = False
            batches.append(dict(n=n, feat_kf=sel[good], feat_n=idx[sel[good]],
                                X=X[good]))
            created += len(good)
            if created > 256:
                break
        return batches

    def _tri_merge(self, snap, batches):
        """Apply triangulated candidates to the LIVE map (under the map
        lock): a batch is dropped if either keyframe slot was recycled;
        individual features are dropped if they were bound meanwhile."""
        m = self.map
        kf = snap["kf"]
        if int(m.kf_uid[kf]) != snap["uid"][kf]:
            return
        T_wc = np.linalg.inv(snap["pose"][kf])
        for b in batches:
            n = b["n"]
            if int(m.kf_uid[n]) != snap["uid"][n]:
                continue
            fk, fn, X = b["feat_kf"], b["feat_n"], b["X"]
            fresh = (
                m.kf_feat_valid[kf, fk] & (m.kf_point_idx[kf, fk] < 0)
                & m.kf_feat_valid[n, fn] & (m.kf_point_idx[n, fn] < 0)
            )
            fk, fn, X = fk[fresh], fn[fresh], X[fresh]
            if len(fk) == 0:
                continue
            n_free = int((~m.pt_valid).sum())
            keep = max(n_free - 64, 0)
            fk, fn, X = fk[:keep], fn[:keep], X[:keep]
            if len(fk) == 0:
                continue
            pts_new = m.alloc_points(len(fk))
            fk, fn, X = fk[: len(pts_new)], fn[: len(pts_new)], X[: len(pts_new)]
            m.pt_pos[pts_new] = X
            m.pt_desc[pts_new] = m.kf_desc[kf, fk]
            m.pt_first_kf[pts_new] = kf
            m.pt_found[pts_new] = 2
            m.pt_visible[pts_new] = 2
            d = X - T_wc[:3, 3]
            dn = np.linalg.norm(d, axis=1, keepdims=True)
            m.pt_normal[pts_new] = d / np.maximum(dn, 1e-9)
            scale = self._scales[snap["level"][fk]]
            m.pt_max_dist[pts_new] = dn[:, 0] * scale
            m.pt_min_dist[pts_new] = m.pt_max_dist[pts_new] / (
                self.cfg.orb.scale_factor ** (self.cfg.orb.n_levels - 1)
            )
            m.bind(kf, fk, pts_new)
            m.bind(n, fn, pts_new)
            for p in pts_new:
                self.recent_points.append(
                    RecentPoint(pt=int(p), created_kf=self._kf_counter)
                )

    # ------------------------------------------------------------------
    def _cull_points(self):
        """MapPointCulling rules: found/visible < 0.25, or too few
        observations a couple of keyframes after creation."""
        m = self.map
        keep: List[RecentPoint] = []
        to_cull = []
        obs_count = m.point_obs_count()
        for rp in self.recent_points:
            if not m.pt_valid[rp.pt]:
                continue
            age = self._kf_counter - rp.created_kf
            ratio = m.pt_found[rp.pt] / max(m.pt_visible[rp.pt], 1)
            if ratio < 0.25:
                to_cull.append(rp.pt)
            elif age >= 2 and obs_count[rp.pt] <= 1:
                # the reference culls stereo points with <= 3 observations
                # here (src/LocalMapping.cc:352); with per-frame feature
                # redetection churn our re-observation rate is lower, and
                # the 2-observation points carry the map's only multi-view
                # constraints — keep them (duplicates are handled by fuse)
                to_cull.append(rp.pt)
            elif age >= 3:
                continue  # graduates out of the probation window
            else:
                keep.append(rp)
        self.recent_points = keep
        if to_cull:
            m.unbind_point(np.asarray(to_cull))

    # ------------------------------------------------------------------
    # SearchInNeighbors fuse (one-direction: project covisible keyframes'
    # points into kf, bind unmatched features; duplicate resolution via
    # existing bindings). Snapshot/compute/merge split keeps the device
    # projection-match out of the map lock.

    def _fuse_snapshot(self, kf: int):
        m = self.map
        neighbors = m.covisible_keyframes(kf, min_weight=15, max_n=10)
        if len(neighbors) == 0:
            return None
        cand = m.points_of_keyframes(neighbors)
        already = m.kf_point_idx[kf]
        cand = cand[~np.isin(cand, already[already >= 0])]
        if len(cand) == 0:
            return None
        return dict(
            kf=int(kf), uid=int(m.kf_uid[kf]), cand=cand,
            pt_pos=m.pt_pos[cand].copy(), pt_desc=m.pt_desc[cand].copy(),
            pt_valid=m.pt_valid[cand].copy(),
            pt_first_kf=m.pt_first_kf[cand].copy(),
            pred_level=m.predict_scale(
                np.linalg.norm(
                    m.pt_pos[cand]
                    + (m.kf_pose[kf][:3, :3].T @ m.kf_pose[kf][:3, 3]),
                    axis=1,
                ),
                cand,
            ),
            pose=m.kf_pose[kf].copy(),
            kf_xy=m.kf_xy[kf].copy(), kf_level=m.kf_level[kf].copy(),
            kf_desc=m.kf_desc[kf].copy(),
            kf_unbound=(m.kf_feat_valid[kf]
                        & (m.kf_point_idx[kf] < 0)).copy(),
        )

    def _fuse_compute(self, snap):
        """Projection match against the snapshot (device — no lock). The
        candidate count is not padded (see tracking._match_and_optimize)."""
        d = self.device
        cam = self.cfg.camera
        res = matchers.project_and_match(
            to_tensor(snap["pt_pos"].astype(np.float32), None, d)[None],
            to_tensor(snap["pt_desc"], torch.int32, d)[None],
            to_tensor(snap["pt_valid"], None, d)[None],
            to_tensor(snap["pose"], torch.float32, d)[None],
            to_tensor(snap["kf_xy"], torch.float32, d),
            to_tensor(snap["kf_level"], torch.int32, d),
            to_tensor(snap["kf_desc"], torch.int32, d),
            to_tensor(snap["kf_unbound"], None, d),
            3.0, self._scales_dev,
            to_tensor(snap["pred_level"].astype(np.int32), None, d)[None],
            fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
            width=cam.width, height=cam.height,
            th_desc=matchers.TH_LOW, level_window=2,
        )
        pf, = host(res.point_for_feature[0])
        return pf

    def _fuse_merge(self, snap, pf):
        """Bind match results to the live map (under the map lock),
        dropping anything that went stale during the compute window."""
        m = self.map
        kf = snap["kf"]
        if int(m.kf_uid[kf]) != snap["uid"]:
            return
        feats = np.nonzero(pf >= 0)[0]
        if len(feats) == 0:
            return
        pts = snap["cand"][pf[feats]]
        fresh = (
            m.kf_feat_valid[kf, feats] & (m.kf_point_idx[kf, feats] < 0)
            & m.pt_valid[pts]
            & (m.pt_first_kf[pts] == snap["pt_first_kf"][pf[feats]])
        )
        feats, pts = feats[fresh], pts[fresh]
        if len(feats):
            m.bind(kf, feats, pts)
            m.update_point_stats(pts)

    # ------------------------------------------------------------------
    def _local_ba_snapshot(self, kf: int):
        m = self.map
        ba_cfg = self.cfg.ba
        P_cap = ba_cfg.max_ba_keyframes
        L_cap = ba_cfg.max_ba_points

        window = [kf] + list(m.covisible_keyframes(kf, min_weight=15,
                                                   max_n=P_cap // 2 - 1))
        pts = m.points_of_keyframes(window)
        if len(pts) == 0:
            return
        # fixed keyframes: observe window points but are not in the window
        observers = np.nonzero(m.obs[pts].any(axis=0) & m.kf_valid)[0]
        fixed = [k for k in observers if k not in window][: P_cap - len(window)]
        kf_list = window + fixed
        n_fixed_flags = [False] * len(window) + [True] * len(fixed)
        # always fix the first keyframe of the map (gauge)
        for i, k in enumerate(kf_list):
            if m.kf_frame_id[k] == m.kf_frame_id[m.keyframe_ids()].min():
                n_fixed_flags[i] = True
        if not any(n_fixed_flags):
            n_fixed_flags[-1] = True

        kf_row = {k: i for i, k in enumerate(kf_list)}
        pts = pts[: L_cap]
        pt_row = np.full(m.max_points, -1, np.int64)
        pt_row[pts] = np.arange(len(pts))

        # gather edges from the incidence tables
        e_pose, e_point, e_obs, e_stereo, e_inv2 = [], [], [], [], []
        for k in kf_list:
            bound = np.nonzero(m.kf_point_idx[k] >= 0)[0]
            p_idx = m.kf_point_idx[k, bound]
            sel = pt_row[p_idx] >= 0
            bound, p_idx = bound[sel], p_idx[sel]
            ur = m.kf_uright[k, bound]
            e_pose.append(np.full(len(bound), kf_row[k]))
            e_point.append(pt_row[p_idx])
            e_obs.append(
                np.stack([m.kf_xy[k, bound, 0], m.kf_xy[k, bound, 1], ur], axis=1)
            )
            e_stereo.append(m.kf_depth[k, bound] > 0)
            e_inv2.append(1.0 / self._scales[m.kf_level[k, bound]] ** 2)
        e_pose = np.concatenate(e_pose)
        e_point = np.concatenate(e_point)
        e_obs = np.concatenate(e_obs)
        e_stereo = np.concatenate(e_stereo)
        e_inv2 = np.concatenate(e_inv2)
        E = len(e_pose)

        prob, slot_edge = local_ba.build_problem(
            poses=m.kf_pose[kf_list].astype(np.float32),
            pose_fixed=np.asarray(n_fixed_flags),
            points=m.pt_pos[pts].astype(np.float32),
            e_pose=e_pose, e_point=e_point, e_obs=e_obs, e_stereo=e_stereo,
            e_inv_sigma2=e_inv2,
            P_cap=P_cap, L_cap=L_cap, K=ba_cfg.max_obs_per_point,
            device=self.device,
        )
        kept = int((slot_edge >= 0).sum())
        if kept < E:
            PROFILER.count("local_ba_obs_dropped", E - kept)
        return dict(
            prob=prob, slot_edge=slot_edge, kf_list=kf_list,
            fixed_flags=n_fixed_flags, pts=pts,
            e_pose=e_pose, e_point=e_point,
            kf_uid=m.kf_uid[kf_list].copy(),
            pt_first_kf=m.pt_first_kf[pts].copy(),
        )

    def _local_ba_merge(self, snap: dict, result):
        """Apply the windowed-BA result under the lock. Staleness guards
        (keyframe slot uid / point first-keyframe identity) protect against
        rows recycled while the solve ran lock-free."""
        m = self.map
        kf_list = snap["kf_list"]
        pts = snap["pts"]
        fixed_flags = snap["fixed_flags"]

        live_kf = m.kf_uid[kf_list] == snap["kf_uid"]
        new_poses = np.asarray(result.poses)
        for i, k in enumerate(kf_list):
            if live_kf[i] and not fixed_flags[i]:
                m.kf_pose[k] = new_poses[i]
        live_pt = m.pt_valid[pts] & (m.pt_first_kf[pts] == snap["pt_first_kf"])
        m.pt_pos[pts[live_pt]] = np.asarray(
            result.points)[: len(pts)][live_pt].astype(np.float64)

        # drop outlier observations
        slot_edge = snap["slot_edge"]
        e_pose, e_point = snap["e_pose"], snap["e_point"]
        inl = np.asarray(result.obs_inlier)
        bad = slot_edge[(slot_edge >= 0) & ~inl]
        dropped = False
        for b in bad:
            i = int(e_pose[b])
            pi = int(e_point[b])
            if not live_kf[i] or not live_pt[pi]:
                continue
            k = kf_list[i]
            p = pts[pi]
            feats = np.nonzero(m.kf_point_idx[k] == p)[0]
            if len(feats):
                m.kf_point_idx[k, feats] = -1
                m.obs[p, k] = False
                dropped = True
        if dropped:
            lp = pts[live_pt]
            orphans = lp[~m.obs[lp].any(axis=1)]
            if len(orphans):
                m.pt_valid[orphans] = False

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """Remove local keyframes with >= 90% of points seen by >= 3 other
        keyframes (reference src/LocalMapping.cc:900)."""
        m = self.map
        obs_count = m.point_obs_count()
        for k in m.covisible_keyframes(kf, min_weight=15):
            if m.kf_frame_id[k] == m.kf_frame_id[m.keyframe_ids()].min():
                continue
            bound = m.kf_point_idx[k]
            p = bound[bound >= 0]
            if len(p) < 50:
                continue
            redundant = (obs_count[p] >= 4).mean()
            if redundant > 0.9:
                m.remove_keyframe(k)
