"""Built-in trajectory + object-track evaluation (ATE / RPE / object pose
errors) of the port: a copy of ``pointslot_tpu/evaluate.py`` (numpy only),
its CLI included.

The reference exports KITTI-format text files and leaves all metric
computation to external tools — evo and the KITTI devkit (its validation
story, reference README.md:13, src/System.cc:346-473). Here the metrics are
built in so a run can regression-check itself, on-disk outputs stay
byte-compatible for the external tools, and CI fixtures can assert accuracy
without extra dependencies.

Metrics:

- ATE (absolute trajectory error): SE(3) (optionally Sim(3)) Umeyama
  alignment of estimated to ground-truth camera centers, then RMSE of the
  residual translations — what ``evo_ape`` computes.
- RPE (relative pose error): per-``delta``-frame relative-motion residuals,
  translation RMSE + rotation RMSE — what ``evo_rpe`` computes.
- Object pose errors: per-(frame, track) camera-frame center error and
  heading (rotation_y) error of tracked objects against KITTI tracking GT
  rows — the object-level numbers the PointSLOT paper reports.

CLI (JSON on stdout)::

    python -m pointslot_torch.evaluate traj    --est CameraTrajectory.txt --gt poses_gt.txt
    python -m pointslot_torch.evaluate objects --est ObjectPosesCF.txt    --gt ObjectTracking.txt
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------

def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares s*R@src + t ≈ dst over (N, 3) point sets (Umeyama 1991,
    the alignment inside evo_ape). Returns (s, R, t)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _centers(T_wc: np.ndarray) -> np.ndarray:
    return np.asarray(T_wc)[:, :3, 3]


# ---------------------------------------------------------------------------
# trajectory metrics
# ---------------------------------------------------------------------------

def ate(est_T_wc: np.ndarray, gt_T_wc: np.ndarray, align: bool = True,
        with_scale: bool = False) -> Dict[str, float]:
    """Absolute trajectory error over (N, 4, 4) camera-to-world pose arrays
    (frame-aligned: est[i] and gt[i] are the same frame)."""
    pe, pg = _centers(est_T_wc), _centers(gt_T_wc)
    if len(pe) != len(pg):
        raise ValueError(f"trajectory lengths differ: {len(pe)} vs {len(pg)}")
    if align and len(pe) >= 3:
        s, R, t = umeyama_alignment(pe, pg, with_scale=with_scale)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": int(len(err)),
    }


def rpe(est_T_wc: np.ndarray, gt_T_wc: np.ndarray,
        delta: int = 1) -> Dict[str, float]:
    """Relative pose error at frame spacing ``delta``: translation RMSE (m)
    and rotation RMSE (deg) of est vs gt relative motions."""
    est = np.asarray(est_T_wc, np.float64)
    gt = np.asarray(gt_T_wc, np.float64)
    if len(est) != len(gt):
        raise ValueError(f"trajectory lengths differ: {len(est)} vs {len(gt)}")
    if len(est) <= delta:
        raise ValueError(f"need more than delta={delta} poses, got {len(est)}")
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = (np.trace(e[:3, :3]) - 1.0) / 2.0
        r_errs.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    t_errs, r_errs = np.asarray(t_errs), np.asarray(r_errs)
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_errs ** 2))),
        "trans_mean": float(t_errs.mean()),
        "rot_rmse_deg": float(np.sqrt(np.mean(r_errs ** 2))),
        "rot_mean_deg": float(r_errs.mean()),
        "delta": int(delta),
        "n": int(len(t_errs)),
    }


# ---------------------------------------------------------------------------
# object metrics
# ---------------------------------------------------------------------------

def read_object_poses_camera_frame(path: str) -> Dict[tuple, np.ndarray]:
    """Parse the camera-frame object-pose export (one line per
    (frame, track): ``frame track r00 ... t2``, System.
    save_object_poses_camera_frame — the reference's
    SaveObjectDetectionResultsInCameraFrame format, src/System.cc:474-543).
    Returns {(frame_id, track_id): (4, 4) T_co}."""
    out: Dict[tuple, np.ndarray] = {}
    data = np.loadtxt(path, ndmin=2)
    for row in data:
        T = np.eye(4)
        T[:3, :4] = row[2:14].reshape(3, 4)
        out[(int(row[0]), int(row[1]))] = T
    return out


def object_pose_errors(est_poses_cf: Dict[tuple, np.ndarray],
                       gt_rows: np.ndarray,
                       moving_only: bool = False) -> Dict[str, object]:
    """Per-(frame, track) object pose error against KITTI tracking GT rows
    (the 1x24 layout of datasets.kitti.read_kitti_object_rows; GT center =
    cols 12:15 camera-frame, heading = col 15 rotation_y).

    Track ids must be GT ids (SLOT modes 4/2; mode 3 online DeepSORT ids
    need an external id mapping first). Returns overall + per-track center
    RMSE (m) and heading RMSE (deg), and coverage = matched / GT rows.

    moving_only filters on the rows' is_moving column — populated by the
    Virtual KITTI reader; plain KITTI tracking labels carry no such flag
    (the reader leaves it 1, so the filter passes everything there)."""
    gt_rows = np.asarray(gt_rows)
    if moving_only and len(gt_rows):
        gt_rows = gt_rows[gt_rows[:, 18] > 0]
    per_track: Dict[int, dict] = {}
    c_errs, h_errs = [], []
    n_gt = 0
    for row in gt_rows:
        if row[17] == 0:      # non-vehicle
            continue
        n_gt += 1
        key = (int(row[0]), int(row[1]))
        T = est_poses_cf.get(key)
        if T is None:
            continue
        ce = float(np.linalg.norm(T[:3, 3] - row[12:15]))
        ry_est = np.arctan2(T[0, 2], T[2, 2])
        dh = float(np.degrees(np.abs(np.angle(np.exp(1j * (ry_est - row[15]))))))
        c_errs.append(ce)
        h_errs.append(dh)
        rec = per_track.setdefault(int(row[1]), {"c": [], "h": []})
        rec["c"].append(ce)
        rec["h"].append(dh)
    summary = {
        "n_gt": n_gt,
        "n_matched": len(c_errs),
        "coverage": float(len(c_errs) / n_gt) if n_gt else 0.0,
        "center_rmse": float(np.sqrt(np.mean(np.square(c_errs)))) if c_errs else None,
        "center_median": float(np.median(c_errs)) if c_errs else None,
        "heading_rmse_deg": float(np.sqrt(np.mean(np.square(h_errs)))) if h_errs else None,
        "per_track": {
            tid: {
                "n": len(rec["c"]),
                "center_rmse": float(np.sqrt(np.mean(np.square(rec["c"])))),
                "heading_rmse_deg": float(np.sqrt(np.mean(np.square(rec["h"])))),
            }
            for tid, rec in sorted(per_track.items())
        },
    }
    return summary


# ---------------------------------------------------------------------------
# 2D MOT metrics (the DeepSORT association quality story)
# ---------------------------------------------------------------------------

def bbox_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xywh boxes -> (N, M)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ix0 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy0 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix1 = np.minimum(a[:, None, 0] + a[:, None, 2], b[None, :, 0] + b[None, :, 2])
    iy1 = np.minimum(a[:, None, 1] + a[:, None, 3], b[None, :, 1] + b[None, :, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    union = (a[:, None, 2] * a[:, None, 3] + b[None, :, 2] * b[None, :, 3]
             - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mot_metrics(est_tracks: Dict[int, Dict[int, np.ndarray]],
                gt_rows: np.ndarray,
                iou_threshold: float = 0.5) -> Dict[str, object]:
    """CLEAR-MOT 2D tracking metrics against KITTI tracking GT rows.

    est_tracks: {frame_id: {est_track_id: bbox xywh}} — the output of an
    online tracker (mode-3 DeepSORT ids need no GT alignment: matching is
    by per-frame IoU, identity is scored by id-switch counting, the
    standard CLEAR-MOT protocol). Returns MOTA, MOTP (mean IoU of matched
    pairs), id switches, misses, false positives.
    """
    gt_rows = np.asarray(gt_rows)
    gt_by_frame: Dict[int, list] = {}
    for row in gt_rows:
        if row[17] == 0 or row[1] < 0:
            continue
        gt_by_frame.setdefault(int(row[0]), []).append(
            (int(row[1]), np.asarray(row[5:9], np.float64)))
    n_gt = sum(len(v) for v in gt_by_frame.values())
    last_match: Dict[int, int] = {}      # gt id -> est id of last match
    misses = fps_ = switches = matches = 0
    iou_sum = 0.0
    for f in sorted(set(gt_by_frame) | set(est_tracks)):
        gt = gt_by_frame.get(f, [])
        est = list(est_tracks.get(f, {}).items())
        # greedy IoU matching (highest IoU first)
        used_g, used_e = set(), set()
        frame_matches = []
        if gt and est:
            ious = bbox_iou_matrix(np.stack([g[1] for g in gt]),
                                   np.stack([e[1] for e in est]))
            order = np.argsort(ious, axis=None)[::-1]
            for flat in order:
                gi, ei = np.unravel_index(flat, ious.shape)
                iou = ious[gi, ei]
                if iou < iou_threshold:
                    break
                if gi in used_g or ei in used_e:
                    continue
                used_g.add(int(gi))
                used_e.add(int(ei))
                frame_matches.append((gt[gi][0], est[ei][0], float(iou)))
        matches += len(frame_matches)
        misses += len(gt) - len(used_g)
        fps_ += len(est) - len(used_e)
        for gt_id, est_id, iou in frame_matches:
            if gt_id in last_match and last_match[gt_id] != est_id:
                switches += 1
            last_match[gt_id] = est_id
            iou_sum += iou
    mota = 1.0 - (misses + fps_ + switches) / n_gt if n_gt else None
    return {
        "mota": float(mota) if mota is not None else None,
        "motp_iou": float(iou_sum / matches) if matches else None,
        "matches": matches,
        "misses": misses,
        "false_positives": fps_,
        "id_switches": switches,
        "n_gt": n_gt,
    }


# ---------------------------------------------------------------------------
# run-level helper
# ---------------------------------------------------------------------------

def evaluate_trajectory_entries(traj, gt_T_wc: np.ndarray,
                                rpe_delta: int = 1) -> Dict[str, object]:
    """Evaluate a System.camera_trajectory() result — entries of
    (frame_id, T_cw, lost) — against per-frame ground-truth T_wc poses
    indexed by frame id. Lost frames and frames beyond the GT are skipped."""
    sel = [(f, T) for f, T, lost in traj if not lost and 0 <= f < len(gt_T_wc)]
    if len(sel) < 3:
        return {"error": "fewer than 3 evaluable frames", "n": len(sel)}
    est = np.stack([np.linalg.inv(np.asarray(T, np.float64)) for _, T in sel])
    gt = np.stack([np.asarray(gt_T_wc[f], np.float64) for f, _ in sel])
    out = {"ate": ate(est, gt, align=True), "frames_evaluated": len(sel)}
    if len(sel) > rpe_delta:
        out["rpe"] = rpe(est, gt, delta=rpe_delta)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> dict:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m pointslot_torch.evaluate",
        description="ATE/RPE and object pose evaluation of run outputs",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("traj", help="camera ATE + RPE (KITTI 12-float rows)")
    pt.add_argument("--est", required=True)
    pt.add_argument("--gt", required=True)
    pt.add_argument("--rpe-delta", type=int, default=1)
    pt.add_argument("--no-align", action="store_true")
    pt.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment (monocular-style)")
    po = sub.add_parser("objects", help="object pose errors vs tracking GT")
    po.add_argument("--est", required=True,
                    help="camera-frame object pose file (frame track 12 floats)")
    po.add_argument("--gt", required=True, help="KITTI ObjectTracking.txt")
    po.add_argument("--moving-only", action="store_true",
                    help="score only rows flagged moving (Virtual KITTI GT; "
                         "plain KITTI labels carry no flag — no-op there)")
    args = p.parse_args(argv)

    if args.cmd == "traj":
        from pointslot_torch.io.writers import read_trajectory_kitti

        est = read_trajectory_kitti(args.est)
        gt = read_trajectory_kitti(args.gt)
        n = min(len(est), len(gt))
        out = {
            "ate": ate(est[:n], gt[:n], align=not args.no_align,
                       with_scale=args.scale),
            "rpe": rpe(est[:n], gt[:n], delta=args.rpe_delta),
        }
    else:
        from pointslot_torch.datasets.kitti import read_kitti_object_rows

        est = read_object_poses_camera_frame(args.est)
        gt_rows = read_kitti_object_rows(args.gt)
        out = object_pose_errors(est, gt_rows, moving_only=args.moving_only)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
