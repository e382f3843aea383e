"""How a run decides ``correct``: what the timed path produced, against the
plain reference (``reference/``) and the scene's ground truth, each number
beside its limit.

After the window closes, the harness takes from the System only its outputs
(the frame records it returned, the poses, the trajectory, the objects'
poses) and what ``capture.Capture`` kept of the window (the camera
frontend's allowed regions, the object frontend's features, the inputs of
the pose solves, the last camera BA), frees the System, and judges them
here:

- the camera frontend, on a sample of the window's frames drawn from the
  seed with the slowest frame in it: the reference works the frame out again
  from the stereo pair alone (``reference/frontend.py::run_frame``: pyramid,
  FAST, suppression, cell selection, orientation, BRIEF, the whole stereo
  search), and the keypoints kept, the descriptors, the angles, which
  keypoints have a depth and at what disparity are compared; in mode 4 the
  allowed region is held to the background and whole objects;
- the object frontend, on the same frames: orientation, descriptor and
  stereo fit at each of its keypoints (``judge_frame``);
- camera tracking: every window frame's pose against the least cost of its
  last pose solve (``reference/pose.py``), and the whole trajectory against
  the ground truth (``reference/geometry.py``, the ATE guarantee);
- object tracking (cells with cars): every object pose of each frame's last
  object pose solve against its least cost, and every car the detections
  show on enough window frames holding a track;
- the windowed BA: every point of the window's last camera BA against its
  least cost with the answer's poses (``reference/ba.py``).

A frame the System lost or raised on is an answer that never came: one such
frame makes the run not correct. The limits of each cell sit in
``limits/<cell>.json``; PERF.md gives the readings they were set from.

``control_outputs`` puts the reference, computed in bfloat16, in the
program's place; ``correct`` has to come out false for it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from slotbench.reference import ba as ref_ba
from slotbench.reference import frontend as ref_fe
from slotbench.reference import geometry as ref_geo
from slotbench.reference import pose as ref_pose
from slotbench.traffic import scene as sc

LIMITS = Path(__file__).resolve().parent / "limits"

# a car shown within CAR_NEAR_M metres on CAR_MIN_FRAMES or more window
# frames has to hold a pose on one of them: sound runs give a car at most 11
# such frames before its first pose (PERF.md gives the readings)
CAR_NEAR_M = 30.0
CAR_MIN_FRAMES = 20

# the numbers a cell may compare (its limits file names them): what each reads
NUMBERS = {
    "kp_missed_share": "frontend detection: share of the reference's keypoints on the sampled "
                       "frames that the program does not keep",
    "kp_extra_share": "frontend detection: share of the program's keypoints on the sampled "
                      "frames that the reference does not keep",
    "gate_pixels_off": "frontend gate (mode 4): pixels of the sampled frames where the camera "
                       "frontend's allowed region is not the background and whole objects",
    "angle_p99_rad": "frontend orientation: 99th percentile of |angle gap|, keypoints both keep",
    "desc_bits_share": "frontend descriptors: share of the bits that differ, keypoints both keep",
    "stereo_flip_share": "frontend stereo: share of the keypoints both keep that only one of "
                         "the two gives a depth",
    "disparity_p99_px": "frontend stereo: 99th percentile of |disparity gap| where both give a "
                        "depth",
    "obj_angle_p99_rad": "object frontend orientation: as angle_p99_rad, at its keypoints",
    "obj_desc_bits_share": "object frontend descriptors: as desc_bits_share, at its keypoints",
    "obj_disparity_p99_px": "object frontend stereo: 99th percentile of |disparity gap| of its "
                            "stereo keypoints, refitted at its match",
    "pose_excess_max": "camera tracking: largest chi-square per edge by which a window frame's "
                       "pose lies above the least cost of its last pose solve",
    "ate_share": "camera tracking: RMS position error from the first frame to the window's "
                 "last, over the path's length (the System's guarantee: under 0.02)",
    "obj_pose_excess_p90": "object tracking: 90th percentile over objects and frames of the "
                           "chi-square per edge by which an object's pose lies above the least "
                           "cost of its last pose solve",
    "cars_untracked": f"object tracking: cars the detections show within {CAR_NEAR_M:g} m on "
                      f"{CAR_MIN_FRAMES} or more window frames whose track holds a pose on "
                      "none of those",
    "ba_excess_p99": "windowed BA: 99th percentile over the last BA's points of the chi-square "
                     "per edge by which the answer's point lies above its least cost",
}


def load_limits(cell: str) -> Dict[str, float]:
    with open(LIMITS / f"{cell}.json", encoding="utf-8") as fh:
        return json.load(fh)["limits"]


def sample_frames(window: List[int], latencies: List[float], n: int, seed: int) -> List[int]:
    """`n` window frames drawn from the seed, and the slowest one."""
    rng = np.random.default_rng(int(seed) % sc.SEED_MOD + 7)
    pick = set(rng.choice(window, size=min(n, len(window)), replace=False).tolist())
    pick.add(window[int(np.argmax(latencies))])
    return sorted(pick)


FIELDS = ("xy", "level", "desc", "angle", "depth", "u_right", "valid")


def _host_call(call: dict) -> dict:
    keys = ("T_init", "pts", "obs", "is_stereo", "inv_sigma2", "valid", "trans_prior", "T")
    out = {k: (call[k].detach().cpu().numpy() if call.get(k) is not None else None) for k in keys}
    out["cam"] = tuple(float(call[k]) for k in ("fx", "fy", "cx", "cy", "bf"))
    out["prior_w"] = float(call.get("trans_prior_weight", 0.0)) if call.get("trans_prior") is not None else 0.0
    return out


def collect(system, records: Dict[int, object], capture, window: List[int],
            keyframe_frames: List[int], sampled: List[int]) -> dict:
    """The System's outputs as host copies: sampled frame records (with the
    camera frontend's allowed region and the object frontend's features of
    those frames), every window frame's pose and the inputs of its last
    camera and object pose LMs, the window's last camera BA (problem and
    answer), the trajectory and the objects' camera-frame poses
    (``capture.Capture`` kept what the window made). A keyframe's pose is
    the BA's, so for keyframe frames the pose judged is the one its pose LM
    answered."""
    pose_lm, obj_lm, ba_last = capture.pose_lm, capture.obj_lm, capture.ba_last
    traj = {int(f): np.linalg.inv(np.asarray(T, np.float64))
            for f, T, lost in system.camera_trajectory() if not lost}
    objs = {}
    if system._object_system is not None:
        for track in system._object_system.all_tracks:
            for f, T in track.poses_cf.items():
                objs[(int(track.track_id), int(f))] = np.asarray(T, np.float64)
    poses = {f: (None if getattr(records.get(f), "T_cw", None) is None
                 else np.asarray(records[f].T_cw, np.float64)) for f in window}
    for f in keyframe_frames:
        if poses.get(f) is not None and f in pose_lm:
            poses[f] = pose_lm[f]["T"][0].detach().cpu().double().numpy()
    ba = {}
    if ba_last:
        host = lambda x: x.detach().cpu().numpy()   # noqa: E731
        ba = {k: host(getattr(ba_last["prob"], k)) for k in ba_last["prob"]._fields}
        ba.update(ans_poses=host(ba_last["res"].poses), ans_points=host(ba_last["res"].points),
                  cam=ba_last["cam"])
    frames, gates = {}, {}
    for f in sampled:
        frames[("learned", f)] = {k: np.array(getattr(records[f], k)) for k in FIELDS}
        gates[f] = capture.gates.get(f)
        if f in capture.obj_features:
            frames[("gaussian", f)] = {k: np.array(getattr(capture.obj_features[f], k))
                                       for k in FIELDS}
    return dict(window=list(window), sampled=list(sampled), frames=frames, gates=gates,
                traj=traj, poses=poses, pose_lm={f: _host_call(c) for f, c in pose_lm.items()},
                obj_lm={f: _host_call(c) for f, c in obj_lm.items()}, ba=ba, objects=objs)


def reference_gate(mask: Optional[np.ndarray], gate: Optional[np.ndarray]):
    """(the allowed region the reference holds the camera frontend to, the
    pixels where the program's differs): the background and every object
    whose region the program's allows whole (the objects it settled as
    static), or None where the program has no gate."""
    if gate is None:
        return None, 0
    gate = np.asarray(gate, bool)
    ref = mask == 0
    for i in np.unique(mask[mask > 0]):
        region = mask == i
        if gate[region].all():
            ref |= region
    return ref, int((gate != ref).sum())


def _keys(level: np.ndarray, xy: np.ndarray, valid: np.ndarray, scale: float) -> dict:
    """{(level, y, x) in level pixels: index} of the valid keypoints."""
    s = scale ** level.astype(np.float64)
    x = np.round(xy[:, 0] / s).astype(np.int64)
    y = np.round(xy[:, 1] / s).astype(np.int64)
    return {(int(level[i]), int(y[i]), int(x[i])): i for i in np.nonzero(valid)[0]}


def _camera_gaps(out: dict, scale: float) -> dict:
    """Gaps of the camera frontend's answers on the sampled frames to the
    reference's whole-frame answers (``reference_frames``); `scale` the
    pyramid's scale factor."""
    g = dict(missed=0, n_ref=0, extra=0, n_prog=0, gate_off=0, angle=[], bits=0, n_bits=0,
             flip=0, n_both=0, disparity=[])
    for f, ref in out["reference_frames"].items():
        r = out["frames"][("learned", f)]
        pk = _keys(r["level"], r["xy"], r["valid"], scale)
        rk = _keys(ref["level"], ref["xy"], ref["valid"], scale)
        both = sorted(set(pk) & set(rk))
        g["missed"] += len(set(rk) - set(pk))
        g["extra"] += len(set(pk) - set(rk))
        g["n_ref"] += len(rk)
        g["n_prog"] += len(pk)
        g["gate_off"] += out["gate_off"].get(f, 0)
        pi = np.array([pk[k] for k in both], np.int64)
        ri = np.array([rk[k] for k in both], np.int64)
        g["angle"].append(np.abs(np.angle(np.exp(1j * (r["angle"][pi] - ref["angle"][ri])))))
        x = np.bitwise_xor(r["desc"][pi].astype(np.uint32), ref["desc"][ri].astype(np.uint32))
        g["bits"] += int(np.unpackbits(x.view(np.uint8), axis=1).sum())
        g["n_bits"] += 256 * len(both)
        ps, rs = (r["u_right"][pi] >= 0) & (r["depth"][pi] > 0), ref["u_right"][ri] >= 0
        g["flip"] += int((ps != rs).sum())
        g["n_both"] += len(both)
        g["disparity"].append(np.abs(r["u_right"][pi] - ref["u_right"][ri])[ps & rs])
    return g


def reference_frames(out: dict, stream: sc.Stream, cfg, device, dtype=torch.float32) -> dict:
    """The reference's whole-frame answer of each sampled frame, in `dtype`,
    under the allowed region it holds the program to; sets out["gate_off"]
    (the program's gate pixels off it, a frame)."""
    cam = cfg.camera
    res, out["gate_off"] = {}, {}
    for f in out["sampled"]:
        mask = None if stream.masks is None else stream.masks[f]
        gate, out["gate_off"][f] = reference_gate(mask, out["gates"].get(f))
        res[f] = ref_fe.run_frame(stream.left[f], stream.right[f], cfg.orb, cam.fx, cam.bf,
                                  device, dtype, gate=gate)
    return res


def _object_frontend_gaps(out: dict, stream: sc.Stream, cfg, device) -> dict:
    """Gaps of the object frontend's answers at its own keypoints on the
    sampled frames."""
    cam, orb = cfg.camera, cfg.orb
    gaps = dict(angle=[], bits=[], n_bits=0, disparity=[])
    for (k_, f), r in out["frames"].items():
        if k_ != "gaussian":
            continue
        ref = ref_fe.judge_frame(stream.left[f], stream.right[f], r["xy"], r["level"], r["valid"],
                                 r["u_right"], orb.n_levels, orb.scale_factor,
                                 orb.stereo_fine_min_level, device, kind="gaussian")
        k = ref["keep"]
        g = ref_fe.frame_numbers(r["angle"][k], r["desc"][k], r["u_right"][k], r["depth"][k],
                                 r["xy"][k, 0], ref, cam.bf)
        gaps["angle"].append(g["angle"])
        gaps["bits"].append(g["bits"])
        gaps["n_bits"] += 256 * len(k)
        gaps["disparity"].append(g["disparity"])
    return gaps


def _q(x: List[np.ndarray], q: Optional[float]) -> float:
    a = np.concatenate(x) if x else np.zeros(0)
    if len(a) == 0:
        return float("inf")
    return float(np.max(a)) if q is None else float(np.quantile(a, q))


def _camera_excess(out: dict) -> np.ndarray:
    """Per window frame with a pose: the excess cost of the returned pose
    under the frame's last camera pose solve; inf where a tracked frame has
    no such solve (an answer with nothing behind it) or keeps under 3 edges."""
    ex = []
    for f in out["window"]:
        T = out["poses"].get(f)
        if T is None:
            continue
        c = out["pose_lm"].get(f)
        if c is None:
            ex.append(np.inf)
            continue
        e, n = ref_pose.excess_cost(T[None], c["pts"], c["obs"], c["is_stereo"],
                                    c["inv_sigma2"], c["valid"], c["cam"])
        ex.append(e[0] if n[0] >= 3 else np.inf)
    return np.asarray(ex)


def _ba_excess(out: dict) -> np.ndarray:
    """Per point of the window's last camera BA: the excess cost of the
    answer's point with the answer's poses."""
    b = out["ba"]
    if not b:
        return np.zeros(0)
    ex, _ = ref_ba.point_excess(b["ans_poses"], b["ans_points"], b["point_valid"],
                                b["obs_pose"], b["obs_uvr"], b["obs_stereo"],
                                b["obs_inv_sigma2"], b["obs_valid"], b["cam"])
    return ex


def _object_excess(out: dict) -> np.ndarray:
    """Per object lane with edges of each window frame's last object pose
    solve: the excess cost of the solve's answer."""
    ex = []
    for f in out["window"]:
        c = out["obj_lm"].get(f)
        if c is None:
            continue
        lanes = c["valid"].any(axis=1)
        if not lanes.any():
            continue
        e, _ = ref_pose.excess_cost(c["T"][lanes], c["pts"][lanes], c["obs"][lanes],
                                    c["is_stereo"][lanes], c["inv_sigma2"][lanes],
                                    c["valid"][lanes], c["cam"], c["trans_prior"][lanes],
                                    c["prior_w"])
        ex.extend(e.tolist())
    return np.asarray(ex)


def _share(n: int, d: int) -> float:
    return n / d if d else float("inf")


def numbers(out: dict, stream: sc.Stream, cfg, device) -> Dict[str, float]:
    """Every number of NUMBERS that the cell can read (objects: with cars)."""
    if "reference_frames" not in out:
        out["reference_frames"] = reference_frames(out, stream, cfg, device)
    g = _camera_gaps(out, cfg.orb.scale_factor)
    res = {
        "kp_missed_share": _share(g["missed"], g["n_ref"]),
        "kp_extra_share": _share(g["extra"], g["n_prog"]),
        "gate_pixels_off": float(g["gate_off"]),
        "angle_p99_rad": _q(g["angle"], 0.99),
        "desc_bits_share": _share(g["bits"], g["n_bits"]),
        "stereo_flip_share": _share(g["flip"], g["n_both"]),
        "disparity_p99_px": _q(g["disparity"], 0.99),
        "pose_excess_max": _q([_camera_excess(out)], None),
        "ate_share": ref_geo.ate_share(out["traj"], stream.scene.poses_wc, max(out["window"])),
        "ba_excess_p99": _q([_ba_excess(out)], 0.99),
    }
    if stream.scene.cars:
        og = _object_frontend_gaps(out, stream, cfg, device)
        res.update(obj_angle_p99_rad=_q(og["angle"], 0.99),
                   obj_desc_bits_share=_share(float(sum(b.sum() for b in og["bits"])),
                                              og["n_bits"]),
                   obj_disparity_p99_px=_q(og["disparity"], 0.99),
                   obj_pose_excess_p90=_q([_object_excess(out)], 0.9))
        cov = ref_geo.car_coverage(out["objects"], stream.rows, out["window"])
        res["cars_untracked"] = float(len(ref_geo.untracked_cars(cov, CAR_NEAR_M,
                                                                 CAR_MIN_FRAMES)))
    return res


def control_outputs(out: dict, stream: sc.Stream, cfg, device,
                    dtype=torch.bfloat16) -> dict:
    """The reference in the program's place, computed in `dtype`: its own
    whole-frame answers of the camera frontend under the same allowed
    region, its own orientations, descriptors and stereo fits at the object
    frontend's keypoints, its own camera and object pose solves from the
    inputs of the program's, and its own points of the last BA with the
    answer's poses. The trajectory and the objects' tracks stay the
    program's: their limits are the System's guarantees."""
    orb, cam = cfg.orb, cfg.camera
    ctrl = dict(out, frames={})
    low = reference_frames(dict(out), stream, cfg, device, dtype)
    for (kind, f), r in out["frames"].items():
        if kind == "learned":
            ctrl["frames"][(kind, f)] = {k: low[f][k] for k in FIELDS}
            continue
        lo = ref_fe.judge_frame(stream.left[f], stream.right[f], r["xy"], r["level"],
                                r["valid"], r["u_right"], orb.n_levels, orb.scale_factor,
                                orb.stereo_fine_min_level, device, dtype, kind=kind)
        k = lo["keep"]
        c = dict(r, angle=r["angle"].copy(), desc=r["desc"].copy(),
                 u_right=r["u_right"].copy(), depth=r["depth"].copy())
        c["angle"][k] = lo["angle"]
        c["desc"][k] = lo["desc"]
        u = np.where(np.isnan(lo["u_l0"]), lo["u_lvl"], lo["u_l0"])
        st = (r["depth"][k] > 0) & (r["u_right"][k] >= 0) & ~np.isnan(u)
        disp = torch.as_tensor(r["xy"][k, 0] - np.nan_to_num(u)).to(dtype)
        depth = (torch.tensor(cam.bf, dtype=dtype) / disp).double().numpy()
        c["u_right"][k] = np.where(st, u, r["u_right"][k])
        c["depth"][k] = np.where(st, depth, r["depth"][k])
        ctrl["frames"][(kind, f)] = c
    ctrl["poses"] = dict(out["poses"])
    for f, c in out["pose_lm"].items():
        if ctrl["poses"].get(f) is not None:
            ctrl["poses"][f] = ref_pose.solve(c["T_init"], c["pts"], c["obs"], c["is_stereo"],
                                              c["inv_sigma2"], c["valid"], c["cam"],
                                              dtype=dtype)[0]
    if out["ba"]:
        b = out["ba"]
        ctrl["ba"] = dict(b, ans_points=ref_ba.solve_points(
            b["ans_poses"], b["points"], b["point_valid"], b["obs_pose"], b["obs_uvr"],
            b["obs_stereo"], b["obs_inv_sigma2"], b["obs_valid"], b["cam"], dtype))
    ctrl["obj_lm"] = {}
    for f, c in out["obj_lm"].items():
        ctrl["obj_lm"][f] = dict(c, T=ref_pose.solve(
            c["T_init"], c["pts"], c["obs"], c["is_stereo"], c["inv_sigma2"], c["valid"],
            c["cam"], c["trans_prior"], c["prior_w"], dtype=dtype))
    return ctrl


def verdict(nums: Dict[str, float], limits: Dict[str, float], failed: int):
    """(correct, [(name, number, limit)]): every number at or under its
    limit, and no frame lost or raised on."""
    rows = [("frames_failed", float(failed), 0.0)]
    rows += [(k, nums[k], limits[k]) for k in NUMBERS if k in limits]
    missing = [k for k in limits if k not in nums]
    ok = not missing and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
