"""The reference checks refuse a trajectory that drifts, a perturbed object
pose, a car left untracked, keypoints left out, a perturbed descriptor, and
stereo depths dropped or moved; they accept the program's own frontend."""

import numpy as np
import torch

from pointslot_torch import convert
from pointslot_torch.config import ORBConfig
from pointslot_torch.ops.frontend import StereoFrontend
from slotbench import check
from slotbench.reference import frontend as ref_fe
from slotbench.reference import geometry as ref_geo
from slotbench.reference import pose as ref_pose
from slotbench.traffic import scene as sc

CAM = sc.Camera(fx=300.0, fy=300.0, cx=256.0, cy=128.0, width=512, height=256, bf=60.0)


def _stream(frames=12, seed=9):
    mix = sc.load_mix("drive_cars4")
    mix["corridor"]["view_ahead_m"] = 40.0
    return sc.generator(mix["generator"]).make_stream(mix, CAM, 10.0, frames, seed, "cpu")


def test_trajectory_check_refuses_a_drift():
    stream = _stream(frames=4)
    gt = stream.scene.poses_wc
    base = np.linalg.inv(gt[0])
    est = {f: base @ gt[f] for f in range(len(gt))}       # the System's world: frame 0
    assert ref_geo.ate_share(est, gt, len(gt) - 1) < 1e-12
    late = {f: np.linalg.inv(gt[1]) @ gt[f] for f in range(1, len(gt))}   # started on frame 1
    assert ref_geo.ate_share(late, gt, len(gt) - 1) < 1e-12
    path = float(np.linalg.norm(np.diff([T[:3, 3] for T in est.values()], axis=0),
                                axis=1).sum())
    for f in est:
        est[f] = est[f].copy()
        est[f][:3, 3] += [0.03 * path * f / (len(gt) - 1), 0.0, 0.0]   # 3 % at the end
    assert ref_geo.ate_share(est, gt, len(gt) - 1) > 0.015
    assert ref_geo.ate_share({}, gt, len(gt) - 1) == float("inf")


def test_car_check_refuses_a_car_left_untracked():
    stream = _stream()
    window = range(stream.scene.n_frames)
    shown = {(int(r[1]), f) for f in window for r in stream.rows[f]}
    assert len({t for t, _ in shown}) >= 2
    poses = {k: np.eye(4) for k in shown}
    cov = ref_geo.car_coverage(poses, stream.rows, window)
    assert ref_geo.untracked_cars(cov, 1e9, 1) == []
    dropped = sorted({t for t, _ in shown})[0]
    cov = ref_geo.car_coverage({k: T for k, T in poses.items() if k[0] != dropped},
                               stream.rows, window)
    assert ref_geo.untracked_cars(cov, 1e9, 1) == [dropped]
    assert ref_geo.untracked_cars(cov, 0.0, 1) == []        # shown near on no frame


def _program_and_reference(gate=False):
    stream = _stream(frames=3)
    f = 1
    g = (stream.masks[f] == 0) if gate else None
    fe = StereoFrontend(CAM.height, CAM.width, CAM.fx, CAM.bf, ORBConfig(), device="cpu")
    fr = convert.frame_record(fe(stream.left[f], stream.right[f], gate=g), f)
    r = {k: np.array(getattr(fr, k)) for k in check.FIELDS}
    if g is not None:                # as System._frame_record checks the gate
        yi = np.clip(np.round(r["xy"][:, 1]).astype(int), 0, CAM.height - 1)
        xi = np.clip(np.round(r["xy"][:, 0]).astype(int), 0, CAM.width - 1)
        r["valid"] &= g[yi, xi]
    ref = ref_fe.run_frame(stream.left[f], stream.right[f], ORBConfig(), CAM.fx, CAM.bf, "cpu",
                           torch.float32, gate=g)
    return f, r, ref


def _gaps(f, r, ref):
    out = dict(frames={("learned", f): r}, reference_frames={f: ref}, gate_off={f: 0})
    return check._camera_gaps(out, ORBConfig().scale_factor)


def test_reference_frontend_is_the_programs():
    for gate in (False, True):
        f, r, ref = _program_and_reference(gate)
        g = _gaps(f, r, ref)
        assert g["n_ref"] > 500 and g["missed"] == 0 and g["extra"] == 0
        assert g["flip"] == 0 and g["bits"] <= 2
        assert np.max(np.concatenate(g["disparity"])) < 1e-3


def test_frontend_check_refuses_keypoints_left_out_and_answers_altered():
    f, r, ref = _program_and_reference()
    half = dict(r, valid=r["valid"] & (np.arange(len(r["valid"])) % 2 == 0))
    g = _gaps(f, half, ref)
    assert g["missed"] / g["n_ref"] > 0.45
    bad = dict(r, desc=r["desc"].copy())
    k = np.nonzero(r["valid"])[0][0]
    bad["desc"][k, 3] ^= np.uint32(1 << 7)              # one bit of one keypoint
    assert _gaps(f, bad, ref)["bits"] == _gaps(f, r, ref)["bits"] + 1
    st = np.nonzero(r["valid"] & (r["u_right"] >= 0))[0]
    dropped = dict(r, u_right=r["u_right"].copy(), depth=r["depth"].copy())
    dropped["u_right"][st[::2]] = -1.0
    dropped["depth"][st[::2]] = -1.0
    g = _gaps(f, dropped, ref)
    assert g["flip"] / g["n_both"] > 0.2
    moved = dict(r, u_right=r["u_right"].copy())
    moved["u_right"][st] += 0.25                          # a quarter pixel of disparity
    assert np.quantile(np.concatenate(_gaps(f, moved, ref)["disparity"]), 0.5) > 0.2


def test_gate_check_refuses_a_part_of_an_object():
    stream = _stream(frames=3)
    mask = stream.masks[1]
    ids = np.unique(mask[mask > 0])
    assert len(ids)
    gate = (mask == 0) | (mask == ids[0])                # the background and one whole car
    assert check.reference_gate(mask, gate)[1] == 0
    ys, xs = np.nonzero(mask == ids[0])
    part = gate.copy()
    part[ys[0], xs[0]] = False                          # that car less one pixel
    assert check.reference_gate(mask, part)[1] > 0
    assert check.reference_gate(mask, None) == (None, 0)


def test_pose_check_refuses_a_perturbed_object_pose():
    rng = np.random.default_rng(3)
    fx, fy, cx, cy, bf = 721.5377, 721.5377, 609.5593, 172.854, 384.38148
    pts = rng.uniform(-0.8, 0.8, (1, 40, 3)) + np.array([1.0, 0.5, 12.0])
    u = fx * pts[..., 0] / pts[..., 2] + cx
    obs = np.stack([u, fy * pts[..., 1] / pts[..., 2] + cy, u - bf / pts[..., 2]], axis=-1)
    ones = np.ones((1, 40))
    args = (pts, obs, ones > 0, ones, ones > 0, (fx, fy, cx, cy, bf))
    limit = check.load_limits("mode4.drive_cars4")["obj_pose_excess_p90"]
    exact, edges = ref_pose.excess_cost(np.eye(4)[None], *args)
    assert edges[0] == 40 and exact[0] < 1e-9
    moved = np.eye(4)[None].copy()
    moved[0, :3, 3] = [0.02, 0.0, 0.0]                   # 2 cm off
    assert ref_pose.excess_cost(moved, *args)[0][0] > limit
