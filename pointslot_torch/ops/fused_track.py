"""The mode-4 per-frame hot path: camera tracking step + batched object phase.

Port of ``pointslot_tpu/ops/fused_track.py`` (``FusedTrackStep``, gated
and ungated, ``FusedObjectPhase``, ``FusedFrameStep.__call__``). The camera
half runs the stereo frontend (under a gate: detection restricted to the
mask, then each feature checked against it at level-0 coordinates),
projection matching at radius 7 against the local
map, a pose LM, matching at radius 4 at the refined pose, a second LM and
the constant-velocity update. The object half matches every object's point
table and solves all object poses in one batched LM.

The step has no host sync (no ``.item()``, ``.cpu()`` or branch on device
data): the host uploads the images and may leave every result on the
device, chaining poses and velocities into the next step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pointslot_torch.config import SystemConfig
from pointslot_torch.convert import to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops.frontend import StereoFrame, StereoFrontend
from pointslot_torch.slam import matchers
from pointslot_torch.solvers import pose_opt


class FusedStepResult(NamedTuple):
    T_cw: torch.Tensor               # (4, 4) optimized pose
    velocity: torch.Tensor           # (4, 4) updated constant-velocity model
    point_for_feature: torch.Tensor  # (N,) int32 map row bound per feature (-1)
    n_inliers: torch.Tensor          # () int32 final inlier count
    xy: torch.Tensor                 # (N, 2) frame features
    level: torch.Tensor              # (N,) int32
    desc: torch.Tensor               # (N, 8) int32 words
    angle: torch.Tensor              # (N,)
    depth: torch.Tensor              # (N,)
    u_right: torch.Tensor            # (N,)
    valid: torch.Tensor              # (N,) bool


class _Camera:
    """Camera intrinsics and pyramid scales shared by both halves."""

    def __init__(self, config: SystemConfig, device: torch.device):
        cam = config.camera
        # projection intrinsics + image size (matching), and + bf (pose LM)
        self.proj = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                         cy=float(cam.cy), width=cam.width, height=cam.height)
        self.cam = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                        cy=float(cam.cy), bf=float(cam.bf))
        self.scales = torch.tensor(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)],
            dtype=torch.float32).to(device)

    def edges(self, pf, rows_pos, xy, level, u_right, depth, feat_valid):
        """Pose-LM edge set of features bound to map rows (pf >= 0).
        rows_pos (B, N, 3) are the bound points; the rest (B, N)."""
        n_lv = self.scales.shape[0]
        inv_sigma2 = 1.0 / self.scales[torch.clamp(level, 0, n_lv - 1).long()] ** 2
        B = pf.shape[0]
        obs = torch.stack([xy[:, 0], xy[:, 1], u_right], dim=-1).expand(B, -1, -1)
        return dict(pts=rows_pos, obs=obs, is_stereo=(depth > 0).expand(B, -1),
                    inv_sigma2=inv_sigma2.expand(B, -1), valid=(pf >= 0) & feat_valid)


def gate_at_keypoints(gate: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The mask's value at each keypoint's rounded level-0 pixel: the exact
    per-feature check that coarse-level gating leaks a few boundary
    features past (the reference's AssignFeatures, src/Frame.cc:810-844)."""
    xi = torch.clamp(torch.round(xy[:, 0]).long(), 0, gate.shape[1] - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).long(), 0, gate.shape[0] - 1)
    return gate[yi, xi]


def _bind(pos: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """pos (B, M, 3), pf (B, N) -> (B, N, 3) rows, clamped for unbound."""
    rows = torch.clamp(pf, 0, pos.shape[1] - 1).long()
    return pos.gather(1, rows[..., None].expand(-1, -1, 3))


class FusedTrackStep:
    """(left, right, T_prev, velocity, map tables) -> FusedStepResult.

    map tables: pos (M, 3) f32, desc (M, 8) int32 words, level (M,) int32
    predicted octave, valid (M,) bool. M is a static capacity; callers pad.
    """

    def __init__(self, config: SystemConfig, device="cuda",
                 frontend: Optional[StereoFrontend] = None):
        """`frontend`: a StereoFrontend to share (the System's); its device
        is the step's. Without one the step builds its own on `device`."""
        self.device = frontend.device if frontend is not None else resolve_device(device)
        self.cfg = config
        cam = config.camera
        self.frontend = frontend or StereoFrontend(cam.height, cam.width, cam.fx, cam.bf,
                                                   config.orb, device=self.device)
        self._c = _Camera(config, self.device)

    def __call__(self, left, right, T_prev, velocity,
                 map_pos, map_desc, map_level, map_valid, gate=None) -> FusedStepResult:
        """gate: optional (H, W) bool allowed-region mask (the background of
        mode 4)."""
        d = self.device
        return self.run(
            to_tensor(left, None, d), to_tensor(right, None, d),
            to_tensor(T_prev, torch.float32, d), to_tensor(velocity, torch.float32, d),
            to_tensor(map_pos, torch.float32, d), to_tensor(map_desc, torch.int32, d),
            to_tensor(map_level, torch.int32, d), to_tensor(map_valid, torch.bool, d),
            None if gate is None else to_tensor(gate, torch.bool, d),
        )

    def _match_stage(self, sf: StereoFrame, T, map_pos, map_desc, map_level,
                     map_valid, radius: float):
        res = matchers.project_and_match(
            map_pos[None], map_desc[None], map_valid[None], T[None],
            sf.xy, sf.level, sf.desc, sf.valid, radius,
            self._c.scales, map_level[None],
            th_desc=matchers.TH_HIGH, level_window=2, **self._c.proj,
        )
        return res.point_for_feature[0]

    def _solve_stage(self, sf: StereoFrame, pf, T_init, map_pos):
        e = self._c.edges(pf[None], _bind(map_pos[None], pf[None]), sf.xy, sf.level,
                          sf.u_right, sf.depth, sf.valid)
        r = pose_opt.pose_optimize(T_init[None], **e, **self._c.cam)
        return r.T[0], r.inliers[0], r.n_inliers[0]

    def run(self, left, right, T_prev, velocity,
            map_pos, map_desc, map_level, map_valid, gate=None) -> FusedStepResult:
        """The step on device tensors."""
        frame = self.frontend.run(left, right, gate)
        if gate is not None:
            frame = frame._replace(valid=frame.valid & gate_at_keypoints(gate, frame.xy))
        T_pred = velocity @ T_prev
        # stage 1: motion-model window, radius 7
        pf1 = self._match_stage(frame, T_pred, map_pos, map_desc, map_level,
                                map_valid, radius=7.0)
        T1, _, _ = self._solve_stage(frame, pf1, T_pred, map_pos)
        # stage 2: local-map window at the refined pose, radius 4; features
        # matched in stage 1 keep their binding where stage 2 found nothing
        pf2 = self._match_stage(frame, T1, map_pos, map_desc, map_level,
                                map_valid, radius=4.0)
        pf = torch.where(pf2 >= 0, pf2, pf1)
        T2, inliers, n_inliers = self._solve_stage(frame, pf, T1, map_pos)
        pf_final = torch.where(inliers, pf, torch.full_like(pf, -1))
        vel_new = T2 @ torch.linalg.inv_ex(T_prev)[0]
        return FusedStepResult(T2, vel_new, pf_final, n_inliers,
                               frame.xy, frame.level, frame.desc, frame.angle,
                               frame.depth, frame.u_right, frame.valid)


class FusedObjectPhase:
    """(frame features, per-object point tables, T_co) -> batched object poses.

    Tables: obj_pos (O, Mo, 3) points in the object frame, obj_desc
    (O, Mo, 8) int32 words, obj_valid (O, Mo); T_prev (O, 4, 4)
    camera-from-object poses.
    """

    def __init__(self, config: SystemConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = config
        self._c = _Camera(config, self.device)

    def __call__(self, feat_xy, feat_level, feat_desc, feat_valid,
                 feat_depth, feat_uright, obj_pos, obj_desc, obj_valid,
                 T_prev, velocity=None):
        """Returns (T_new, velocity_new, n_inliers), all on the device."""
        d = self.device
        obj_pos = to_tensor(obj_pos, torch.float32, d)
        if velocity is None:
            velocity = torch.eye(4, device=d).expand(obj_pos.shape[0], 4, 4)
        return self.run(
            to_tensor(feat_xy, torch.float32, d), to_tensor(feat_level, torch.int32, d),
            to_tensor(feat_desc, torch.int32, d), to_tensor(feat_valid, torch.bool, d),
            to_tensor(feat_depth, torch.float32, d), to_tensor(feat_uright, torch.float32, d),
            obj_pos, to_tensor(obj_desc, torch.int32, d), to_tensor(obj_valid, torch.bool, d),
            to_tensor(T_prev, torch.float32, d), to_tensor(velocity, torch.float32, d),
        )

    def run(self, feat_xy, feat_level, feat_desc, feat_valid, feat_depth,
            feat_uright, obj_pos, obj_desc, obj_valid, T_prev, velocity):
        """The phase on device tensors."""
        O, Mo = obj_pos.shape[:2]
        # constant-velocity prediction per object
        T0 = velocity @ T_prev
        res = matchers.project_and_match(
            obj_pos, obj_desc, obj_valid, T0,
            feat_xy, feat_level, feat_desc, feat_valid, 7.0,
            self._c.scales, torch.zeros((O, Mo), dtype=torch.int32, device=obj_pos.device),
            th_desc=matchers.TH_HIGH, level_window=8, **self._c.proj,
        )
        pf = res.point_for_feature
        e = self._c.edges(pf, _bind(obj_pos, pf), feat_xy, feat_level,
                          feat_uright, feat_depth, feat_valid)
        r = pose_opt.pose_optimize(T0, **e, **self._c.cam)
        vel_new = r.T @ torch.linalg.inv_ex(T_prev)[0]
        return r.T, vel_new, r.n_inliers


class FusedFrameStep:
    """Camera step + batched object phase: the whole mode-4 frame."""

    def __init__(self, config: SystemConfig, device="cuda"):
        self.device = resolve_device(device)
        self.step = FusedTrackStep(config, device=self.device)
        self.phase = FusedObjectPhase(config, device=self.device)

    @property
    def frontend(self):
        return self.step.frontend

    def __call__(self, left, right, T_prev, velocity,
                 map_pos, map_desc, map_level, map_valid,
                 obj_pos, obj_desc, obj_valid, T_obj, vel_obj=None):
        """Returns (FusedStepResult, T_obj', vel_obj', obj_n_inliers), all
        on the device and chainable into the next frame."""
        r = self.step(left, right, T_prev, velocity,
                      map_pos, map_desc, map_level, map_valid)
        T_new, vel_new, n_inl = self.phase(
            r.xy, r.level, r.desc, r.valid, r.depth, r.u_right,
            obj_pos, obj_desc, obj_valid, T_obj, vel_obj,
        )
        return r, T_new, vel_new, n_inl
