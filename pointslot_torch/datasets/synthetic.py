"""Synthetic stereo SLOT scene generator (numpy).

A copy of the pieces of ``pointslot_tpu/datasets/synthetic.py`` that drive
the per-frame hot path and the System: ``make_scene`` (a camera driving
through a textured corridor with moving boxes ahead), ``make_loop_scene``
(a closed circle inside a textured room, the loop-closing fixture),
``SyntheticRenderer`` (ray-cast stereo pairs + instance masks) and
``offline_detection_rows`` (the reference's 1x24 detection rows). Same
seeds, same images.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pointslot_torch.config import CameraConfig


def _smooth_noise_texture(rng: np.random.Generator, h: int, w: int, octaves: int = 6) -> np.ndarray:
    """Multi-octave value-noise texture in [0, 1] — corners at all scales."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        step = 2 ** (octaves - o + 2)
        gh, gw = h // step + 2, w // step + 2
        g = rng.uniform(0, 1, size=(gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        v = (
            g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx
        )
        out += amp * v
        amp *= 0.55
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


@dataclass
class Plane:
    """Infinite textured plane: n . (X - origin) = 0."""

    origin: np.ndarray          # (3,)
    normal: np.ndarray          # (3,) unit, pointing toward the viewable side
    u_ax: np.ndarray            # (3,) texture axes (unit, orthogonal)
    v_ax: np.ndarray
    tex_seed: int = 0
    tex_scale: float = 60.0     # texture pixels per meter


@dataclass
class SyntheticObject:
    """A moving textured box: pose trajectory + dimensions."""

    track_id: int
    dims: np.ndarray                     # (3,) x, y, z extents in object frame
    poses_world: List[np.ndarray] = field(default_factory=list)  # per-frame T_wo
    is_moving: bool = True


@dataclass
class SyntheticScene:
    camera: CameraConfig
    n_frames: int
    poses_world: List[np.ndarray]        # per-frame camera T_wc (camera-to-world)
    planes: List[Plane]
    objects: List[SyntheticObject]
    seed: int = 0

    @property
    def T_cw(self) -> List[np.ndarray]:
        return [np.linalg.inv(T) for T in self.poses_world]


def _corridor_planes(half_width: float = 8.0, ground_y: float = 1.6,
                     ceil_y: float = -6.0, seed: int = 0) -> List[Plane]:
    ex = np.array([1.0, 0, 0]); ey = np.array([0, 1.0, 0]); ez = np.array([0, 0, 1.0])
    return [
        Plane(np.array([0, ground_y, 0.0]), -ey, ex, ez, tex_seed=seed + 1),
        Plane(np.array([-half_width, 0, 0.0]), ex, ez, ey, tex_seed=seed + 2),
        Plane(np.array([half_width, 0, 0.0]), -ex, ez, ey, tex_seed=seed + 3),
        Plane(np.array([0, ceil_y, 0.0]), ey, ex, ez, tex_seed=seed + 4),
    ]


def _box_planes(x0, x1, z0, z1, ground_y=1.6, ceil_y=-8.0, seed=0) -> List[Plane]:
    ex = np.array([1.0, 0, 0]); ey = np.array([0, 1.0, 0]); ez = np.array([0, 0, 1.0])
    return [
        Plane(np.array([0, ground_y, 0.0]), -ey, ex, ez, tex_seed=seed + 1),
        Plane(np.array([x0, 0, 0.0]), ex, ez, ey, tex_seed=seed + 2),
        Plane(np.array([x1, 0, 0.0]), -ex, ez, ey, tex_seed=seed + 3),
        Plane(np.array([0, 0, z0]), ez, ex, ey, tex_seed=seed + 4),
        Plane(np.array([0, 0, z1]), -ez, ex, ey, tex_seed=seed + 5),
        Plane(np.array([0, ceil_y, 0.0]), ey, ex, ez, tex_seed=seed + 6),
    ]


def make_scene(
    n_frames: int = 30,
    camera: Optional[CameraConfig] = None,
    n_points: int = 3000,          # kept for API compat; density is texture-driven now
    n_objects: int = 2,
    seed: int = 0,
    forward_speed: float = 1.0,
    yaw_rate: float = 0.004,
) -> SyntheticScene:
    """Camera drives forward (+z) with slight yaw through a textured corridor;
    objects are boxes moving ahead of the camera (KITTI-like)."""
    cam = camera or CameraConfig()
    rng = np.random.default_rng(seed)

    poses = []
    T = np.eye(4)
    for i in range(n_frames):
        poses.append(T.copy())
        c, s = np.cos(yaw_rate), np.sin(yaw_rate)
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        step = np.eye(4)
        step[:3, :3] = Ry
        step[:3, 3] = Ry @ np.array([0, 0, forward_speed])
        T = T @ step

    objects = []
    for k in range(n_objects):
        dims = np.array([1.6, 1.5, 3.5])
        lateral = -3.0 + 6.0 * (k % 2) + rng.normal(scale=0.3)
        z0 = 8.0 + 4.0 * k
        speed = forward_speed * (0.5 + 0.4 * k)
        obj_poses = []
        for i in range(n_frames):
            Two = np.eye(4)
            Two[:3, 3] = np.array([lateral, 0.85, z0 + speed * i])
            obj_poses.append(Two)
        objects.append(
            SyntheticObject(track_id=k, dims=dims, poses_world=obj_poses,
                            is_moving=speed > 1e-3)
        )

    return SyntheticScene(
        camera=cam, n_frames=n_frames, poses_world=poses,
        planes=_corridor_planes(seed=seed), objects=objects, seed=seed,
    )


def make_loop_scene(
    n_frames: int = 40,
    camera: Optional[CameraConfig] = None,
    n_points: int = 3000,          # unused; API compat
    seed: int = 0,
    radius: float = 6.0,
    n_objects: int = 0,
) -> SyntheticScene:
    """Closed circular trajectory (camera returns to the start) inside a
    textured room — the loop-closure fixture. With n_objects > 0, textured
    boxes drive ahead of the camera along the same circle (staying in view
    for the whole run — the long-sequence object-tracking fixture)."""
    cam = camera or CameraConfig()
    yaw_rate = 2 * np.pi / n_frames
    forward = radius * yaw_rate

    # continue a quarter turn past closure so the revisited region produces
    # several keyframes (loop detection needs consecutive consistent hits)
    total = n_frames + n_frames // 3
    poses = []
    T = np.eye(4)
    for _ in range(total):
        poses.append(T.copy())
        c, s = np.cos(yaw_rate), np.sin(yaw_rate)
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        step = np.eye(4)
        step[:3, :3] = Ry
        step[:3, 3] = Ry @ np.array([0, 0, forward])
        T = T @ step

    centers = np.stack([p[:3, 3] for p in poses])
    margin = 6.0
    planes = _box_planes(
        centers[:, 0].min() - margin, centers[:, 0].max() + margin,
        centers[:, 2].min() - margin, centers[:, 2].max() + margin,
        seed=seed,
    )
    objects = []
    for k in range(n_objects):
        dims = np.array([1.6, 1.5, 3.0])
        lead = max(n_frames // 8, 12) + 5 * k  # frames ahead on the circle
        lateral = -2.5 + 5.0 * (k % 2)
        obj_poses = []
        for i in range(total):
            Tc = poses[min(i + lead, total - 1)]
            Two = Tc.copy()
            Two[:3, 3] = Tc[:3, 3] + Tc[:3, :3] @ np.array([lateral, 0.85, 0.0])
            obj_poses.append(Two)
        objects.append(
            SyntheticObject(track_id=k, dims=dims, poses_world=obj_poses,
                            is_moving=True)
        )

    return SyntheticScene(
        camera=cam, n_frames=total, poses_world=poses,
        planes=planes, objects=objects, seed=seed,
    )


def _box_faces(dims: np.ndarray):
    """6 faces of an axis-aligned box centered at origin:
    (origin, u_axis*extent, v_axis*extent, normal)."""
    hx, hy, hz = dims / 2.0
    faces = []
    for axis, h in ((0, hx), (1, hy), (2, hz)):
        for sign in (-1.0, 1.0):
            n = np.zeros(3); n[axis] = sign
            u = np.zeros(3); u[(axis + 1) % 3] = 1.0
            v = np.zeros(3); v[(axis + 2) % 3] = 1.0
            origin = n * h
            extent_u = [hx, hy, hz][(axis + 1) % 3]
            extent_v = [hx, hy, hz][(axis + 2) % 3]
            faces.append((origin, u * extent_u, v * extent_v, n))
    return faces


class SyntheticRenderer:
    """Ray-casting stereo renderer: textured planes + object boxes."""

    TEX = 1024

    def __init__(self, scene: SyntheticScene):
        self.scene = scene
        cam = scene.camera
        self._tex = {
            p.tex_seed: _smooth_noise_texture(
                np.random.default_rng(p.tex_seed + scene.seed * 1000),
                self.TEX, self.TEX,
            )
            for p in scene.planes
        }
        self._obj_tex = [
            _smooth_noise_texture(
                np.random.default_rng(scene.seed * 1000 + 500 + o.track_id), 256, 256
            )
            for o in scene.objects
        ]
        # precompute the pixel ray grid in CAMERA coords
        H, W = cam.height, cam.width
        us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        self._rays_cam = np.stack(
            [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy, np.ones_like(us)],
            axis=-1,
        )

    # ------------------------------------------------------------------
    def _sample_tex(self, tex: np.ndarray, tu: np.ndarray, tv: np.ndarray):
        """Bilinear, wrap-around texture sampling."""
        n = tex.shape[0]
        tu = np.mod(tu, n); tv = np.mod(tv, n)
        u0 = tu.astype(int) % n; v0 = tv.astype(int) % n
        u1 = (u0 + 1) % n; v1 = (v0 + 1) % n
        fu = tu - np.floor(tu); fv = tv - np.floor(tv)
        return (
            tex[v0, u0] * (1 - fv) * (1 - fu)
            + tex[v0, u1] * (1 - fv) * fu
            + tex[v1, u0] * fv * (1 - fu)
            + tex[v1, u1] * fv * fu
        )

    def _render_one(self, frame_idx: int, baseline_shift: float):
        scene = self.scene
        cam = scene.camera
        H, W = cam.height, cam.width
        T_wc = scene.poses_world[frame_idx]
        R_wc = T_wc[:3, :3]
        C = T_wc[:3, 3] + R_wc @ np.array([baseline_shift, 0.0, 0.0])

        dirs_w = self._rays_cam @ R_wc.T                     # (H, W, 3)
        img = np.full((H, W), 0.08, np.float32)
        depth = np.full((H, W), 1e9, np.float32)

        for plane in scene.planes:
            denom = dirs_w @ plane.normal                    # (H, W)
            num = (plane.origin - C) @ plane.normal
            denom_safe = np.where(np.abs(denom) > 1e-9, denom, 1.0)
            t = np.where(np.abs(denom) > 1e-9, num / denom_safe, -1.0)
            hit = t > 0.25
            t_safe = np.where(hit, t, 1e9)
            closer = hit & (t_safe < depth)
            if not closer.any():
                continue
            X = C[None, None, :] + t[..., None] * dirs_w
            tu = (X @ plane.u_ax) * plane.tex_scale
            tv = (X @ plane.v_ax) * plane.tex_scale
            vals = self._sample_tex(self._tex[plane.tex_seed], tu, tv)
            img = np.where(closer, vals * 0.85 + 0.05, img)
            depth = np.where(closer, t, depth)

        inst = np.zeros((H, W), np.uint8)
        for oi, obj in enumerate(scene.objects):
            if frame_idx >= len(obj.poses_world):
                continue
            T_co = np.linalg.inv(T_wc) @ obj.poses_world[frame_idx]
            # account for the stereo eye offset: object pose in THIS eye
            T_co = np.linalg.inv(
                np.block([[np.eye(3), np.array([[baseline_shift], [0], [0]])],
                          [np.zeros((1, 3)), np.ones((1, 1))]])
            ) @ T_co
            tex = self._obj_tex[oi]
            for origin, uax, vax, normal in _box_faces(obj.dims):
                n_cam = T_co[:3, :3] @ normal
                center = T_co[:3, :3] @ origin + T_co[:3, 3]
                if np.dot(n_cam, center) >= 0:
                    continue  # back face
                n_samp = 160
                gu = np.linspace(-1, 1, n_samp)
                GU, GV = np.meshgrid(gu, gu)
                pts_obj = (
                    origin[None, :]
                    + GU.reshape(-1, 1) * uax[None, :]
                    + GV.reshape(-1, 1) * vax[None, :]
                )
                pc = (T_co[:3, :3] @ pts_obj.T).T + T_co[:3, 3]
                zz = pc[:, 2]
                ok = zz > 0.25
                uu = np.round(cam.fx * pc[ok, 0] / zz[ok] + cam.cx).astype(int)
                vv = np.round(cam.fy * pc[ok, 1] / zz[ok] + cam.cy).astype(int)
                zv = zz[ok]
                inb = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
                uu, vv, zv = uu[inb], vv[inb], zv[inb]
                ti = ((GU.reshape(-1)[ok][inb] + 1) * 127.5).astype(int)
                tj = ((GV.reshape(-1)[ok][inb] + 1) * 127.5).astype(int)
                tvals = tex[tj % 256, ti % 256]
                closer = zv < depth[vv, uu]
                uu, vv, zv, tvals = uu[closer], vv[closer], zv[closer], tvals[closer]
                depth[vv, uu] = zv
                img[vv, uu] = 0.15 + 0.8 * tvals
                inst[vv, uu] = oi + 1
        return (np.clip(img, 0, 1) * 255).astype(np.uint8), inst, depth

    def render(self, frame_idx: int):
        """Returns (left, right, instance_mask_left) uint8 arrays."""
        cam = self.scene.camera
        left, inst, _ = self._render_one(frame_idx, 0.0)
        right, _, _ = self._render_one(frame_idx, cam.baseline)
        return left, right, inst

    def render_left(self, frame_idx: int) -> np.ndarray:
        """The left view alone, uint8 (what ``render`` returns first)."""
        return self._render_one(frame_idx, 0.0)[0]

    def render_with_depth(self, frame_idx: int):
        """Returns (left, right, instance_mask_left, depth_left)."""
        cam = self.scene.camera
        left, inst, depth = self._render_one(frame_idx, 0.0)
        right, _, _ = self._render_one(frame_idx, cam.baseline)
        return left, right, inst, depth


def offline_detection_rows(scene: SyntheticScene) -> np.ndarray:
    """Per-frame object detections in the reference's 1x24-row layout
    (reference src/Tracking.cc:574-610). Frames with no objects get a single
    row with track_id = -1 like the reference's padding."""
    cam = scene.camera
    rows = []
    for f in range(scene.n_frames):
        T_cw = np.linalg.inv(scene.poses_world[f])
        any_obj = False
        for obj in scene.objects:
            if f >= len(obj.poses_world):
                continue
            T_co = T_cw @ obj.poses_world[f]
            center = T_co[:3, 3]
            if center[2] < 1.0:
                continue
            hx, hy, hz = obj.dims / 2
            corners = np.array(
                [
                    [sx * hx, sy * hy, sz * hz]
                    for sx in (-1, 1)
                    for sy in (-1, 1)
                    for sz in (-1, 1)
                ]
            )
            pc = (T_co[:3, :3] @ corners.T).T + T_co[:3, 3]
            if np.any(pc[:, 2] < 0.2):
                continue
            u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
            v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
            x0, x1 = u.min(), u.max()
            y0, y1 = v.min(), v.max()
            if x1 < 0 or y1 < 0 or x0 >= cam.width or y0 >= cam.height:
                continue
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, cam.width - 1), min(y1, cam.height - 1)
            if (x1c - x0c) < 12 or (y1c - y0c) < 12:
                continue
            R_co = T_co[:3, :3]
            rot_y = np.arctan2(R_co[0, 2], R_co[2, 2])
            row = np.zeros(24)
            row[0] = f
            row[1] = obj.track_id
            row[5:9] = [x0c, y0c, x1c - x0c, y1c - y0c]
            row[9] = obj.dims[2]   # length
            row[10] = obj.dims[1]  # height
            row[11] = obj.dims[0]  # width
            row[12:15] = center
            row[15] = rot_y
            row[16] = 1.0
            row[17] = 1.0
            row[18] = float(obj.is_moving)
            rows.append(row)
            any_obj = True
        if not any_obj:
            row = np.zeros(24)
            row[0] = f
            row[1] = -1
            rows.append(row)
    return np.array(rows)


def kitti_label_text(scene: SyntheticScene, n_frames: int) -> str:
    """The object rows of `scene`'s first `n_frames` frames as a
    KITTI-tracking ``label_02`` file, with Y at the bottom centre of the
    box, which ``datasets.kitti.read_kitti_object_rows`` reads back."""
    rows = offline_detection_rows(scene)
    lines = []
    for r in rows[(rows[:, 1] >= 0) & (rows[:, 0] < n_frames)]:
        x0, y0, w, h = r[5:9]
        lines.append(
            f"{int(r[0])} {int(r[1])} Car {r[2]:.2f} {int(r[3])} {r[4]:.6f} "
            f"{x0:.2f} {y0:.2f} {x0 + w:.2f} {y0 + h:.2f} {r[10]:.2f} {r[11]:.2f} {r[9]:.2f} "
            f"{r[12]:.6f} {r[13] + r[10] / 2.0:.6f} {r[14]:.6f} {r[15]:.6f}")
    return "\n".join(lines) + "\n"


def map_table_from_frame(frame, cam: CameraConfig, M: int = 2048,
                         T_cw: Optional[np.ndarray] = None):
    """Local-map table from one stereo frame: every valid feature with a
    depth, unprojected (the stereo-initialisation map, or a keyframe's
    refresh). `frame` holds numpy xy, depth, desc (uint32), valid. Points
    are in the camera frame, or in the world frame when the frame's pose
    T_cw is given. Returns pos (M, 3) f32, desc (M, 8) uint32, level (M,)
    int32, valid (M,)."""
    xy, depth = frame.xy, frame.depth
    keep = np.nonzero(frame.valid & (depth > 0))[0][:M]
    n = len(keep)
    z = depth[keep]
    pc = np.stack([(xy[keep, 0] - cam.cx) * z / cam.fx,
                   (xy[keep, 1] - cam.cy) * z / cam.fy, z], axis=1)
    if T_cw is not None:
        T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
        pc = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
    pos = np.zeros((M, 3), np.float32)
    desc = np.zeros((M, 8), np.uint32)
    level = np.zeros(M, np.int32)
    valid = np.zeros(M, bool)
    pos[:n] = pc
    desc[:n] = frame.desc[keep]
    valid[:n] = True
    return pos, desc, level, valid


def object_tables_from_frame(scene: SyntheticScene, frame_idx: int, inst: np.ndarray,
                             frame, O: int = 2, Mo: int = 256):
    """Object-frame point tables from one frame's instance mask and the
    offline detection rows (the mode-4 object init): each object's features
    with a depth, moved into the object frame by the detection's pose.
    Returns pos (O, Mo, 3) f32, desc (O, Mo, 8) uint32, valid (O, Mo) and
    T_co (O, 4, 4) f32 camera-from-object poses."""
    cam = scene.camera
    rows = offline_detection_rows(scene)
    rows = rows[(rows[:, 0] == frame_idx) & (rows[:, 1] >= 0)][:O]
    xy, depth = frame.xy, frame.depth
    valid = frame.valid & (depth > 0)
    yi = np.clip(np.round(xy[:, 1]).astype(int), 0, inst.shape[0] - 1)
    xi = np.clip(np.round(xy[:, 0]).astype(int), 0, inst.shape[1] - 1)
    mask_val = inst[yi, xi]
    obj_pos = np.zeros((O, Mo, 3), np.float32)
    obj_desc = np.zeros((O, Mo, 8), np.uint32)
    obj_valid = np.zeros((O, Mo), bool)
    T_init = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
    for o, row in enumerate(rows):
        # the instance mask holds track_id + 1; row[12:15] is the object
        # centre in the camera frame, row[15] its yaw
        keep = np.nonzero(valid & (mask_val == int(row[1]) + 1))[0][:Mo]
        if len(keep) == 0:
            continue
        z = depth[keep]
        pc = np.stack([(xy[keep, 0] - cam.cx) * z / cam.fx,
                       (xy[keep, 1] - cam.cy) * z / cam.fy, z], axis=1)
        T_co = np.eye(4)
        T_co[:3, 3] = row[12:15]
        c, s = np.cos(row[15]), np.sin(row[15])
        T_co[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T_oc = np.linalg.inv(T_co)
        obj_pos[o, :len(keep)] = pc @ T_oc[:3, :3].T + T_oc[:3, 3]
        obj_desc[o, :len(keep)] = frame.desc[keep]
        obj_valid[o, :len(keep)] = True
        T_init[o] = T_co.astype(np.float32)
    return obj_pos, obj_desc, obj_valid, T_init
