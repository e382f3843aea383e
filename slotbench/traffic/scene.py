"""The world the benchmark's streams are rendered from, and its renderer.

A traffic mix is a JSON file beside this one (``traffic/<mix>.json``) of
parameters; its ``generator`` key names the module of this folder
(``traffic/<generator>.py``) that makes the stream from them with
``make_stream(mix, camera, fps, n_frames, seed, device) -> Stream``. A
generator builds a ``Scene`` (camera poses, textured planes, cars) and
renders it with ``render_stream``; a mix that needs another trajectory or
another world brings a generator of its own and edits nothing here.

The world is the port's synthetic one (``datasets/synthetic.py``): infinite
planes textured with multi-octave value noise, and textured boxes splatted
face by face with a depth test. It is written again here in plain torch so
that a whole stream renders on the card in seconds; a CPU test renders the
port's own scene with it and compares the images.
"""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OCTAVES = 6
CAR_TEX = 256
FACE_SAMPLES = 160
SEED_MOD = 2 ** 62


def load_mix(name: str) -> dict:
    """The parameters of traffic mix `name` (``traffic/<name>.json``)."""
    with open(HERE / f"{name}.json", encoding="utf-8") as fh:
        return json.load(fh)


def generator(name: str):
    """The stream generator module `name` (``traffic/<name>.py``)."""
    spec = importlib.util.spec_from_file_location(f"slotbench.traffic.{name}",
                                                  HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Camera:
    """Rectified stereo pinhole camera (the configuration's Camera.* keys)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass
class Plane:
    """Infinite textured plane n . (X - origin) = 0, textured by texture
    `tex` (an index into Scene.textures) at `scale` texels per metre along
    u (columns) and v (rows)."""

    origin: Sequence[float]
    normal: Sequence[float]
    u_ax: Sequence[float]
    v_ax: Sequence[float]
    tex: int
    scale: float = 60.0


@dataclass
class Car:
    """A textured box. poses[i] is its world pose T_wo at frame first + i."""

    track_id: int
    dims: np.ndarray
    first: int
    poses: np.ndarray             # (n, 4, 4) float64
    moving: bool

    def pose(self, frame: int) -> Optional[np.ndarray]:
        i = frame - self.first
        return self.poses[i] if 0 <= i < len(self.poses) else None


@dataclass
class Scene:
    camera: Camera
    poses_wc: np.ndarray          # (N, 4, 4) float64 camera-to-world per frame
    planes: List[Plane]
    textures: List[torch.Tensor]  # (rows, cols) float32 in [0, 1]
    cars: List[Car] = field(default_factory=list)
    car_textures: Optional[torch.Tensor] = None   # (n_cars, 256, 256) float32

    @property
    def n_frames(self) -> int:
        return len(self.poses_wc)


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def grid_shapes(rows: int, cols: int) -> List[tuple]:
    """The value-noise lattice of each octave: 2^(8 - o) texels a cell."""
    return [(rows // 2 ** (OCTAVES - o + 2) + 2, cols // 2 ** (OCTAVES - o + 2) + 2)
            for o in range(OCTAVES)]


def value_noise(grids: Sequence[torch.Tensor], rows: int, cols: int) -> torch.Tensor:
    """Multi-octave value noise in [0, 1] from one lattice per octave,
    bilinear between lattice points (the port's _smooth_noise_texture)."""
    dev = grids[0].device
    out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    amp = 1.0
    for g in grids:
        gh, gw = g.shape
        ys = torch.linspace(0, gh - 1.001, rows, dtype=torch.float64, device=dev)
        xs = torch.linspace(0, gw - 1.001, cols, dtype=torch.float64, device=dev)
        y0, x0 = ys.long(), xs.long()
        fy = (ys - y0).to(torch.float32)[:, None]
        fx = (xs - x0).to(torch.float32)[None, :]
        g00 = g[y0][:, x0]
        g01 = g[y0][:, x0 + 1]
        g10 = g[y0 + 1][:, x0]
        g11 = g[y0 + 1][:, x0 + 1]
        out += amp * (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
                      + g10 * fy * (1 - fx) + g11 * fy * fx)
        del g00, g01, g10, g11
        amp *= 0.55
    out -= out.min()
    out /= torch.clamp(out.max(), min=1e-6)
    return out


def seeded_texture(gen: torch.Generator, rows: int, cols: int) -> torch.Tensor:
    grids = [torch.rand(s, generator=gen, device=gen.device, dtype=torch.float32)
             for s in grid_shapes(rows, cols)]
    return value_noise(grids, rows, cols)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _box_faces(dims: np.ndarray):
    """(origin, u extent, v extent, normal) of the 6 faces of a centred box,
    in datasets/synthetic.py's order."""
    h = np.asarray(dims, np.float64) / 2.0
    faces = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.zeros(3)
            u[(axis + 1) % 3] = h[(axis + 1) % 3]
            v = np.zeros(3)
            v[(axis + 2) % 3] = h[(axis + 2) % 3]
            faces.append((n * h[axis], u, v, n))
    return faces


class Renderer:
    """Ray-cast stereo pairs of a Scene on its textures' device."""

    def __init__(self, scene: Scene):
        self.scene = scene
        cam = scene.camera
        self.device = scene.textures[0].device
        dev = self.device
        us = torch.arange(cam.width, dtype=torch.float64, device=dev)
        vs = torch.arange(cam.height, dtype=torch.float64, device=dev)
        V, U = torch.meshgrid(vs, us, indexing="ij")
        self._rays = torch.stack([(U - cam.cx) / cam.fx, (V - cam.cy) / cam.fy,
                                  torch.ones_like(U)], dim=-1)            # (H, W, 3)
        g = torch.linspace(-1.0, 1.0, FACE_SAMPLES, dtype=torch.float64, device=dev)
        GV, GU = torch.meshgrid(g, g, indexing="ij")
        self._gu, self._gv = GU.reshape(-1), GV.reshape(-1)
        self._ti = ((self._gu + 1) * 127.5).long() % CAR_TEX
        self._tj = ((self._gv + 1) * 127.5).long() % CAR_TEX
        f64 = dict(dtype=torch.float64, device=dev)
        self._planes = [tuple(torch.tensor(a, **f64) for a in (p.normal, p.origin, p.u_ax, p.v_ax))
                        + (scene.textures[p.tex], p.scale) for p in scene.planes]

    @staticmethod
    def _sample(tex: torch.Tensor, tu: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
        """Bilinear, wrap-around sampling: u along columns, v along rows."""
        nr, nc = tex.shape
        tu = torch.remainder(tu, nc)
        tv = torch.remainder(tv, nr)
        u0 = tu.long() % nc
        v0 = tv.long() % nr
        u1 = (u0 + 1) % nc
        v1 = (v0 + 1) % nr
        fu = (tu - torch.floor(tu)).to(torch.float32)
        fv = (tv - torch.floor(tv)).to(torch.float32)
        return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u1] * (1 - fv) * fu
                + tex[v1, u0] * fv * (1 - fu) + tex[v1, u1] * fv * fu)

    def views(self, frames: Sequence[int], shift: float):
        """One eye of each of `frames`, `shift` metres along the camera's x:
        (images float32 in [0, 1], instance masks int32 (track_id + 1,
        0 = background), depth along the ray), each (B, H, W). The planes of
        all the frames are cast at once, the cars frame by frame."""
        scene, cam, dev = self.scene, self.scene.camera, self.device
        H, W = cam.height, cam.width
        T_wc = torch.as_tensor(scene.poses_wc[list(frames)], dtype=torch.float64, device=dev)
        R = T_wc[:, :3, :3]
        C = T_wc[:, :3, 3] + shift * R[:, :, 0]                          # (B, 3)
        dirs = torch.einsum("hwk,bjk->bhwj", self._rays, R)
        B = len(frames)
        img = torch.full((B, H, W), 0.08, dtype=torch.float32, device=dev)
        depth = torch.full((B, H, W), 1e9, dtype=torch.float64, device=dev)
        for n, o, u_ax, v_ax, tex, scale in self._planes:
            denom = dirs @ n
            num = ((o - C) @ n)[:, None, None]
            ok = torch.abs(denom) > 1e-9
            t = torch.where(ok, num / torch.where(ok, denom, torch.ones_like(denom)),
                            torch.full_like(denom, -1.0))
            closer = (t > 0.25) & (t < depth)
            X = C[:, None, None, :] + t[..., None] * dirs
            vals = self._sample(tex, (X @ u_ax) * scale, (X @ v_ax) * scale)
            img = torch.where(closer, vals * 0.85 + 0.05, img)
            depth = torch.where(closer, t, depth)
            del X, t, denom, closer, vals
        inst = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
        if scene.cars:
            for j, f in enumerate(frames):
                img[j], inst[j], depth[j] = self._splat_cars(f, shift, img[j], inst[j], depth[j])
        return img, inst, depth

    def view(self, frame: int, shift: float):
        """`views` of one frame, each (H, W)."""
        return tuple(x[0] for x in self.views([frame], shift))

    def _splat_cars(self, frame, shift, img, inst, depth):
        """Every front face of every car in the frame, FACE_SAMPLES^2 samples
        a face, rounded to pixels, where nearer than the planes: the face of
        the nearest sample takes a pixel, and its last sample there."""
        scene, cam, dev = self.scene, self.scene.camera, self.device
        H, W = cam.height, cam.width
        T_cw = np.linalg.inv(scene.poses_wc[frame])
        T_cw[0, 3] -= shift
        rows = []
        for car in scene.cars:
            T_wo = car.pose(frame)
            if T_wo is None:
                continue
            T_co = T_cw @ T_wo
            R, t = T_co[:3, :3], T_co[:3, 3]
            for origin, u, v, n in _box_faces(car.dims):
                if np.dot(R @ n, R @ origin + t) >= 0:
                    continue   # back face
                rows.append((car.track_id, R, t, origin, u, v))
        if not rows:
            return img, inst, depth
        f64 = dict(dtype=torch.float64, device=dev)
        Rs = torch.as_tensor(np.stack([r[1] for r in rows]), **f64)
        ts = torch.as_tensor(np.stack([r[2] for r in rows]), **f64)
        pts = (torch.as_tensor(np.stack([r[3] for r in rows]), **f64)[:, None, :]
               + self._gu[None, :, None] * torch.as_tensor(np.stack([r[4] for r in rows]), **f64)[:, None, :]
               + self._gv[None, :, None] * torch.as_tensor(np.stack([r[5] for r in rows]), **f64)[:, None, :])
        ids = torch.tensor([r[0] for r in rows], device=dev)
        pc = torch.einsum("fij,fsj->fsi", Rs, pts) + ts[:, None, :]
        z = pc[..., 2]
        safe = torch.where(z > 0.25, z, torch.ones_like(z))
        uu = torch.round(cam.fx * pc[..., 0] / safe + cam.cx).long()
        vv = torch.round(cam.fy * pc[..., 1] / safe + cam.cy).long()
        keep = (z > 0.25) & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
        face = torch.arange(len(rows), device=dev)[:, None].expand_as(z)[keep]
        samp = torch.arange(z.shape[1], device=dev)[None, :].expand_as(z)[keep]
        pix = (vv * W + uu)[keep]
        zk = z[keep]
        flat_depth = depth.reshape(-1)
        zbuf = flat_depth.clone().scatter_reduce_(0, pix, zk, reduce="amin", include_self=True)
        near = (zk == zbuf[pix]) & (zk < flat_depth[pix])
        # the face of the nearest sample takes the pixel; within a face the
        # later sample wins, as the port's renderer writes a face's samples
        top_face = torch.full((H * W,), -1, dtype=torch.long, device=dev)
        top_face.scatter_reduce_(0, pix[near], face[near], reduce="amax", include_self=True)
        win = face == top_face[pix]
        order = torch.arange(len(zk), device=dev)
        best = torch.full((H * W,), -1, dtype=torch.long, device=dev)
        best.scatter_reduce_(0, pix[win], order[win], reduce="amax", include_self=True)
        hit = best >= 0
        b = best[hit]
        tex = scene.car_textures[ids[face[b]], self._tj[samp[b]], self._ti[samp[b]]]
        img = img.reshape(-1).clone()
        img[hit] = 0.15 + 0.8 * tex
        inst = inst.reshape(-1).clone()
        inst[hit] = (ids[face[b]] + 1).to(torch.int32)
        flat_depth = flat_depth.clone()
        flat_depth[hit] = zk[b]
        return img.reshape(H, W), inst.reshape(H, W), flat_depth.reshape(H, W)

    def pairs(self, frames: Sequence[int]):
        """(left uint8, right uint8, left instance masks int32), each
        (B, H, W), on the device."""
        left, inst, _ = self.views(frames, 0.0)
        right, _, _ = self.views(frames, self.scene.camera.baseline)
        to8 = lambda x: (torch.clamp(x, 0, 1) * 255).to(torch.uint8)   # noqa: E731
        return to8(left), to8(right), inst

    def pair(self, frame: int):
        """`pairs` of one frame, each (H, W)."""
        return tuple(x[0] for x in self.pairs([frame]))


# ---------------------------------------------------------------------------
# detections
# ---------------------------------------------------------------------------

def detection_rows(scene: Scene, frame: int) -> np.ndarray:
    """The frame's offline detections as the reference's 1x24 rows
    (datasets/synthetic.py's offline_detection_rows): the box of the
    projected corners, clipped to the image, for cars whose centre is over
    1 m ahead, every corner over 0.2 m ahead and the clipped box at least 12
    px a side. (0, 24) when none."""
    cam = scene.camera
    T_cw = np.linalg.inv(scene.poses_wc[frame])
    rows = []
    for car in scene.cars:
        T_wo = car.pose(frame)
        if T_wo is None:
            continue
        T_co = T_cw @ T_wo
        center = T_co[:3, 3]
        if center[2] < 1.0:
            continue
        hx, hy, hz = car.dims / 2
        corners = np.array([[sx * hx, sy * hy, sz * hz]
                            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
        pc = corners @ T_co[:3, :3].T + T_co[:3, 3]
        if np.any(pc[:, 2] < 0.2):
            continue
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        x0, x1, y0, y1 = u.min(), u.max(), v.min(), v.max()
        if x1 < 0 or y1 < 0 or x0 >= cam.width or y0 >= cam.height:
            continue
        x0c, y0c = max(x0, 0), max(y0, 0)
        x1c, y1c = min(x1, cam.width - 1), min(y1, cam.height - 1)
        if (x1c - x0c) < 12 or (y1c - y0c) < 12:
            continue
        row = np.zeros(24)
        row[0] = frame
        row[1] = car.track_id
        row[5:9] = [x0c, y0c, x1c - x0c, y1c - y0c]
        row[9], row[10], row[11] = car.dims[2], car.dims[1], car.dims[0]
        row[12:15] = center
        row[15] = np.arctan2(T_co[0, 2], T_co[2, 2])
        row[16] = row[17] = 1.0
        row[18] = float(car.moving)
        rows.append(row)
    return np.array(rows).reshape(-1, 24)


@dataclass
class Stream:
    """A rendered stream on the host, as a reader hands it to the System."""

    scene: Scene
    left: np.ndarray              # (N, H, W) uint8
    right: np.ndarray
    masks: Optional[np.ndarray]   # (N, H, W) uint8 instance masks, or None
    rows: List[np.ndarray]        # per frame (n, 24) detection rows
    timestamps: np.ndarray        # (N,) seconds at the camera's rate


def render_stream(scene: Scene, fps: float, chunk: int = 16) -> Stream:
    """Render every frame of `scene` on its device, then bring the pairs
    (and, with cars, the instance masks) to the host in chunks."""
    n = scene.n_frames
    cam = scene.camera
    r = Renderer(scene)
    left = np.empty((n, cam.height, cam.width), np.uint8)
    right = np.empty_like(left)
    masks = np.empty_like(left) if scene.cars else None
    for s in range(0, n, chunk):
        frames = list(range(s, min(s + chunk, n)))
        lv, rv, iv = r.pairs(frames)
        left[s:s + len(frames)] = lv.cpu().numpy()
        right[s:s + len(frames)] = rv.cpu().numpy()
        if masks is not None:
            masks[s:s + len(frames)] = iv.to(torch.uint8).cpu().numpy()
    rows = [detection_rows(scene, i) for i in range(n)] if scene.cars else [np.zeros((0, 24))] * n
    return Stream(scene=scene, left=left, right=right, masks=masks, rows=rows,
                  timestamps=np.arange(n) / float(fps))
