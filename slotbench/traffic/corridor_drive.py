"""Generator of the corridor drives (mixes ``drive`` and ``drive_cars4``).

A KITTI-like drive through a corridor of four textured planes: forward at
the mix's speed, the heading a slow cosine, and with a ``cars`` block cars
spawned along the route in fixed lanes, some parked, some moving ahead. The
textures run along the drive without repeating (the mix sets their length),
so no two places of one drive look alike and loop detection finds no false
loop.

Everything random comes from the seed: the textures of the corridor and of
the cars, from a ``torch.Generator`` on the device. Every seed of a mix gives
the same trajectory and the same cars (times in view, lanes, speeds, order):
seeds change the pixels, not the traffic, so that they change the work as
little as a scene can.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from slotbench.traffic.scene import (CAR_TEX, SEED_MOD, Camera, Car, Plane, Scene, Stream,
                                     _rot_y, grid_shapes, render_stream, seeded_texture,
                                     value_noise)


def make_stream(mix: dict, camera: Camera, fps: float, n_frames: int, seed: int,
                device) -> Stream:
    """The mix's drive of `n_frames` frames from `seed`, rendered on
    `device` and brought to the host; the textures are let go."""
    scene = make_drive(mix, camera, n_frames, seed, device)
    stream = render_stream(scene, fps)
    scene.textures, scene.car_textures = [], None
    return stream


def drive_poses(n: int, speed: float, amp: float, period: float) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses: forward along +z at `speed` metres a
    frame, the heading a cosine of amplitude `amp` rad and period `period`
    frames, so the car weaves within amp * period / (2 pi) metres of the
    corridor's axis."""
    poses = np.zeros((n, 4, 4))
    pos = np.zeros(3)
    for i in range(n):
        yaw = amp * math.cos(2.0 * math.pi * i / period)
        poses[i, :3, :3] = _rot_y(yaw)
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
        pos = pos + speed * np.array([math.sin(yaw), 0.0, math.cos(yaw)])
    return poses


def corridor_planes(half_width: float, ground_y: float, ceil_y: float,
                    scale: float) -> List[Plane]:
    """Ground, left wall, right wall, ceiling (datasets/synthetic.py's
    _corridor_planes): along the drive (+z) run the walls' columns and the
    ground's and ceiling's rows."""
    ex, ey, ez = (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    neg = lambda v: tuple(-x for x in v)   # noqa: E731
    return [
        Plane((0.0, ground_y, 0.0), neg(ey), ex, ez, 0, scale),
        Plane((-half_width, 0.0, 0.0), ex, ez, ey, 1, scale),
        Plane((half_width, 0.0, 0.0), neg(ex), ez, ey, 2, scale),
        Plane((0.0, ceil_y, 0.0), ey, ex, ez, 3, scale),
    ]


def spawn_cars(mix: dict, poses_wc: np.ndarray) -> List[Car]:
    """Cars along the route. Car k (k from -prespawn) appears at frame
    k * spawn_every, in lane k mod len(lanes), at the distance ahead from
    which it needs its time in view D to reach `exit_m` ahead of the camera
    (D (1 - s / speed) frames of closing at relative speed). The times in
    view are `durations_cycle` values evenly spread over [lo, hi], shuffled
    by the mix's `order_seed` and taken in turn, so that a shorter stream
    holds the first cars of a longer one; each lane has a fixed lateral
    position and speed (0 = parked)."""
    c = mix["cars"]
    n = len(poses_wc)
    every = int(c["spawn_every_frames"])
    pre = int(c["prespawn"])
    lo, hi = c["in_view_frames"]
    lanes = c["lanes"]
    count = pre + -(-n // every)
    cycle = int(c["durations_cycle"])
    durations = np.linspace(lo, hi, cycle)
    durations = durations[np.random.default_rng(int(c["order_seed"])).permutation(cycle)]
    speed = float(mix["speed_m_per_frame"])
    dims = np.asarray(c["dims_m"], np.float64)
    linger = int(c["linger_frames"])
    cars = []
    for j in range(count):
        k = j - pre
        f0 = k * every
        x, s = lanes[k % len(lanes)]
        D = float(durations[j % cycle])
        z_cam = poses_wc[f0, 2, 3] if f0 >= 0 else f0 * speed
        z0 = z_cam + float(c["exit_m"]) + D * (speed - s)
        first = max(f0, 0)
        last = min(int(math.ceil(f0 + D)) + linger, n - 1)
        if last < first:
            continue
        frames = np.arange(first, last + 1)
        poses = np.tile(np.eye(4), (len(frames), 1, 1))
        poses[:, 0, 3] = x
        poses[:, 1, 3] = float(c["center_y_m"])
        poses[:, 2, 3] = z0 + s * (frames - f0)
        cars.append(Car(track_id=len(cars), dims=dims, first=first, poses=poses,
                        moving=s != 0.0))
    return cars


def make_drive(mix: dict, camera: Camera, n_frames: int, seed: int,
               device) -> Scene:
    """The mix's drive of `n_frames` frames, its textures drawn from `seed`
    on `device`."""
    poses = drive_poses(n_frames, float(mix["speed_m_per_frame"]),
                        float(mix["yaw_amplitude_rad"]), float(mix["yaw_period_frames"]))
    corridor = mix["corridor"]
    scale = float(corridor["texels_per_m"])
    planes = corridor_planes(float(corridor["half_width_m"]), float(corridor["ground_y_m"]),
                             float(corridor["ceiling_y_m"]), scale)
    # along the drive, one texture spans the whole route and the view ahead
    along = int(math.ceil(scale * (n_frames * float(mix["speed_m_per_frame"])
                                   + float(corridor["view_ahead_m"]))))
    across = int(corridor["texture_across"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    shapes = [(along, across), (across, along), (across, along), (along, across)]
    textures = [seeded_texture(gen, r, c) for r, c in shapes]
    cars = spawn_cars(mix, poses) if mix.get("cars") else []
    car_tex = None
    if cars:
        grids = [torch.rand((len(cars),) + s, generator=gen, device=gen.device)
                 for s in grid_shapes(CAR_TEX, CAR_TEX)]
        car_tex = torch.stack([value_noise([g[i] for g in grids], CAR_TEX, CAR_TEX)
                               for i in range(len(cars))])
    return Scene(camera=camera, poses_wc=poses, planes=planes, textures=textures,
                 cars=cars, car_textures=car_tex)
