"""The benchmark's renderer draws the port's synthetic world.

The port's numpy renderer (``pointslot_torch/datasets/synthetic.py``) renders
its own scene at a small size; the benchmark's torch renderer renders the same
scene, with the same textures, and the images and instance masks agree.
Also: a seed gives exactly the same stream every time, and two seeds differ.
"""

import numpy as np
import pytest
import torch

from pointslot_torch.config import CameraConfig
from pointslot_torch.datasets import synthetic
from slotbench.traffic import scene as sc

SMALL = dict(fx=150.0, fy=150.0, cx=120.0, cy=56.0, width=240, height=112, bf=150.0 * 0.5)


def _numpy_grids(seed_value: int, n: int):
    rng = np.random.default_rng(seed_value)
    return [torch.from_numpy(rng.uniform(0, 1, size=s).astype(np.float32))
            for s in sc.grid_shapes(n, n)]


def _as_bench_scene(ns, cam: sc.Camera) -> sc.Scene:
    planes, textures = [], []
    for i, p in enumerate(ns.planes):
        planes.append(sc.Plane(tuple(p.origin), tuple(p.normal), tuple(p.u_ax), tuple(p.v_ax),
                               i, p.tex_scale))
        textures.append(sc.value_noise(_numpy_grids(p.tex_seed + ns.seed * 1000, 1024),
                                       1024, 1024))
    cars = [sc.Car(track_id=o.track_id, dims=np.asarray(o.dims, np.float64), first=0,
                   poses=np.stack(o.poses_world), moving=o.is_moving) for o in ns.objects]
    car_tex = torch.stack([sc.value_noise(_numpy_grids(ns.seed * 1000 + 500 + o.track_id, 256),
                                          256, 256) for o in ns.objects])
    return sc.Scene(camera=cam, poses_wc=np.stack(ns.poses_world), planes=planes,
                    textures=textures, cars=cars, car_textures=car_tex)


def test_renders_the_ports_world():
    cam = sc.Camera(**SMALL)
    ns = synthetic.make_scene(n_frames=6, camera=CameraConfig(**SMALL), n_objects=2, seed=3)
    ref = synthetic.SyntheticRenderer(ns)
    r = sc.Renderer(_as_bench_scene(ns, cam))
    for f in (0, 5):
        left_n, right_n, inst_n = ref.render(f)
        left_t, right_t, inst_t = (x.numpy() for x in r.pair(f))
        assert inst_n.any()
        for a, b in ((left_n, left_t), (right_n, right_t)):
            diff = np.abs(a.astype(int) - b.astype(int))
            assert (diff > 2).mean() < 0.01, (diff > 2).mean()
        assert (inst_n != inst_t).mean() < 0.01


def _small_mix():
    mix = sc.load_mix("drive_cars4")
    mix["corridor"]["view_ahead_m"] = 30.0
    mix["corridor"]["texture_across"] = 256
    return mix


def test_seed_gives_the_same_stream_and_two_seeds_differ():
    cam = sc.Camera(**SMALL)
    mix = _small_mix()
    make = sc.generator(mix["generator"]).make_stream
    a = make(mix, cam, 10.0, 8, 2 ** 31 + 11, "cpu")
    b = make(mix, cam, 10.0, 8, 2 ** 31 + 11, "cpu")
    c = make(mix, cam, 10.0, 8, 5, "cpu")
    assert np.array_equal(a.left, b.left) and np.array_equal(a.right, b.right)
    assert np.array_equal(a.masks, b.masks)
    assert all(np.array_equal(x, y) for x, y in zip(a.rows, b.rows))
    assert (a.left != c.left).mean() > 0.5
    # the same work: one trajectory and one multiset of cars for every seed
    assert np.array_equal(a.scene.poses_wc, c.scene.poses_wc)
    assert len(a.scene.cars) == len(c.scene.cars)


@pytest.mark.parametrize("mix", ["drive", "drive_cars4"])
def test_mix_loads_by_name(mix):
    m = sc.load_mix(mix)
    assert m["warmup_frames"] > 0 and m["check_frames"] > 0
    assert ("cars" in m) == (mix == "drive_cars4")
