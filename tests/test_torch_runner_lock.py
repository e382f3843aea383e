"""The runner draws its top-down map only from state read under
``System.map_lock``.

Async mapping (the CLI default) writes the map's points, validity,
keyframe poses and keyframe set under that lock, so a drawing that reads
them without it can be torn. The port copies what the drawing needs under
the lock (``viz.render.map_snapshot``, plain arrays) and draws them outside
it (``viz.render.draw_map``). A test double
of the map raises on any read made while the lock is free: the snapshot
passes, the live System drawn directly (the reference runner's way) does
not; and ``--viz`` with async mapping, on 4 synthetic frames at 512x256 on
the CPU, reads the live map only under the lock.
"""

import threading

import numpy as np
import pytest
import torch

from pointslot_torch import run
from pointslot_torch.viz import render

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
GUARDED = ("pt_pos", "pt_valid", "kf_pose", "kf_valid", "keyframe_ids")


class LockedReads:
    """Proxy of a map: reading a guarded field while `lock` is not held by
    this thread raises."""

    def __init__(self, inner, lock):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_lock", lock)
        object.__setattr__(self, "reads", 0)

    def __getattribute__(self, name):
        if name in GUARDED:
            lock = object.__getattribute__(self, "_lock")
            assert lock._is_owned(), f"map.{name} read without map_lock"
            object.__setattr__(self, "reads", object.__getattribute__(self, "reads") + 1)
            return getattr(object.__getattribute__(self, "_inner"), name)
        return object.__getattribute__(self, name)


class FakeMap:
    def __init__(self, rng):
        self.pt_pos = rng.normal(size=(50, 3)) * [5, 1, 10]
        self.pt_valid = rng.random(50) > 0.2
        self.kf_valid = np.array([True, True, False, True])
        self.kf_pose = np.tile(np.eye(4), (4, 1, 1))
        self.kf_pose[:, 2, 3] = [0.0, -2.0, -3.0, -4.0]

    def keyframe_ids(self):
        return np.nonzero(self.kf_valid)[0]


class FakeSystem:
    """A System double: its map may be read only under map_lock."""

    def __init__(self):
        self.map_lock = threading.RLock()
        self.map = LockedReads(FakeMap(np.random.default_rng(0)), self.map_lock)
        self._object_system = None

    def camera_trajectory(self):
        return [(i, self.map.kf_pose[k], False) for i, k in enumerate(self.map.keyframe_ids())]


def test_map_is_drawn_from_state_read_under_the_lock():
    system = FakeSystem()
    with pytest.raises(AssertionError, match="without map_lock"):
        render.draw_map_topdown(system, size=64)
    with system.map_lock:
        want = render.draw_map_topdown(system, size=64)
    got = render.draw_map(render.map_snapshot(system), size=64)
    np.testing.assert_array_equal(got, want)
    assert system.map.reads > 0
    np.testing.assert_array_equal(run._draw_map(system),
                                  render.draw_map(render.map_snapshot(system)))


def test_viz_with_async_mapping_reads_the_map_under_the_lock(tmp_path, monkeypatch):
    """--viz with async mapping: every map read made for the drawing holds
    map_lock, and the drawing gets a copy, not the live arrays."""
    pytest.importorskip("PIL")
    cfg = tmp_path / "calib.yaml"
    cfg.write_text("%YAML:1.0\n" + "".join(f"Camera.{k}: {v}\n" for k, v in CAM.items())
                   + "Camera.fps: 10.0\nORBextractor.nFeatures: 1000\n"
                     "Tracking.MinInitStereoFeatures: 300\n")
    snapshot, draw = render.map_snapshot, render.draw_map
    seen = []

    def guarded_snapshot(system):
        live = system.map
        system.map = LockedReads(live, system.map_lock)
        try:
            view = snapshot(system)
        finally:
            system.map = live
        seen.append(system)
        for got, arr in ((view.points, live.pt_pos), (view.keyframe_poses, live.kf_pose)):
            assert not np.shares_memory(got, arr)
        assert system.cfg.runtime.async_mapping
        return view

    def checked_draw(view, *a, **k):
        assert isinstance(view, render.MapSnapshot), "drawn from the live System"
        return draw(view, *a, **k)

    monkeypatch.setattr(render, "map_snapshot", guarded_snapshot)
    monkeypatch.setattr(render, "draw_map", checked_draw)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = run.main(["--platform", "cpu", "--synthetic", "4", "--config", str(cfg),
                       "--mode", "0", "--no-loop", "--viz", "1", "--out", str(tmp_path / "o")])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    assert len(seen) == 1
    assert (tmp_path / "o" / "map_topdown.png").exists()
