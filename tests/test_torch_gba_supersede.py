"""A global BA superseded while it solves, in the port's LoopCloser, on the
CPU (no JAX: this is where the port departs from the reference).

The reference's ``_launch_global_ba`` joins the in-flight background GBA
(pointslot_tpu/slam/loop_closing.py:342) while the System holds
``map_lock`` (pointslot_tpu/slam/system.py:210-211), and that GBA's merge
takes the same lock (loop_closing.py:353): a second loop closure while a
GBA is still solving can deadlock. The port does not wait; the stale
merge is dropped by its epoch (pointslot_torch/slam/loop_closing.py,
``_launch_global_ba`` and ``_gba_run``). Here the snapshot, the solve and
the merge are stubs: the first solve blocks until released, and
``_launch_global_ba`` is called twice under ``map_lock``. The second call
returns; the second merge lands; the first, released afterwards, is
dropped and counted as ``gba_aborted``; ``wait_for_gba`` joins both
threads.
"""

import threading

import pytest

from pointslot_torch import config
from pointslot_torch.slam.system import System
from pointslot_torch.utils.profiling import PROFILER

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)


@pytest.fixture()
def system():
    s = System(config.SystemConfig(camera=config.CameraConfig(**CAM),
                                   loop=config.LoopConfig(background_gba=True),
                                   runtime=config.RuntimeConfig(profile=True)), device="cpu")
    yield s
    s.shutdown()


def test_superseded_gba_is_dropped_without_waiting(system):
    lc = system.loop_closer
    release_first = threading.Event()
    first_solving = threading.Event()
    merged = []

    def snapshot(fixed_kf):
        return {"fixed_kf": fixed_kf}

    def solve(snap):
        if snap["fixed_kf"] == 1:
            first_solving.set()
            assert release_first.wait(60), "the first solve was never released"
        return snap["fixed_kf"], {"fixed_kf": snap["fixed_kf"]}

    def merge(snap, result):
        assert system.map_lock._is_owned()
        merged.append(result)

    lc._gba_snapshot, lc._gba_solve, lc._gba_merge = snapshot, solve, merge
    PROFILER.reset()

    def two_loops():
        with system.map_lock:
            lc._launch_global_ba(1)
            assert first_solving.wait(30)
            lc._launch_global_ba(2)   # must not wait for the first solve

    caller = threading.Thread(target=two_loops, daemon=True)
    caller.start()
    caller.join(30)
    assert not caller.is_alive(), "the second _launch_global_ba did not return"
    threads = list(lc._gba_threads)
    assert len(threads) == 2 and threads[0].is_alive()

    threads[1].join(30)
    assert merged == [2] and lc.last_gba_stats == {"fixed_kf": 2}
    assert PROFILER.counters.get("gba_aborted", 0) == 0

    release_first.set()
    lc.wait_for_gba(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not lc.gba_running and lc.gba_errors == []
    assert merged == [2], "the superseded GBA merged"
    assert PROFILER.counters["gba_aborted"] == 1
    assert lc.last_gba_stats == {"fixed_kf": 2}
