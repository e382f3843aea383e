"""A cell run at a small size on the CPU, for the harness's tests."""

from __future__ import annotations

from pointslot_torch.config import CameraConfig, TrackingConfig, load_yaml
from slotbench import check, run
from slotbench.traffic import scene as sc

SMALL_CAMERA = CameraConfig(fx=300.0, fy=300.0, cx=256.0, cy=128.0, width=512, height=256,
                            bf=60.0)


def small_run(cell: str, seed: int = 2 ** 31 + 5, trace: bool = False, control: bool = False,
              frames: int = 6):
    bench = run.load_benchmark()
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_yaml(str(run.ROOT / conf["file"])).replace(
        camera=SMALL_CAMERA, tracking=TrackingConfig(min_init_stereo_features=300))
    mix = sc.load_mix(w["traffic"])
    mix["corridor"]["view_ahead_m"] = 40.0
    # a window of `frames` frames: the stream ends there, whatever the clock
    seconds = 1e4
    mix.update(warmup_frames=6, stream_frames_per_window_s=frames / seconds, trace_skip_frames=1,
               trace_frames=2)
    # every compared number is a gap to a reference on the same inputs, so
    # the cell's limits hold at this size too
    limits = check.load_limits(cell)
    return run.run_cell(bench, cell, seed, seconds, trace, device="cpu", cfg=cfg,
                        mix=mix, limits=limits, control=control)
