"""Run one cell of BENCHMARK.json on the card and print its result line.

    python -m slotbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds the cell's configuration (``configs/<config>.yaml``, read by the
port's ``config.load_yaml``), renders the cell's stream on the card from the
seed (``traffic/<mix>.json``, made by the generator its ``generator`` key
names, ``traffic/<generator>.py``), builds the System, warms it up on the
stream's first frames, then drives ``System.track_stereo`` in a closed loop
for ``--seconds``: the next frame goes in when the last one returns. The
frame that crosses the deadline closes the window. With ``--trace 0`` it
reports the cell's end-to-end metrics (host clock); with ``--trace 1`` the
per-layer metrics, each read by ``metrics/<metric>.py`` from the spans that
``tracer.py`` records and from a profiled stretch of the window. Then it
judges what the window produced (``check.py``) and prints one JSON line last.

The run exits non-zero, printing no result, without a CUDA card, without the
program, or if ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "pointslot_tpu")


def _started_s_ago() -> float:
    """Seconds since this process started (Linux /proc), 0.0 if unknown."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


BEFORE_IMPORT_S = _started_s_ago()

# every cache of a run stays inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slotbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, kind: str, cell: str):
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def frames_per_s(n_frames: int, window_s: float) -> float:
    """Frames completed in the window over the window's seconds."""
    return n_frames / window_s if window_s > 0 else 0.0


def p90_ms(latencies_s) -> float:
    """90th percentile of every frame's latency in the window, in ms."""
    import numpy as np
    return 1e3 * float(np.quantile(np.asarray(latencies_s), 0.9)) if len(latencies_s) else float("nan")


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg=None, mix: Optional[dict] = None,
             limits: Optional[dict] = None, control: bool = False,
             also_control: bool = False) -> dict:
    """One run of a cell; returns the result object. `cfg`, `mix` and
    `limits` stand in for the cell's own (the CPU tests' small sizes);
    `control` judges the reference in bfloat16 in the program's place
    instead of the program; `also_control` adds the control's numbers
    (``control_numbers``) beside the program's."""
    import numpy as np
    import torch

    from pointslot_torch.config import SLOTMode, load_yaml
    from pointslot_torch.ops import patch
    from pointslot_torch.slam.objects import Detection
    from pointslot_torch.slam.system import System
    from pointslot_torch.slam.tracking import TrackingState
    from slotbench import check
    from slotbench.capture import Capture
    from slotbench.hooks import Hooks
    from slotbench.reference import geometry as ref_geo
    from slotbench.tracer import Tracer, reduce_trace
    from slotbench.traffic import scene as sc

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    dev = torch.device(device)
    cfg = cfg or load_yaml(str(ROOT / config["file"]))
    mix = mix or sc.load_mix(cell["traffic"])
    limits = limits or check.load_limits(cell_name)
    cam = cfg.camera
    warm = int(mix["warmup_frames"])
    n_frames = warm + int(round(float(mix["stream_frames_per_window_s"]) * seconds))

    # the stream, on the device from the seed, then on the host as a reader hands it
    t = time.perf_counter()
    stream = sc.generator(mix["generator"]).make_stream(
        mix, sc.Camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf), cam.fps,
        n_frames, seed, dev)
    objects = cfg.slot_mode in (SLOTMode.MANUAL_TRACKING, SLOTMode.AUTONOMOUS_DRIVING,
                                SLOTMode.OFFLINE)
    dets = [[Detection.from_row24(r, mask_value=int(r[1]) + 1) for r in rows]
            for rows in stream.rows] if objects else None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _log(f"stream: {n_frames} stereo pairs {cam.width}x{cam.height}, "
         f"{len(stream.scene.cars)} cars, rendered in {time.perf_counter() - t:.3f} s")

    system = System(cfg, device=device)

    def frame_args(i):
        kw = {}
        if objects:
            kw = dict(detections=dets[i], instance_mask=stream.masks[i])
        return (stream.left[i], stream.right[i], float(stream.timestamps[i]), i), kw

    t = time.perf_counter()
    for i in range(warm):
        a, kw = frame_args(i)
        system.track_stereo(*a, **kw)
    if dev.type == "cuda":
        torch.cuda.current_stream().synchronize()
    obj = system._object_system
    _log(f"warm-up: {warm} frames in {time.perf_counter() - t:.3f} s; keyframes "
         f"{system.map.n_keyframes()}, camera BA calls {system.local_mapper.ba_calls}"
         + (f", object BA calls {obj.ba_calls}, tracks {len(obj.all_tracks)}" if obj else ""))

    hooks = Hooks()
    capture = Capture(system, hooks)

    tracer = None
    layer = cell_metrics(bench, "per_layer", cell_name)
    if trace:
        tracer = Tracer(system, dev, hooks)
        modules = {m["name"]: metric_module(m["name"]) for m in layer}
        for mod in modules.values():
            mod.install(tracer)
    skip, n_trace = int(mix["trace_skip_frames"]), int(mix["trace_frames"])
    launches0 = patch.LAUNCHES
    records, latencies, kf_frames, window = {}, [], [], []
    failed, first_error, prof, stream_end = 0, None, None, False
    sync = (torch.cuda.current_stream().synchronize if dev.type == "cuda" else (lambda: None))
    setup_s = BEFORE_IMPORT_S + time.perf_counter() - T_IMPORT
    t_start = time.perf_counter()
    i = warm
    while True:
        if i >= n_frames:
            stream_end = True
            break
        k = i - warm
        if tracer is not None:
            tracer.frame = k
            if k == skip:
                sync()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                tracer.profiling = True
                t_prof = time.perf_counter()
        a, kw = frame_args(i)
        capture.frame = i
        uid = system.map._next_uid
        t0 = time.perf_counter()
        try:
            records[i] = system.track_stereo(*a, **kw)
            sync()
            if system.tracking_state == TrackingState.LOST:
                failed += 1
        except Exception:   # a frame that raises is a failed answer; the run goes on
            failed += 1
            first_error = first_error or traceback.format_exc()
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        window.append(i)
        if system.map._next_uid != uid:
            kf_frames.append(k)
        i += 1
        last = t1 - t_start >= seconds
        if tracer is not None and tracer.profiling and (k == skip + n_trace - 1 or last):
            sync()
            prof_window = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            tracer.profiling = False
            traced_frames = k - skip + 1
        if last:
            break
    window_s = time.perf_counter() - t_start
    hooks.uninstall()
    if tracer is not None and tracer.profiling:      # the stream ended inside the stretch
        prof_window = time.perf_counter() - t_prof
        prof.__exit__(None, None, None)
        tracer.profiling = False
        traced_frames = len(window) - skip
    if stream_end:
        _log(f"the stream ended after {len(window)} window frames, before {seconds} s: "
             f"the window ends there")
    if first_error:
        _log(f"a frame raised:\n{first_error}")
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    n = len(window)
    lat_ms = 1e3 * np.asarray(latencies)
    p90 = p90_ms(latencies)
    kf_lat = lat_ms[kf_frames] if kf_frames else np.zeros(0)
    _log(f"window: {n} frames in {window_s:.6f} s, {len(kf_frames)} keyframe frames "
         f"({100.0 * len(kf_frames) / max(n, 1):.1f} %); latency ms median "
         f"{float(np.median(lat_ms)) if n else float('nan'):.3f}, p90 {p90:.3f}; keyframe frames "
         f"at or above p90: {int((kf_lat >= p90).sum())} of {int((lat_ms >= p90).sum())}; "
         f"lost or raised {failed}")
    _log(f"counters: patch_gather launches {patch.LAUNCHES - launches0} in the window "
         f"({(patch.LAUNCHES - launches0) / max(n, 1):.2f} a frame), camera BA calls "
         f"{system.local_mapper.ba_calls}, keyframes {system.map.n_keyframes()}, points "
         f"{system.map.n_points()}"
         + (f", loops closed {system.loop_closer.loops_closed}" if system.loop_closer else "")
         + (f", object BA calls {obj.ba_calls}, tracks {len(obj.all_tracks)}" if obj else ""))

    result = {"correct": False, "attempted": n, "failed": failed}
    if trace:
        if prof is not None:
            tracer.trace = reduce_trace(prof, prof_window)
            tracer.trace["frames"] = traced_frames
        tracer.run = dict(frames=n, latencies_s=latencies, window_s=window_s)
        metrics = {}
        for m in layer:
            v = modules[m["name"]].read(tracer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"fps": frames_per_s(n, window_s), "frame_ms_p90": p90,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(bench, "end_to_end", cell_name)}

    sampled = check.sample_frames(window, latencies, int(mix["check_frames"]), seed) if n else []
    out = check.collect(system, records, capture, window,
                        [window[k] for k in kf_frames], [f for f in sampled if f in records])
    try:
        system.shutdown()
    except Exception:   # the mapping worker or the GBA thread failed: not correct
        failed += 1
        _log(f"shutdown raised:\n{traceback.format_exc()}")
    del system, records
    if tracer is not None:
        tracer.system = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    judged = check.control_outputs(out, stream, cfg, dev) if control else out
    nums = check.numbers(judged, stream, cfg, dev) if n else {}
    ok, rows = check.verdict(nums, limits, failed)
    if stream.scene.cars and n:
        cov = ref_geo.car_coverage(out["objects"], stream.rows, out["window"])
        _log(f"cars (track id: window frames shown, with a pose, shown within "
             f"{check.CAR_NEAR_M:g} m before the first pose there): " + "; ".join(
                 f"{t}: {len(v)}, {sum(p for _, _, p in v)}, "
                 f"{ref_geo.frames_near_before_pose(v, check.CAR_NEAR_M)}"
                 for t, v in cov.items()))
    _log(f"check took {time.perf_counter() - t:.3f} s on {len(out['sampled'])} sampled frames "
         f"{out['sampled']}" + (" (the bfloat16 control in the program's place)" if control else ""))

    result.update(correct=bool(ok), failed=failed, metrics=metrics)
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": memory_peak}
    if trace and tracer.trace:
        result["device"].update(busy_s=tracer.trace["busy_s"], window_s=tracer.trace["window_s"])
        result["breakdown"] = {"device_ops": tracer.trace["device_ops"],
                               "idle_gaps": tracer.trace["idle_gaps"]}
    if also_control and n:
        result["control_numbers"] = check.numbers(check.control_outputs(out, stream, cfg, dev),
                                                  stream, cfg, dev)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    result["numbers"] = nums
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    cells = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not cells:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cells[0]["chips"]:
        _log(f"{args.workload} needs {cells[0]['chips']} CUDA card(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
             f"device_count = {torch.cuda.device_count()}")
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        _log(f"modules of JAX or the JAX package are loaded: {found}")
        return 4
    result.pop("numbers")
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
