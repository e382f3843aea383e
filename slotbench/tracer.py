"""The benchmark's own tracing: spans around the calls into the program's
layers, installed from outside, and the reduction of a profiler trace.

Spans are taken only in traced runs (``--trace 1``). Each wraps one call into
a layer of the port, ends in ``torch.cuda.synchronize()`` so that it covers
the layer's device work, and is named in the profiler trace as
``slotbench.<layer>`` so that idle gaps can be told by what the host was
doing. A span records (start, end, window frame). Every hook goes through
the run's one registry (``hooks.Hooks``). Per-layer metric readers
(``metrics/<metric>.py``) install the hooks they need by name and reduce
what was recorded.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

TOP = 10


class Tracer:
    def __init__(self, system, device: torch.device, hooks):
        self.system = system
        self.device = device
        self.hooks = hooks              # the run's one registry (hooks.Hooks)
        self.spans: Dict[str, List[tuple]] = defaultdict(list)
        self.frame = -1                 # index of the window frame in flight
        self.profiling = False          # inside the profiled stretch
        self.trace: Optional[dict] = None
        self.gathers: List[tuple] = []  # patch gathers of the profiled stretch
        self.run: dict = {}             # what the harness measured (latencies, frames)
        self._hooks = set()

    # ------------------------------------------------------------------
    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_attr(self, obj, name: str, value):
        self.hooks.set(obj, name, value)

    def timed(self, name: str, fn):
        """`fn` wrapped in a span `name` that ends after the device is done."""
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"slotbench.{name}"):
                out = fn(*args, **kwargs)
                self.sync()
            self.spans[name].append((t0, time.perf_counter(), self.frame))
            return out
        return wrapped

    def hook(self, name: str):
        """Install the named span once: frontend, tracking, mapping,
        objects, ba_device, patch_gather."""
        if name in self._hooks:
            return
        self._hooks.add(name)
        getattr(self, f"_hook_{name}")()

    # ------------------------------------------------------------------
    def _hook_frontend(self):
        """From the call of the camera's frontend to the return of the
        frame's host record (its one device-to-host transfer)."""
        sysm, tracer = self.system, self
        inner = sysm.frontend

        class Proxy:
            def __call__(self, *args, **kwargs):
                tracer._frontend_t0 = time.perf_counter()
                with torch.profiler.record_function("slotbench.frontend"):
                    return inner(*args, **kwargs)

            def __getattr__(self, attr):
                return getattr(inner, attr)

        record = sysm._frame_record

        def frame_record(*args, **kwargs):
            out = record(*args, **kwargs)
            self.sync()
            t0 = getattr(self, "_frontend_t0", None)
            if t0 is not None:
                self.spans["frontend"].append((t0, time.perf_counter(), self.frame))
                self._frontend_t0 = None
            return out

        self.set_attr(sysm, "frontend", Proxy())
        self.set_attr(sysm, "_frame_record", frame_record)

    def _hook_tracking(self):
        tr = self.system.tracker
        self.set_attr(tr, "track", self.timed("tracking", tr.track))

    def _hook_mapping(self):
        s = self.system
        self.set_attr(s, "_process_keyframe_sync", self.timed("mapping", s._process_keyframe_sync))

    def _hook_objects(self):
        obj = self.system._object_system
        if obj is not None:
            self.set_attr(obj, "process_frame", self.timed("objects", obj.process_frame))

    def _hook_ba_device(self):
        """Device ms of each windowed BA call: CUDA events around
        bundle_adjust (camera) and bundle_adjust_batched (objects)."""
        from pointslot_torch.solvers import local_ba

        def timed(fn):
            def wrapped(*args, **kwargs):
                if self.device.type != "cuda":
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    self.spans["ba_device"].append((t0, time.perf_counter(), self.frame))
                    return out
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
                self.spans["ba_device"].append((0.0, ms / 1e3, self.frame))
                return out
            return wrapped

        for name in ("bundle_adjust", "bundle_adjust_batched"):
            self.hooks.wrap(local_ba, name, timed)

    def _hook_patch_gather(self):
        """The planes' shapes and the keypoints of every patch gather the
        kernel makes inside the profiled stretch (no device work added)."""
        from pointslot_torch.ops import patch

        launch = patch.gather_patches_cuda

        def record(planes, xyl):
            if self.profiling:
                self.gathers.append(([tuple(p.shape) for p in planes], xyl))
            return launch(planes, xyl)

        self.set_attr(patch, "gather_patches_cuda", record)

    # ------------------------------------------------------------------
    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for t0, t1, _ in self.spans[name]]


def _ns(e, what: str) -> float:
    fn = getattr(e, f"{what}_ns", None)
    return float(fn()) if fn is not None else 1e3 * float(getattr(e, f"{what}_us")())


def reduce_trace(prof, window_s: float) -> dict:
    """Device activity of a profiled stretch: busy seconds (the union of
    every kernel, copy and set on the device; the spans' annotations, which
    the profiler also draws on the device's timeline, are left out), the
    operations launched,
    device seconds by operation name, and the longest idle gaps, each named
    by the innermost benchmark span and the innermost host operation that
    covered its middle."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == DeviceType.CUDA and not (annotation
                                                       or e.name().startswith("slotbench.")):
            dev.append((start, start + dur, e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, e.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, n in dev:
        by_name[n] += (t - s) * 1e-9
    spans = sorted((s, t) for s, t, _ in dev)
    busy, gaps, cur = 0.0, [], None
    for s, t in spans:
        if cur is None:
            cur = [s, t]
        elif s <= cur[1]:
            cur[1] = max(cur[1], t)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
    if cur is not None:
        busy += cur[1] - cur[0]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(mid: float) -> str:
        cover = [(t - s, n) for s, t, n in host if s <= mid <= t]
        ours = sorted((d, n) for d, n in cover if n.startswith("slotbench."))
        ops = sorted((d, n) for d, n in cover if not n.startswith("slotbench."))
        layer = ours[0][1][len("slotbench."):] if ours else "harness"
        return f"{layer}: {ops[0][1][:80]}" if ops else layer

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        busy_s=busy * 1e-9, window_s=window_s, launches=len(dev), kernel_s=dict(by_name),
        device_ops=[[n[:120], s] for n, s in top_ops],
        idle_gaps=[[label(0.5 * (a + b)), (b - a) * 1e-9] for a, b in gaps[:TOP]])
