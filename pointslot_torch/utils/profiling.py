"""Per-stage timing registry + metric counters.

A copy of ``pointslot_tpu/utils/profiling.py`` (``Profiler``, ``PROFILER``):
a process-wide registry of named host-clock timers (context managers) and
counters, dumped as one JSON blob. The System turns it on with
``RuntimeConfig.profile``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, list] = defaultdict(list)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timer(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0):
        if self.enabled:
            self.counters[name] += value

    def summary(self) -> dict:
        out = {"counters": dict(self.counters), "stages": {}}
        for name, samples in self.times.items():
            a = np.asarray(samples)
            out["stages"][name] = {
                "n": len(a),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
            }
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    def reset(self):
        self.times.clear()
        self.counters.clear()


# process-wide default registry
PROFILER = Profiler()
