"""tracking_ms: ms a frame of the camera tracker's self time
(slam/tracking.py, matchers, solvers/pose_opt.py): the span around
``CameraTracker.track`` less the mapping spans inside it (inline mapping runs
from the tracker's keyframe callback)."""


def install(tracer):
    tracer.hook("tracking")
    tracer.hook("mapping")


def read(tracer):
    spans = tracer.spans["tracking"]
    n = tracer.run["frames"]
    if not spans or not n:
        return None
    nested = tracer.spans["mapping"]
    total = 0.0
    for t0, t1, _ in spans:
        inner = sum(min(b, t1) - max(a, t0) for a, b, _ in nested if a < t1 and b > t0)
        total += (t1 - t0) - inner
    return 1e3 * total / n
