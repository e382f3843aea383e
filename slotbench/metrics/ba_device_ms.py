"""ba_device_ms: device ms a call of the windowed BA (solvers/local_ba.py),
between CUDA events around ``bundle_adjust`` (camera) and
``bundle_adjust_batched`` (objects)."""


def install(tracer):
    tracer.hook("ba_device")


def read(tracer):
    d = tracer.durations("ba_device")
    return 1e3 * sum(d) / len(d) if d else None
