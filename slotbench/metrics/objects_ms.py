"""objects_ms: ms a frame in object tracking (slam/object_system.py): the span
around ``ObjectSystem.process_frame``, the object frontend included."""


def install(tracer):
    tracer.hook("objects")


def read(tracer):
    d = tracer.durations("objects")
    n = tracer.run["frames"]
    return 1e3 * sum(d) / n if d and n else None
