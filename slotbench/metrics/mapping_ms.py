"""mapping_ms: ms a keyframe in local mapping and loop detection
(slam/local_mapping.py, slam/loop_closing.py): the span around
``System._process_keyframe_sync``, windowed BA included."""


def install(tracer):
    tracer.hook("mapping")


def read(tracer):
    d = tracer.durations("mapping")
    return 1e3 * sum(d) / len(d) if d else None
