"""frontend_ms: ms a frame in the camera's frontend (ops/frontend.py, pyramid,
fast, orb, stereo), from the call of ``system.frontend`` to the return of
``System._frame_record``, the frame's one device-to-host transfer. The object
frontend counts in objects_ms."""


def install(tracer):
    tracer.hook("frontend")


def read(tracer):
    d = tracer.durations("frontend")
    n = tracer.run["frames"]
    return 1e3 * sum(d) / n if d and n else None
