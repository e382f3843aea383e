"""device_idle: % of the profiled stretch of frames in which no operation ran
on the device (torch.profiler). The profiler's own host cost lengthens the
stretch, so this is an upper bound."""


def install(tracer):
    pass


def read(tracer):
    t = tracer.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
