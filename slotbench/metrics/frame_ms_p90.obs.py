"""frame_ms_p90.obs: the 90th percentile of every track_stereo latency in the
window (host clock), as a per-layer reading where the window holds too few
frames for a tail to be an end-to-end metric."""

from slotbench.run import p90_ms


def install(tracer):
    pass


def read(tracer):
    lat = tracer.run["latencies_s"]
    return p90_ms(lat) if len(lat) else None
