"""patch_gather_roofline: % of its roofline that the patch gather reaches
(csrc/patch_gather.cu) in the profiled stretch: the least time the card's
memory could take for the work, over the device time of every
patch_gather kernel in the trace.

The work is a copy with no arithmetic, so the bound is bytes over the H100's
3.35 TB/s (NVIDIA's data sheet, SXM, 700 W). The bytes are counted from the
keypoints gathered, whatever kernel does the work: every patch written
(48 x 48 float32), its 12 bytes of coordinates, and every source pixel that
a window covers inside a plane, read once."""

from slotbench.roofline import HBM_BYTES_PER_S, gather_bytes

KERNEL = "patch_gather"


def install(tracer):
    tracer.hook("patch_gather")


def read(tracer):
    t = tracer.trace
    if not t or not tracer.gathers:
        return None
    kernel_s = sum(s for name, s in t["kernel_s"].items() if KERNEL in name)
    if kernel_s <= 0:
        return None
    nbytes = sum(gather_bytes(shapes, xyl) for shapes, xyl in tracer.gathers)
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / kernel_s
