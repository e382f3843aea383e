#!/usr/bin/env python3
"""Time the port's PNG decode (pointslot_torch/datasets/png16.py) on a
1242x375 RGB image and its gray twin, by the C unfilter helper and by the
plain numpy unfilter, on this host's CPU.

    python3 scripts/png_decode_time.py

The images are chip_smoke.py's (q1) fixture frame 0 at full width, one
written with each filter type on a fifth of its rows (``png16.write_png``)
and, where PIL imports, one written by PIL (its own filter choice). Prints
the median ms of 9 decodes of each (the first decode, which builds the
helper, is left out), beside the host's CPU model.
"""

import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pointslot_torch.datasets import png16, synthetic  # noqa: E402


def _median_ms(fn, reps: int = 9) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main() -> int:
    scene = synthetic.make_scene(n_frames=1, n_points=2500, n_objects=2, seed=31,
                                 forward_speed=0.8)
    left, right, _ = synthetic.SyntheticRenderer(scene).render(0)
    rgb = np.stack([left, right, left[::-1]], axis=-1).astype(np.uint8)
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    with tempfile.TemporaryDirectory() as d:
        files = {"rgb, filters 0-4 in turn": (Path(d) / "rgb.png", rgb),
                 "gray, filters 0-4 in turn": (Path(d) / "gray.png", rgb[..., 0])}
        for path, img in files.values():
            png16.write_png(str(path), img, cycle_filters=True)
        try:
            from PIL import Image

            Image.fromarray(rgb).save(Path(d) / "pil.png")
            files["rgb, PIL's filters"] = (Path(d) / "pil.png", rgb)
        except ImportError:
            pass
        print(f"host CPU: {cpu}")
        for name, (path, img) in files.items():
            assert np.array_equal(png16.read_png(str(path)), img)
            c_ms = _median_ms(lambda: png16.read_png(str(path)))
            plain_ms = _median_ms(lambda: png16.read_png(str(path), plain=True), reps=3)
            print(f"{img.shape[1]}x{img.shape[0]} {name}, {path.stat().st_size} bytes: C helper "
                  f"{c_ms:.3f} ms, plain unfilter {plain_ms:.3f} ms per decode")
    return 0


if __name__ == "__main__":
    sys.exit(main())
