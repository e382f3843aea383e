"""The metric arithmetic: a rate over the whole window, p90 over every frame,
and the patch gather's byte count."""

import numpy as np
import pytest
import torch

from slotbench import roofline, run


def test_rate_is_all_frames_over_all_the_window():
    assert run.frames_per_s(45, 45.0) == 1.0
    assert run.frames_per_s(101, 50.5) == 2.0
    assert run.frames_per_s(0, 0.0) == 0.0


def test_p90_is_over_every_frame():
    lat = [0.1] * 90 + [1.0] * 10          # seconds
    assert run.p90_ms(lat) == pytest.approx(1e3 * np.quantile(lat, 0.9))
    assert run.p90_ms(list(range(1, 101))) == pytest.approx(1e3 * 90.1)


def _brute_bytes(shapes, xyl):
    """Every pixel of every 48x48 window inside its plane, counted once."""
    seen = set()
    L = len(shapes)
    for x, y, r in xyl.tolist():
        r = min(max(r, 0), L - 1)
        h, w = shapes[r][-2:]
        for dy in range(-24, 24):
            for dx in range(-24, 24):
                if 0 <= y + dy < h and 0 <= x + dx < w:
                    seen.add((r, y + dy, x + dx))
    K = len(xyl)
    return 4 * len(seen) + 12 * K + 4 * K * 48 * 48


def test_gather_bytes_counts_each_source_pixel_once():
    shapes = [(60, 90), (50, 75)]
    xyl = torch.tensor([[10, 10, 0], [12, 11, 0], [80, 55, 0], [30, 20, 1], [30, 20, 1]],
                       dtype=torch.int32)
    assert roofline.gather_bytes(shapes, xyl) == _brute_bytes(shapes, xyl)


def test_gather_bytes_multi_image_rows():
    shapes = [(2, 40, 64), (2, 33, 53)]            # G = 2 images, L = 2 levels
    xyl = torch.tensor([[20, 20, 0], [20, 20, 2], [10, 10, 3]], dtype=torch.int32)
    # rows 0 and 2 are different images of level 0: no pixel shared
    one = roofline.gather_bytes(shapes, xyl[:1])
    two = roofline.gather_bytes(shapes, xyl[:2])
    assert two - one == one
