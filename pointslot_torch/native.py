"""The native runtime's host helpers, in numpy.

Port of ``pointslot_tpu/native/__init__.py``'s ``CovisGraph`` and
``hamming_nn`` with the API and the results of its C++ library
(``native/src/native.cpp``): the covisibility weights keep no self-weight,
``top`` orders by weight then by keyframe id, and a Hamming tie goes to the
lower index. ``hungarian`` is ``detect/deepsort.py``'s (scipy). Nothing on
the port's main path calls these; they exist for parity.
"""

from __future__ import annotations

import numpy as np
import torch

from pointslot_torch.detect.deepsort import hungarian  # noqa: F401
from pointslot_torch.ops.hamming import hamming_table_popcount


class CovisGraph:
    """Covisibility graph over (point, keyframe) observations."""

    def __init__(self, max_points: int, max_kfs: int):
        self.max_points = max_points
        self.max_kfs = max_kfs
        self._obs = np.zeros((max_points, max_kfs), bool)

    def add_obs(self, point: int, kf: int):
        self._obs[point, kf] = True

    def remove_obs(self, point: int, kf: int):
        self._obs[point, kf] = False

    def remove_point(self, point: int):
        self._obs[point, :] = False

    def remove_kf(self, kf: int):
        self._obs[:, kf] = False

    def weights_of(self, kf: int) -> np.ndarray:
        """(max_kfs,) int32 shared-point counts of kf with every keyframe,
        0 for kf itself."""
        w = self._obs[self._obs[:, kf]].sum(axis=0).astype(np.int32)
        w[kf] = 0
        return w

    def top(self, kf: int, min_weight: int = 15, n: int = 64):
        """Up to n keyframes sharing at least min_weight points with kf:
        (ids, weights) int32, by weight descending, then id ascending."""
        w = self.weights_of(kf)
        ids = np.nonzero(w >= min_weight)[0]
        ids = ids[ids != kf]
        ids = ids[np.lexsort((ids, -w[ids]))][:n]
        return ids.astype(np.int32), w[ids].astype(np.int32)


def hamming_nn(desc_a: np.ndarray, desc_b: np.ndarray):
    """Nearest neighbour of each row of desc_a among desc_b, both (N, 8)
    packed 32-bit words -> (index, distance) int32; -1 and 2**30 when desc_b
    is empty."""
    a = np.ascontiguousarray(desc_a, np.uint32).view(np.int32)
    b = np.ascontiguousarray(desc_b, np.uint32).view(np.int32)
    if len(b) == 0:
        return np.full(len(a), -1, np.int32), np.full(len(a), 1 << 30, np.int32)
    d = hamming_table_popcount(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return d.argmin(axis=1).astype(np.int32), d.min(axis=1).astype(np.int32)
