"""Background frame prefetcher (a copy of ``pointslot_tpu/datasets/prefetch.py``).

The reference decodes every PNG synchronously on the tracking thread
(reference Examples/Stereo/stereo_kitti.cc:108-124 cv::imread in the main
loop; masks inside the Frame ctor, src/Frame.cc:687-692), so disk/decode
time adds directly to per-frame latency. Here a small thread pool decodes
``depth`` frames ahead while the device computes, and frames are yielded
strictly in order — the host-side analog of the reference's fork-join
extraction threads applied to IO.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


def prefetch(load_fn: Callable[[int], T], n_items: int,
             depth: int = 4, workers: int = 2) -> Iterator[T]:
    """Yield load_fn(0..n_items-1) in order, decoding up to ``depth``
    frames ahead on ``workers`` background threads."""
    if n_items <= 0:
        return
    depth = max(1, depth)
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        pending = {
            i: pool.submit(load_fn, i) for i in range(min(depth, n_items))
        }
        nxt = len(pending)
        for i in range(n_items):
            fut = pending.pop(i)
            try:
                item = fut.result()
            except Exception:
                # drain outstanding work before propagating
                for f in pending.values():
                    f.cancel()
                raise
            if nxt < n_items:
                pending[nxt] = pool.submit(load_fn, nxt)
                nxt += 1
            yield item
