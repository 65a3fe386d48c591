"""Background-prefetching loader feeding the eval loop.

``PrefetchIterator``, copied from ``stereotracking_tpu/data/loader.py``:
a thread-pool prefetcher in place of the reference's fork-based torch
DataLoader.  PNG decode and host-side transforms run in worker threads
(PIL releases the GIL for decode) ahead of use.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


class PrefetchIterator:
    """Run ``fn(item)`` for items of ``it`` in ``num_workers`` threads,
    yielding results in order with up to ``prefetch`` ready ahead."""

    def __init__(self, it: Iterable, fn: Callable, num_workers: int = 4,
                 prefetch: int = 4):
        self._items = list(it)
        self._fn = fn
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._prefetch = prefetch

    def __len__(self):
        return len(self._items)

    def __iter__(self) -> Iterator:
        futures = []
        idx = 0
        n = len(self._items)
        while idx < min(self._prefetch, n):
            futures.append(self._pool.submit(self._fn, self._items[idx]))
            idx += 1
        for i in range(n):
            result = futures[i].result()
            if idx < n:
                futures.append(self._pool.submit(self._fn, self._items[idx]))
                idx += 1
            yield result
