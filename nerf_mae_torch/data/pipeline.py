"""The overlapped host feed (counterpart of nerf_mae_tpu/data/pipeline.py).

- `PrefetchIterator` / `prefetch`: a daemon thread keeps `depth` items of a
  batch iterator ready in a bounded queue. Its `map_fn` (the drivers'
  host-to-device transfer, common.overlap_batches) runs on that thread, so
  the copy of batch N+1 overlaps the card's step on batch N, and a slow
  consumer never piles up host memory.
- `ScenePool`: a thread pool for per-scene batch assembly, in order. The
  native collate (data/native.py, ctypes) releases the GIL, so the pool
  runs scenes in parallel; pure-Python work stays about serial.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from nerf_mae_torch import tracing

_SENTINEL = object()


class PrefetchIterator:
    """Wraps an iterator; a daemon thread keeps `depth` items ready.

    An exception raised by the source iterator (or map_fn) is re-raised in
    the consumer at the next `__next__`. The consumer's wait is the span
    nerf_mae.feed.wait (tracing.py). `close()` (also called by
    `__exit__` and on exhaustion) stops the thread promptly, also when the
    consumer abandons the iterator mid-epoch.
    """

    def __init__(self, source: Iterator, depth: int = 2,
                 map_fn: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._map_fn = map_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item`, waiting for room; False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._source:
                if self._map_fn is not None:
                    item = self._map_fn(item)
                if not self._put(item):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises
            self._err = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        with tracing.span("nerf_mae.feed.wait", events=False):
            item = self._q.get()
        if item is _SENTINEL:
            self.close()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the thread, then close the source (its thread pool, say)
        if it has a close() and the thread has let go of it."""
        self._stop.set()
        # drain, so that a producer blocked in put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive() and hasattr(self._source, "close"):
            self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(source: Iterator, depth: int = 2,
             map_fn: Optional[Callable] = None) -> PrefetchIterator:
    """Background-thread prefetch of `depth` items; map_fn runs on the
    prefetch thread."""
    return PrefetchIterator(source, depth=depth, map_fn=map_fn)


class ScenePool:
    """Thread pool for per-scene batch assembly; map(fn, items) keeps
    order. workers=0 maps inline."""

    def __init__(self, workers: int = 0):
        self._pool = ThreadPoolExecutor(workers) if workers > 0 else None

    def map(self, fn, items):
        if self._pool is None:
            return [fn(x) for x in items]
        return list(self._pool.map(fn, items))

    def close(self):
        # the pool is idle between map() calls, so the join is immediate
        if self._pool is not None:
            self._pool.shutdown(wait=True)
