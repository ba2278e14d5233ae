"""Background-thread batch prefetch (a copy of
achelous_tpu/data/prefetch.py): while the device runs step N, a producer
thread letterboxes and collates batch N+1 into a queue of bounded depth.
Threads, not processes: Pillow's decode and numpy release the GIL, and the
arrays need no pickling.

Order-preserving, exception-propagating, and its thread shuts down when
the consumer stops early (`close()` or the context manager).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _Stop:
    pass


class Prefetcher:
    """Iterate `iterable` through a depth-bounded background queue."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_Stop)
        except BaseException as e:   # propagate into the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _Stop:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        self._stop.set()
        try:     # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(iterable: Iterable, depth: int = 2) -> Prefetcher:
    return Prefetcher(iterable, depth)
