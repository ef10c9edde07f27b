"""Background prefetch of batch iterators (``pointunet_tpu/data/prefetch.py``).

While the card runs step N, a host thread prepares batch N+1 (ply read,
context-aware sampling: numpy, which releases the GIL for its heavy
ops). A bounded queue keeps memory flat.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_STOP = object()


class PrefetchIterator:
    """Wrap an iterator; a daemon thread stays ``buffer_size`` items ahead.

    Exceptions in the producer propagate to the consumer on the next
    ``__next__``. The producer thread exits when the source is exhausted,
    the consumer is garbage-collected, or ``close()`` is called.
    """

    def __init__(self, source: Iterable, buffer_size: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _produce(self, it: Iterator):
        try:
            for item in it:
                if not self._put(item):
                    return
            self._put(_STOP)
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(e)

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; whether it was queued."""
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is _STOP:
            self._closed.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._closed.set()
            raise item
        return item

    def close(self):
        self._closed.set()

    def __del__(self):
        self.close()


def prefetch(source: Iterable, buffer_size: int = 4) -> Iterable:
    """``source`` prefetched by a host thread; buffer_size <= 0 disables."""
    if buffer_size <= 0:
        return source
    return PrefetchIterator(source, buffer_size)
