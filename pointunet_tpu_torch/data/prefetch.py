"""Background prefetch of batch iterators (``pointunet_tpu/data/prefetch.py``).

While the card runs step N, a host thread prepares batch N+1 (ply read,
context-aware sampling: numpy, which releases the GIL for its heavy
ops). A bounded queue keeps memory flat. ``prefetch_map`` maps a function
over items on a thread pool, in order, a bounded number of items ahead.
"""
from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

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


def prefetch_map(
    fn: Callable, items: Sequence, num_threads: int = 2,
    buffer_size: int = 4,
) -> Iterable:
    """``fn`` of each item, in order, computed by ``num_threads`` threads
    at most ``buffer_size`` items ahead of the consumer; an exception of
    ``fn`` is raised when its item is reached. A ``buffer_size`` below 1
    runs one item ahead (the reference's maps nothing then)."""
    ahead = max(1, buffer_size)

    def gen():
        with ThreadPoolExecutor(num_threads) as pool:
            it = iter(items)
            pending = [pool.submit(fn, x)
                       for _, x in zip(range(ahead), it)]
            while pending:
                yield pending.pop(0).result()
                for x in itertools.islice(it, 1):
                    pending.append(pool.submit(fn, x))

    return gen()
