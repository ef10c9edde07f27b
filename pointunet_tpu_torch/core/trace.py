"""The port's tracer: the spans and counters of each served request and
train step, kept in memory.

``request(kind)`` opens a record (``"serve"``, ``"train_point"``,
``"train_saliency"``) and gives it an id; a request opened while another
is open joins it. Inside it, ``span(name, device=False)`` records its
name, its start and end on the host clock (``time.perf_counter_ns``) and
the span that caused it (the innermost span open when it opened, on any
thread: the backward's spans nest under the span that called
``backward``); with ``device=True`` also a CUDA event pair on the current
stream, taken from a pool of events the tracer reuses. ``count(name, n)``
adds to a counter of the open record and to the process's total.
``records()`` returns the finished records, newest last: per span its
host ms and device ms (None where it was not timed on the device), per
counter its count, and ``profiled``.

When it records: always, with no flag. The finished records sit in a
ring of the last ``RING`` records. Recording waits for nothing on the
device, reads nothing back from it and allocates no device memory. When
a record closes, the events of finished records that the device has
passed (``Event.query``, which does not wait) have their device ms read
and go back to the pool, so a steady stream of requests
or steps makes no new events; ``records()`` waits for the rest. While a
``torch.profiler`` session runs, each span also opens a
``record_function`` range of its name, so that the program's spans sit
in the profiler's trace on its clock, and a record opened then is marked
``profiled``; with no profiler running that costs one flag test.
``annotate(name)`` is that range alone, with no record. One thread
records at a time (the backward's thread runs while its caller waits).

Spans and counters the port records (each read as the metric named
after it; see ``PERF.md`` section 3):

* ``serve``: ``serve.copy_in``, ``serve.attention``, ``serve.sampling``,
  ``serve.pyramid``, ``serve.pointseg``, ``serve.wait``,
  ``serve.copy_out``, ``serve.relabel``; counter ``host_sync``, each call
  on the request path that blocks the host until the device reaches it;
* ``train_point``: ``train.pyramid``, ``train.forward_loss``,
  ``train.backward``, ``train.update``, ``gather.backward`` (each
  ``SortedGather.backward``, in one step of every
  ``ops.scatter_sorted.TIMED_EVERY``) and the counter ``gather_backward``
  (every one);
* ``train_saliency``: ``train.forward_loss`` and ``train.backward`` a
  micro-batch, ``train.update``.

The module's functions act on one process-wide ``Tracer``, ``TRACER``;
a test may make a ``Tracer`` of its own.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from collections import deque
from time import perf_counter_ns
from typing import Callable, Dict, List, Optional

import torch

RING = 1024
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    """One span of a record, and the context manager that records it."""
    __slots__ = ("name", "parent", "start_ns", "end_ns", "events",
                 "device_ms", "_tracer", "_rng", "_stream")

    def __init__(self, tracer: "Tracer", name: str, device: bool):
        self.name, self._tracer = name, tracer
        self.events = device                 # the event pair once entered
        self.device_ms = None

    def __enter__(self):
        tracer = self._tracer
        rec, stack = tracer._open, tracer._stack
        self.parent = stack[-1] if stack else None
        stack.append(len(rec.spans))
        rec.spans.append(self)
        if self.events:
            pool = tracer._pool
            start = pool.pop() if pool else _new_event()
            self.events = (start, pool.pop() if pool else _new_event())
            self._stream = tracer._stream()
            start.record(self._stream)
            rec.holds = True
        else:
            self.events = None
        if _profiling():
            self._rng = torch.autograd.profiler.record_function(self.name)
            self._rng.__enter__()
        else:
            self._rng = None
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = perf_counter_ns()
        if self._rng is not None:
            self._rng.__exit__(*exc)
        if self.events is not None:
            self.events[1].record(self._stream)
        self._tracer._stack.pop()
        return False


class _Record:
    __slots__ = ("id", "kind", "profiled", "spans", "counters", "holds",
                 "resolved")

    def __init__(self, rid: int, kind: str, profiled: bool):
        self.id, self.kind, self.profiled = rid, kind, profiled
        self.spans: List[_Span] = []
        self.counters: Dict[str, int] = {}
        self.holds = False                    # CUDA events not yet read
        self.resolved: Optional[dict] = None


def _new_event():
    return torch.cuda.Event(enable_timing=True)


class Tracer:
    def __init__(self):
        self._done: deque = deque(maxlen=RING)
        self._holding: deque = deque()       # finished records with events
        self._open: Optional[_Record] = None
        self._stack: List[int] = []           # the open spans of the record
        self._ids = itertools.count(1)
        self._pool: list = []                 # idle CUDA events
        self._streams: dict = {}              # CUDA stream objects by id
        self._lock = threading.Lock()         # the pool, when records close
        self._totals: Dict[str, int] = {}

    @contextlib.contextmanager
    def request(self, kind: str):
        """Open a record of ``kind`` for the block; yields its id. Inside
        an open record, joins it."""
        if self._open is not None:
            yield self._open.id
            return
        rec = _Record(next(self._ids), kind, _profiling())
        self._open, self._stack = rec, []
        try:
            yield rec.id
        finally:
            self._open = None
            totals = self._totals
            for name, n in rec.counters.items():
                totals[name] = totals.get(name, 0) + n
            with self._lock:
                self._done.append(rec)
                if rec.holds:
                    self._holding.append(rec)
                self._harvest(wait=False)

    def span(self, name: str, device: bool = False, every: int = 1):
        """A context manager that records its block as span ``name`` of the
        open record (without one, only the profiler's range); ``device``:
        also a CUDA event pair around it on the current stream; ``every``:
        only in one record of every ``every`` (those whose id is a
        multiple), and only the profiler's range in the others."""
        rec = self._open
        if rec is None or rec.id % every:
            return annotate(name)
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the open record (which adds
        its counters to the process's totals as it closes); without one,
        to the process's total."""
        rec = self._open
        c = self._totals if rec is None else rec.counters
        c[name] = c.get(name, 0) + n

    def totals(self) -> dict:
        """The process's counter totals (of the finished records and the
        counts made outside one) and, under ``launches``, the CUDA
        kernels' launch counts (``ops.launches.read_launches``)."""
        from ..ops.launches import read_launches

        return dict(self._totals, launches=read_launches())

    def records(self) -> List[dict]:
        """The finished records, oldest first (see the module docstring),
        once the device has passed their events; a record's dict is made
        once and shared: read it, do not change it."""
        with self._lock:
            self._harvest(wait=True)
            done = list(self._done)
        return [rec.resolved or self._resolve(rec) for rec in done]

    def _stream(self):
        """The current CUDA stream; its Python object is kept by the
        stream's id, since ``torch.cuda.current_stream`` builds a new one
        at every call."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream()
        return stream

    def _harvest(self, wait: bool) -> None:
        """Read the device ms of the finished records that hold events
        (those the ring has dropped too), oldest first, and give their
        events back to the pool; without ``wait``, stop at the first event
        the device has not passed."""
        holding, pool = self._holding, self._pool
        while holding:
            rec = holding[0]
            for sp in rec.spans:
                if sp.events is not None:
                    start, end = sp.events
                    if wait:
                        end.synchronize()
                    elif not end.query():
                        return
                    sp.device_ms = start.elapsed_time(end)
                    pool.append(start)
                    pool.append(end)
                    sp.events = None
            holding.popleft()

    def _resolve(self, rec: _Record) -> dict:
        spans = [{"name": sp.name, "parent": sp.parent, "request": rec.id,
                  "start_ns": sp.start_ns, "end_ns": sp.end_ns,
                  "host_ms": (sp.end_ns - sp.start_ns) / 1e6,
                  "device_ms": sp.device_ms} for sp in rec.spans]
        rec.resolved = {"id": rec.id, "kind": rec.kind, "profiled": rec.profiled,
                        "spans": spans, "counters": dict(rec.counters)}
        return rec.resolved


def annotate(name: str):
    """A ``record_function`` range of ``name`` while a profiler runs, and
    nothing otherwise: no record."""
    return torch.autograd.profiler.record_function(name) if _profiling() else _NULL


def span_ms(record: dict, name: str, clock: str = "host") -> Optional[float]:
    """The ms of ``record``'s spans called ``name``, summed, on the host's
    clock or (``clock="device"``) the device's; None where it has none, or
    one of them was not timed on the device."""
    key = f"{clock}_ms"
    values = [s[key] for s in record["spans"] if s["name"] == name]
    if not values or None in values:
        return None
    return sum(values)


def split_ms(record: dict) -> Dict[str, float]:
    """Each span name of ``record`` with its ms, summed: the device's where
    every span of the name was timed there, else the host's."""
    out = {}
    for name in dict.fromkeys(s["name"] for s in record["spans"]):
        ms = span_ms(record, name, "device")
        out[name] = span_ms(record, name) if ms is None else ms
    return out


def window(kind: str, n: int) -> List[dict]:
    """The last ``n`` finished records of ``kind`` that no profiler saw."""
    mine = [r for r in records() if r["kind"] == kind and not r["profiled"]]
    return mine[-n:] if n > 0 else []


def window_mean(kind: str, n: int,
                read: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The mean of ``read(record)`` over ``window(kind, n)``, leaving out
    records where it is None; None where none is left."""
    values = [v for v in map(read, window(kind, n)) if v is not None]
    return sum(values) / len(values) if values else None


TRACER = Tracer()
request = TRACER.request
span = TRACER.span
count = TRACER.count
totals = TRACER.totals
records = TRACER.records
