"""Spans and marks the benchmark records around the program's own calls,
and the reading of a ``torch.profiler`` trace.

``Spans.wrap(obj, method, name)`` replaces a bound method of one instance
by a call that, while ``timed``, records a CUDA event before and after it
(``<name>.start``, ``<name>.end``) under ``torch.profiler.record_function``
(so that the trace knows the stage), and, while ``capture`` is a dict,
keeps the call's result there under ``name``. The program's own code runs
unchanged; only this instance's attribute is replaced. ``mark(label)``
records one event. Each request or step opens a row with ``begin()``;
``rows()`` turns them into (label, ms since the row's first event).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import stats

# idle stretches labelled by what the host was doing, longest first
LABELLED_GAPS = 400


class Spans:
    def __init__(self, timed: bool):
        self.timed = timed
        self.capture: Optional[dict] = None
        self._rows: List[List[Tuple[str, torch.cuda.Event]]] = []

    def begin(self) -> None:
        if self.timed:
            self._rows.append([])
            self.mark("begin")

    def mark(self, label: str) -> None:
        if self.timed and self._rows:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._rows[-1].append((label, ev))

    def wrap(self, obj, method: str, name: str) -> None:
        real = getattr(obj, method)

        def call(*args, **kwargs):
            if not self.timed:
                out = real(*args, **kwargs)
            else:
                self.mark(f"{name}.start")
                with torch.profiler.record_function(name):
                    out = real(*args, **kwargs)
                self.mark(f"{name}.end")
            if self.capture is not None:
                self.capture[name] = out
            return out

        setattr(obj, method, call)

    def rows(self) -> List[List[Tuple[str, float]]]:
        """Every row's marks as (label, ms after the row's first mark);
        synchronises the device."""
        torch.cuda.synchronize()
        return [[(label, row[0][1].elapsed_time(ev)) for label, ev in row]
                for row in self._rows]


def span_ms(row: List[Tuple[str, float]], name: str) -> float:
    """Total ms of the ``name`` spans of one row."""
    total, start = 0.0, None
    for label, t in row:
        if label == f"{name}.start":
            start = t
        elif label == f"{name}.end" and start is not None:
            total += t - start
            start = None
    return total


def between_ms(row: List[Tuple[str, float]], first: str, then: str) -> float:
    """Total ms from each ``first`` mark to the next ``then`` mark."""
    total, start = 0.0, None
    for label, t in row:
        if label == first:
            start = t
        elif label == then and start is not None:
            total += t - start
            start = None
    return total


def _annotation(event, stages) -> bool:
    """A span drawn on the device's timeline (``record_function``'s, the
    optimizer's): it covers the gaps between its kernels, so it is no
    device work."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name in stages


def profile(fn: Callable[[], None], calls: int, stages=()) -> dict:
    """Run ``fn`` ``calls`` times under ``torch.profiler``: the device's
    busy seconds (the union of its kernels' and copies' intervals), the window's
    host seconds, the ten device operations that took most time and the
    ten longest idle stretches summed by what the host was doing (the
    innermost of the span names ``stages`` and host operation running at
    the stretch's middle)."""
    import time
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = list(prof.events())
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not _annotation(e, stages)]
    dev = [(e.time_range.start, e.time_range.end) for e in on_device]
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    by_op: Dict[str, float] = defaultdict(float)
    for e in on_device:
        by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    idle: Dict[str, float] = defaultdict(float)
    if dev and host:
        import numpy as np
        starts = np.array([h.time_range.start for h in host], np.float64)
        ends = np.array([h.time_range.end for h in host], np.float64)
        is_stage = np.array([h.name in stages for h in host])
        stretches = sorted(stats.gaps(dev, starts.min(), ends.max()),
                           key=lambda se: se[0] - se[1])[:LABELLED_GAPS]
        for s, e in stretches:
            mid = (s + e) / 2
            around = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = "host"
            if around.size:
                op = around[np.argmin(ends[around] - starts[around])]
                label = host[op].name
                stage = around[is_stage[around]]
                if stage.size:
                    inner = stage[np.argmin(ends[stage] - starts[stage])]
                    label = f"{host[inner].name}/{label}"
            idle[label] += (e - s) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": stats.union_length(dev) / 1e6, "window_s": window,
            "calls": calls,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
