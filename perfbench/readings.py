"""What the per-layer metrics' readers share: means of spans over a run's
requests or steps, and the cell's peak rates."""
from __future__ import annotations

import math
from typing import Optional

from .spans import between_ms, span_ms


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def span_mean(run: dict, name: str) -> Optional[float]:
    """Mean ms of the ``name`` spans a row, over rows that have one."""
    rows = run.get("rows") or []
    return mean(span_ms(r, name) for r in rows
                if any(label == f"{name}.start" for label, _ in r))


def between_mean(run: dict, first: str, then: str) -> Optional[float]:
    rows = run.get("rows") or []
    return mean(between_ms(r, first, then) for r in rows
                if any(label == first for label, _ in r))


def flops_peak(run: dict, path: str) -> float:
    cfg = run["cfg"]
    return cfg["peaks"][cfg[path]["precision"]]


def bytes_peak(run: dict) -> float:
    return run["cfg"]["peaks"]["hbm_bytes_per_s"]


def mean_wall_s(run: dict) -> Optional[float]:
    return mean(w for w in run["walls"] if math.isfinite(w))


def idle_share(run: dict) -> Optional[float]:
    """Per cent of a request's or step's wall in which no operation ran on
    the device: the device's busy seconds a call in the profiled calls
    after the window, over the window's own (unprofiled) seconds a call.
    The profiler's hooks slow the host, so its own window would overstate
    the idle share of a host-bound step."""
    prof = run.get("profile")
    wall = run.get("step_s") or mean_wall_s(run)
    if not prof or not wall or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["calls"] / wall)


def share(bound_s: float, took_ms: Optional[float]) -> Optional[float]:
    """Per cent of the time taken that the bound accounts for."""
    if not took_ms:
        return None
    return 100.0 * bound_s * 1e3 / took_ms
