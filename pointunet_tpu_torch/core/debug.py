"""Step timing, the NaN trap and profiling (``pointunet_tpu/core/debug.py``).

The reference's NaN trap flips ``jax_debug_nans``; the port's turns on
``torch.autograd.set_detect_anomaly``, which names the forward op whose
backward produced a NaN. The reference's ``profile_trace`` wraps a region
in a ``jax.profiler`` trace; the port's in ``torch.profiler``, written as
a Chrome trace that TensorBoard's profiler plugin and Perfetto read.
"""
from __future__ import annotations

import contextlib
import time

import torch


def enable_nan_trap(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def profile_trace(logdir: str, device: str = "cuda"):
    """Profiles the region within into ``<logdir>/<worker>.<ms>.pt.trace.json``.

    ``device="cuda"`` records the host and the card, and raises when
    there is no CUDA device (it never records the host alone in its
    place); ``device="cpu"`` records the host only."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_trace(device='cuda'): no CUDA device")
        activities.append(ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"profile_trace: device {device!r} is not cuda or cpu")
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """ms/batch + ETA logging."""

    def __init__(self, total_steps: int):
        self.total = total_steps
        self.start = time.time()
        self.last = self.start
        self.count = 0

    def tick(self, steps: int = 1) -> dict:
        now = time.time()
        self.count += steps
        ms = (now - self.last) * 1000.0 / max(steps, 1)
        self.last = now
        rate = self.count / max(now - self.start, 1e-9)
        remaining = max(self.total - self.count, 0) / max(rate, 1e-9)
        return {"ms_per_batch": ms, "eta_sec": remaining}


def format_eta(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h:d}:{m:02d}:{s:02d}"
