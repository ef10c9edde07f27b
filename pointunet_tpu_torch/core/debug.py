"""Step timing and the NaN trap (``pointunet_tpu/core/debug.py``).

The reference's NaN trap flips ``jax_debug_nans``; the port's turns on
``torch.autograd.set_detect_anomaly``, which names the forward op whose
backward produced a NaN.
"""
from __future__ import annotations

import time

import torch


def enable_nan_trap(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


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
