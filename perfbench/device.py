"""The card the benchmark runs on, and what it may not find loaded."""
from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "pointunet_tpu")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev: torch.device) -> int:
    """The process's peak of allocated device bytes."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def release(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"
