"""Step-named checkpoints with a best-metric record, in torch's format
(``pointunet_tpu/core/checkpoint.py``, which writes orbax directories).

Layout under ``directory``: ``<step>.pt`` rolling snapshots (the newest
``max_to_keep`` are kept), ``best/<step>.pt`` a single pinned slot for the
best metric, and ``best.json`` ``{"step", "metric"}``. A snapshot is what
the state's ``state_dict()`` returns (for the point trainer: the model's
state_dict, Adam's state, the step and the dropout generator's state),
written with ``torch.save`` and read back with ``weights_only=True``.
``restore*(template)`` loads into ``template`` (its ``load_state_dict``)
and returns it, or returns None when there is no snapshot. Reading the
reference's orbax checkpoints is not ported.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import torch


def _steps(directory: str) -> List[int]:
    out = []
    for name in os.listdir(directory):
        stem, ext = os.path.splitext(name)
        if ext == ".pt" and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def _write(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class BestMetricCheckpointer:
    """Saves step-named checkpoints plus a best-metric record."""

    def __init__(self, directory: str, max_to_keep: int = 100):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")
        os.makedirs(self._best_dir, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "best.json")

    def save(self, state: Any, step: int, metric: Optional[float] = None):
        snapshot = state.state_dict()
        _write(snapshot, os.path.join(self.directory, f"{step}.pt"))
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"{old}.pt"))
        if metric is not None:
            # the best snapshot is pinned in its own slot: the rolling
            # window above would otherwise evict the step best.json names
            _write(snapshot, os.path.join(self._best_dir, f"{step}.pt"))
            for old in _steps(self._best_dir):
                if old != step:
                    os.remove(os.path.join(self._best_dir, f"{old}.pt"))
            with open(self._meta_path, "w") as f:
                json.dump({"step": step, "metric": float(metric)}, f)

    def best_step(self) -> Optional[int]:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return int(json.load(f)["step"])
        return None

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def _load(self, path: str, template: Any) -> Any:
        template.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True)
        )
        return template

    def restore(self, step: int, template: Any) -> Any:
        return self._load(os.path.join(self.directory, f"{step}.pt"), template)

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    def restore_best(self, template: Any) -> Optional[Any]:
        """The snapshot ``best.json`` names (pinned slot first), else the
        latest when there is no ``best.json``; None when the directory
        holds no ``.pt`` snapshot at all, as an orbax directory of the JAX
        package, which has a ``best.json``. A best step whose snapshot is
        missing beside others raises FileNotFoundError."""
        step = self.best_step()
        if step is None:
            return self.restore_latest(template)
        pinned = os.path.join(self._best_dir, f"{step}.pt")
        if os.path.exists(pinned):
            return self._load(pinned, template)
        if self.latest_step() is None and not _steps(self._best_dir):
            return None
        return self.restore(step, template)
