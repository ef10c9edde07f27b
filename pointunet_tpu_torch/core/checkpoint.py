"""Step-named checkpoints with a best-metric record, in torch's format
(``pointunet_tpu/core/checkpoint.py``, which writes orbax directories),
and the JAX package's checkpoints once exported.

Layout under ``directory``: ``<step>.pt`` rolling snapshots (the newest
``max_to_keep`` are kept), ``best/<step>.pt`` a single pinned slot for the
best metric, and ``best.json`` ``{"step", "metric"}``. A snapshot is what
the state's ``state_dict()`` returns (for the point trainer: the model's
state_dict, Adam's state, the step and the dropout generator's state),
written with ``torch.save`` and read back with ``weights_only=True``.
``restore*(template)`` loads into ``template`` (its ``load_state_dict``)
and returns it, or returns None when there is no snapshot.

A snapshot may also be ``<step>.npz``: a train state of the JAX package,
which ``export_jax_checkpoint.py`` (repo root, run on a JAX host) writes
from the reference's orbax directory in this same layout, flat as
``convert.py`` takes it. It is read with ``allow_pickle=False`` and
loaded by the template's ``load_reference``; its ``rng`` entry, a
``jax.random`` key that torch cannot continue, is dropped there. Saving
writes ``.pt`` only. Two snapshots of one step raise, and a directory
that holds only orbax step folders ends the run naming the exporter.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import numpy as np
import torch

_EXTS = (".pt", ".npz")


def _snapshots(directory: str) -> dict:
    """{step: file name} of the snapshots directly under ``directory``."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        stem, ext = os.path.splitext(name)
        if ext in _EXTS and stem.isdigit():
            step = int(stem)
            if step in out:
                raise ValueError(
                    f"two snapshots of step {step} under {directory}: "
                    f"{out[step]} and {name}"
                )
            out[step] = name
    return out


def _steps(directory: str) -> List[int]:
    return sorted(_snapshots(directory))


def _refuse_orbax(directory: str) -> None:
    """Exit when ``directory`` holds orbax step folders (the JAX
    package's checkpoints), which the port cannot read."""
    if os.path.isdir(directory) and any(
        name.isdigit() and os.path.isdir(os.path.join(directory, name))
        for name in os.listdir(directory)
    ):
        raise SystemExit(
            f"{directory} holds orbax checkpoints of the JAX package; run "
            f"export_jax_checkpoint.py on a JAX host (python "
            f"export_jax_checkpoint.py --src {directory} --out DIR --stage "
            f"pointseg|saliency) and pass the exported DIR"
        )


def _write(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _remove_step(directory: str, step: int) -> None:
    name = _snapshots(directory).get(step)
    if name is not None:
        os.remove(os.path.join(directory, name))


class BestMetricCheckpointer:
    """Saves step-named checkpoints plus a best-metric record."""

    def __init__(self, directory: str, max_to_keep: int = 100):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")
        os.makedirs(self._best_dir, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "best.json")

    def _save_in(self, directory: str, snapshot: dict, step: int) -> None:
        _remove_step(directory, step)            # an exported .npz of it
        _write(snapshot, os.path.join(directory, f"{step}.pt"))

    def save(self, state: Any, step: int, metric: Optional[float] = None):
        snapshot = state.state_dict()
        self._save_in(self.directory, snapshot, step)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            _remove_step(self.directory, old)
        if metric is not None:
            # the best snapshot is pinned in its own slot: the rolling
            # window above would otherwise evict the step best.json names
            self._save_in(self._best_dir, snapshot, step)
            for old in _steps(self._best_dir):
                if old != step:
                    _remove_step(self._best_dir, old)
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
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                template.load_reference({k: z[k] for k in z.files})
        else:
            template.load_state_dict(
                torch.load(path, map_location="cpu", weights_only=True)
            )
        return template

    def restore(self, step: int, template: Any) -> Any:
        name = _snapshots(self.directory).get(step)
        if name is None:
            raise FileNotFoundError(
                f"no snapshot of step {step} under {self.directory}"
            )
        return self._load(os.path.join(self.directory, name), template)

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            _refuse_orbax(self.directory)
            return None
        return self.restore(step, template)

    def restore_best(self, template: Any) -> Optional[Any]:
        """The snapshot ``best.json`` names (pinned slot first), else the
        latest when there is no ``best.json``; None when the directory
        holds no snapshot at all. A best step whose snapshot is missing
        beside others raises FileNotFoundError."""
        step = self.best_step()
        if step is None:
            return self.restore_latest(template)
        pinned = _snapshots(self._best_dir).get(step)
        if pinned is not None:
            return self._load(os.path.join(self._best_dir, pinned), template)
        if self.latest_step() is None and not _steps(self._best_dir):
            _refuse_orbax(self.directory)
            return None
        return self.restore(step, template)
