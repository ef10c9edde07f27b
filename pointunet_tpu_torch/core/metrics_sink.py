"""Machine-readable training-scalar sink (``pointunet_tpu/core/metrics_sink.py``).

An append-only JSONL file, one ``{"step": ..., "wall_time": ...,
<scalars>}`` object per line, safe to tail while training.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL scalar writer (``<logdir>/scalars.jsonl``).

    Values are coerced to Python floats; non-finite values are stored as
    strings ("nan"/"inf") because JSON has no literal for them."""

    def __init__(self, logdir: str, filename: str = "scalars.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f: Optional[IO[str]] = open(self.path, "a", buffering=1)

    def log(self, step: int, **scalars) -> None:
        if self._f is None:
            raise ValueError("MetricsLogger is closed")
        rec = {"step": int(step), "wall_time": time.time()}
        for key, value in scalars.items():
            v = float(value)
            rec[key] = v if v == v and abs(v) != float("inf") else repr(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()



def read_scalars(path: str) -> list:
    """A scalars.jsonl file back as a list of dicts (blank lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
