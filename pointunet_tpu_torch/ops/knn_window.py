"""Grid policy of the cell-window KNN (``pointunet_tpu/ops/knn_window.py``).

Only the sizing helpers are ported: the pyramid derives its level-0 grid
from ``_grid_resolution``. The reference's XLA cell-window search is the
TPU kernel's fallback off the TPU; in the port that role belongs to
``knn_cuda.knn_cell_window_plain``.
"""
from __future__ import annotations

import math


def _grid_resolution(n_support: int, alpha: float) -> int:
    r = int(math.ceil(n_support ** (1.0 / 3.0) / alpha))
    return max(r, 2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
