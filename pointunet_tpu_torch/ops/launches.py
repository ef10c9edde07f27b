"""Launch counts of the four CUDA kernels. Each kernel's wrapper module
keeps ``LAUNCHES``, which it raises by one where it launches its kernel;
``KERNELS`` maps each kernel's name to that module. Importing this module
imports none of the wrappers."""
from __future__ import annotations

import importlib

KERNELS = {
    "knn_cell_window": "knn_cuda",
    "scatter_sorted": "scatter_sorted",
    "conv3d_3x3": "conv_cuda",
    "windowed_scatter": "scatter_window",
}


def _wrapper(name: str):
    return importlib.import_module(f"{__package__}.{KERNELS[name]}")


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    for name in KERNELS:
        _wrapper(name).LAUNCHES = 0


def read_launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: _wrapper(name).LAUNCHES for name in KERNELS}
