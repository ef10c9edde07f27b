"""Reference (flax) variables -> the port's ``state_dict``.

Input is a flat ``dict[str, np.ndarray]`` keyed as
``flax.traverse_util.flatten_dict(variables, sep="/")`` produces it, e.g.
``"params/DilatedResBlock_0/SharedMLP_0/Dense_0/kernel"`` or
``"batch_stats/BatchNorm_0/mean"``. The port's modules carry flax's
auto-names (models/naming.py), so the path maps through unchanged and
only the leaf is converted:

  Dense kernel (in, out)        -> Linear weight (out, in)
  Conv kernel (D, H, W, I, O)   -> Conv3d weight (O, I, D, H, W)
  GroupNorm/BatchNorm scale     -> weight;  bias -> bias
  BatchNorm mean / var          -> running_mean / running_var

Every key must land on a port tensor of the same shape, and every port
tensor must be given: anything else raises. This module needs no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.config import PointSegConfig, SaliencyConfig
from .models.randlanet import RandLANet
from .models.saliency_unet import SaliencyUNet

_LEAVES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _convert_leaf(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    if leaf == "kernel" and value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    return value


def convert_variables(
    flat: Dict[str, np.ndarray], model: torch.nn.Module
) -> Dict[str, torch.Tensor]:
    """Map flat flax variables onto ``model``'s state_dict keys and
    layouts (see the module docstring); raises on any mismatch."""
    target = model.state_dict()
    out = {}
    for key, value in flat.items():
        collection, *path, leaf = key.split("/")
        name = _LEAVES.get(collection, {}).get(leaf)
        if name is None or not path:
            raise KeyError(f"unconvertible variable {key!r}")
        tkey = ".".join(path + [name])
        if tkey not in target:
            raise KeyError(f"variable {key!r} has no port counterpart {tkey!r}")
        if tkey in out:
            raise KeyError(f"two variables map onto {tkey!r}")
        arr = np.ascontiguousarray(_convert_leaf(leaf, np.asarray(value)))
        if tuple(arr.shape) != tuple(target[tkey].shape):
            raise ValueError(
                f"{key!r}: shape {arr.shape} (converted) does not match "
                f"{tkey!r} {tuple(target[tkey].shape)}"
            )
        out[tkey] = torch.from_numpy(arr.astype(np.float32))
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors with no variable: {missing[:5]} ...")
    return out


def convert_randlanet(
    flat: Dict[str, np.ndarray], config: PointSegConfig
) -> Dict[str, torch.Tensor]:
    """``RandLANet`` state_dict from flat reference variables."""
    return convert_variables(flat, RandLANet(config))


def convert_saliency(
    flat: Dict[str, np.ndarray], config: SaliencyConfig
) -> Dict[str, torch.Tensor]:
    """``SaliencyUNet`` state_dict from flat reference variables."""
    return convert_variables(flat, SaliencyUNet(config))
