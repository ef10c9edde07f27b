"""Reference (flax) variables -> the port's ``state_dict``.

Input is a flat ``dict[str, np.ndarray]`` keyed as
``flax.traverse_util.flatten_dict(variables, sep="/")`` produces it, e.g.
``"params/DilatedResBlock_0/SharedMLP_0/Dense_0/kernel"`` or
``"batch_stats/BatchNorm_0/mean"``. The port's modules carry flax's
auto-names (models/naming.py), so the path maps through unchanged and
only the leaf is converted:

  Dense kernel (in, out)        -> Linear weight (out, in)
  Conv kernel (D, H, W, I, O)   -> Conv3d weight (O, I, D, H, W)
  2-D Conv kernel (H, W, I, O)  -> Conv2d weight (O, I, H, W)
  GroupNorm/BatchNorm scale     -> weight;  bias -> bias
  BatchNorm mean / var          -> running_mean / running_var

Every key must land on a port tensor of the same shape, and every port
tensor must be given: anything else raises. This module needs no JAX.

``convert_train_state`` carries a reference point-seg ``TrainState`` over
to the port's trainer: ``params``/``batch_stats`` as above, optax's Adam
moments ``mu/<path>``/``nu/<path>`` (keyed like ``params``, same leaf
transposes) into ``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``, its
``count`` into Adam's ``step``, and the trainer's ``step``.
``convert_saliency_train_state`` does the same for a reference
``SaliencyTrainState``: optax's momentum ``trace/<path>`` into
``torch.optim.SGD``'s ``momentum_buffer`` (the two parameter groups of
``train/saliency.py:make_optimizer``), and the schedule's ``count``, which
the port's schedule reads as the trainer's ``step``. Both drop the
state's ``rng`` (a ``jax.random`` key). ``export_jax_checkpoint.py`` (repo
root) writes such flat states from the reference's orbax checkpoints;
the states' ``load_reference`` takes them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.config import PointSegConfig, SaliencyConfig
from .models.randlanet import RandLANet
from .models.saliency_unet import SaliencyUNet, UNet3D
from .train.saliency import decay_split, make_optimizer

_LEAVES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _convert_leaf(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    if leaf == "kernel" and value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def convert_variables(
    flat: Dict[str, np.ndarray], model: torch.nn.Module
) -> Dict[str, torch.Tensor]:
    """Map flat flax variables onto ``model``'s state_dict keys and
    layouts (see the module docstring); raises on any mismatch."""
    return convert_leaves(flat, model.state_dict())


def convert_leaves(
    flat: Dict[str, np.ndarray], target: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """``flat`` onto exactly the keys of ``target`` (port tensors by
    state_dict name), leaf by leaf; raises on any mismatch."""
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
    flat: Dict[str, np.ndarray], config: SaliencyConfig,
    attention: bool = True,
) -> Dict[str, torch.Tensor]:
    """``SaliencyUNet`` (``attention``) or ``UNet3D`` state_dict from flat
    reference variables."""
    return convert_variables(
        flat, (SaliencyUNet if attention else UNet3D)(config)
    )


def _split_state(flat: Dict[str, np.ndarray], moments) -> tuple:
    """A flat reference train state -> (variables, {moment: {params/...:
    value}}, {"count", "step"}); drops ``rng`` (the reference's
    ``jax.random`` key, which torch cannot continue) and raises on any
    other entry."""
    variables: Dict[str, np.ndarray] = {}
    groups: Dict[str, Dict[str, np.ndarray]] = {m: {} for m in moments}
    scalars = {}
    for key, value in flat.items():
        head, _, rest = key.partition("/")
        if head in ("params", "batch_stats"):
            variables[key] = value
        elif head in moments and rest:
            groups[head]["params/" + rest] = value
        elif key in ("count", "step"):
            scalars[key] = int(np.asarray(value))
        elif key != "rng":
            raise KeyError(f"unconvertible train-state entry {key!r}")
    if set(scalars) != {"count", "step"}:
        raise KeyError(f"train state lacks {sorted({'count', 'step'} - set(scalars))}")
    return variables, groups, scalars


def convert_saliency_train_state(
    flat: Dict[str, np.ndarray], model: torch.nn.Module,
) -> dict:
    """A flat reference saliency train state (``params/...``,
    ``trace/...``, ``count``, ``step``) -> ``{"model": state_dict,
    "optimizer": SGD state_dict, "step": int}`` for ``model`` (a
    ``SaliencyUNet`` or ``UNet3D``, whose config gives the weight decay,
    so the groups are the trainer's own), which
    ``SaliencyTrainState.load_state_dict`` takes. The port keeps one
    counter, read by the schedule; a state whose ``count`` differs from
    its ``step`` (the reference's trainer advances both together) is
    refused, as is any key or shape mismatch."""
    variables, groups, scalars = _split_state(flat, ("trace",))
    if scalars["count"] != scalars["step"]:
        raise ValueError(
            f"schedule count {scalars['count']} differs from step "
            f"{scalars['step']}"
        )
    buffers = convert_leaves(groups["trace"], dict(model.named_parameters()))
    opt_state = make_optimizer(model, model.config.weight_decay).state_dict()
    order = [name for group in decay_split(model) for name in group]
    opt_state["state"] = {
        i: {"momentum_buffer": buffers[name]} for i, name in enumerate(order)
    }
    return {
        "model": convert_variables(variables, model),
        "optimizer": opt_state,
        "step": scalars["step"],
    }


def convert_train_state(
    flat: Dict[str, np.ndarray], model: torch.nn.Module,
    betas=(0.9, 0.999), eps: float = 1e-8,
) -> dict:
    """A flat reference train state (``params/...``, ``batch_stats/...``,
    ``mu/...``, ``nu/...``, ``count``, ``step``) -> ``{"model": state_dict,
    "optimizer": Adam state_dict, "step": int}`` for ``model``, which
    ``TrainState.load_state_dict`` takes. Raises on any key or shape
    mismatch."""
    variables, groups, scalars = _split_state(flat, ("mu", "nu"))
    params = dict(model.named_parameters())
    moments = {
        which: convert_leaves(groups[which], params) for which in ("mu", "nu")
    }
    opt = torch.optim.Adam(model.parameters(), betas=betas, eps=eps)
    opt_state = opt.state_dict()
    opt_state["state"] = {
        i: {
            "step": torch.tensor(float(scalars["count"])),
            "exp_avg": moments["mu"][name],
            "exp_avg_sq": moments["nu"][name],
        }
        for i, name in enumerate(params)
    }
    return {
        "model": convert_variables(variables, model),
        "optimizer": opt_state,
        "step": scalars["step"],
    }
