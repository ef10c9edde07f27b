"""Judge of a train step: the program's first steps against the plain
reference's, from the same weights, rows and dropout draws.

Numbers compared (``limits/<workload>.json`` holds each limit):

* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| of the steps,
  and ``loss0_gap`` that of the first step (the same weights on both
  sides: the forward's rounding alone);
* ``grad_gap``: the first gradient as the optimizer got it (read from its
  state after one step), leaf by leaf: the gap between the program's norm
  and the reference's, over the larger of the reference's norm of that
  leaf and of the median leaf; the worst leaf;
* ``update_gap``: the same of each leaf's change over the steps;
* ``logits0_dist`` (where both sides keep them): the first forward's
  logits against the reference's, ||l - l_ref|| over the norm of the
  reference's logits less each class's mean.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both (their change under Adam is round-off: an
attention score's bias under softmax, a norm's shift before another).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

SMALL = 1e-3


def leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves compared: reference gradient norm >= SMALL x the median."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= SMALL * med]


def leaf_gap(port: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(port[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def judge(port: dict, ref: dict) -> Dict[str, float]:
    """``port`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "update_norms": {leaf: norm}}."""
    keys = leaves(ref["grad_norms"])
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(port["losses"], ref["losses"])]
    extra = {}
    if "logits0" in port and "logits0" in ref:
        l_ref = ref["logits0"].float()
        # each class's mean over the voxels (B, C, ...) or points (N, C)
        axes = tuple(range(2, l_ref.ndim)) if l_ref.ndim > 2 else (0,)
        centred = l_ref - l_ref.mean(dim=axes, keepdim=True)
        extra["logits0_dist"] = float((port["logits0"].float() - l_ref).norm()
                                      / centred.norm())
    extra["leaves_out"] = len(ref["grad_norms"]) - len(keys)
    return {**extra,
        "loss0_gap": gaps[0],
        "loss_gap": max(gaps),
        "grad_gap": leaf_gap(port["grad_norms"], ref["grad_norms"], keys),
        "update_gap": leaf_gap(port["update_norms"], ref["update_norms"], keys),
    }


def unchanged(ref_frozen: dict) -> dict:
    """The readings of a step that leaves its state unchanged: the losses
    of the first weights on each step's rows (``ref_frozen``: the
    reference at learning rate 0), no gradient in the optimizer, no
    change."""
    zero = {k: 0.0 for k in ref_frozen["grad_norms"]}
    return {"losses": ref_frozen["losses"], "grad_norms": zero,
            "update_norms": zero}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


class Adam:
    """Adam as optax's defaults and torch's compute it: b1 0.9, b2 0.999,
    eps 1e-8 added to the bias-corrected root."""

    def __init__(self, params: Dict[str, torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.p, self.b1, self.b2, self.eps = params, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            self.p[k] -= lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)


class MomentumSGD:
    """SGD with momentum 0.9 (no dampening) and weight decay added to the
    gradients of the leaves in ``decayed`` before the momentum trace."""

    def __init__(self, params: Dict[str, torch.Tensor], decayed, weight_decay,
                 momentum=0.9):
        self.p, self.decayed, self.wd, self.mu = params, set(decayed), weight_decay, momentum
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        """One update; the gradients as the optimizer took them."""
        took = {}
        for k, g in grads.items():
            d = g + self.wd * self.p[k] if k in self.decayed else g.clone()
            took[k] = d
            self.buf[k] = d.clone() if k not in self.buf else self.buf[k].mul_(self.mu).add_(d)
            self.p[k] -= lr * self.buf[k]
        return took
