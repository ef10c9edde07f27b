"""Plain reference of RandLA-Net over a decimation pyramid (Point-Unet
stage 2, after Hu et al., arXiv:1911.11236).

A function of a flat parameter dict named as the port's state dict names
it. Every "1x1 conv" over points is a dense layer followed by batch norm
(eps 1e-6) and leaky relu 0.2; the local feature aggregation encodes each
neighbour's relative position as [distance, relative xyz, xyz, neighbour
xyz], pools attentively (softmax over the K neighbours) twice, and a
residual block adds a linear shortcut. The encoder max-pools each level's
kept points over their neighbours; the decoder upsamples by the nearest
kept point and concatenates the skip. Everything is float32; dense
operands go through ``prec``.

Batch norm takes the running statistics in eval mode, the batch's in
train mode (biased variance E[x^2] - E[x]^2, as flax computes it).
Dropout (train mode) multiplies by a keep mask that the caller draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .precision import F32


def dense(P, name, x, prec):
    b = P.get(f"{name}.bias")
    return F.linear(prec(x), prec(P[f"{name}.weight"]),
                    None if b is None else b.float())


def batch_norm(P, name, x, train):
    w, b = P[f"{name}.weight"].float(), P[f"{name}.bias"].float()
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + 1e-6) * w) + b


def mlp(P, name, x, prec, train, act=True):
    x = batch_norm(P, f"{name}.BatchNorm_0", dense(P, f"{name}.Dense_0", x, prec),
                   train)
    return F.leaky_relu(x, 0.2) if act else x


def _rows(table, idx):
    """(N, d), (M, K) -> (M, K, d)."""
    return table[idx.long()]


def att_pool(P, name, fs, prec, train):
    scores = torch.softmax(dense(P, f"{name}.Dense_0", fs, prec), dim=-2)
    return mlp(P, f"{name}.SharedMLP_0", (scores * fs).sum(-2), prec, train)


def lfa(P, name, xyz, feature, neigh, prec, train):
    nxyz = _rows(xyz, neigh)                                  # (N, K, 3)
    tile = xyz[:, None, :].expand_as(nxyz)
    rel = tile - nxyz
    dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    enc = torch.cat([dist, rel, tile, nxyz], -1)
    f_xyz = mlp(P, f"{name}.SharedMLP_0", enc, prec, train)
    f_agg = att_pool(P, f"{name}.AttPooling_0",
                     torch.cat([_rows(feature, neigh), f_xyz], -1), prec, train)
    f_xyz = mlp(P, f"{name}.SharedMLP_1", f_xyz, prec, train)
    return att_pool(P, f"{name}.AttPooling_1",
                    torch.cat([_rows(f_agg, neigh), f_xyz], -1), prec, train)


def res_block(P, name, xyz, feature, neigh, prec, train):
    f = mlp(P, f"{name}.SharedMLP_0", feature, prec, train)
    f = lfa(P, f"{name}.LocalFeatureAggregation_0", xyz, f, neigh, prec, train)
    f = mlp(P, f"{name}.SharedMLP_1", f, prec, train, act=False)
    sc = mlp(P, f"{name}.SharedMLP_2", feature, prec, train, act=False)
    return F.leaky_relu(f + sc, 0.2)


def forward(P: Dict[str, torch.Tensor], num_layers: int, features: torch.Tensor,
            xyz: Sequence[torch.Tensor], neigh: Sequence[torch.Tensor],
            sub: Sequence[torch.Tensor], interp: Sequence[torch.Tensor],
            prec=F32(), train: bool = False,
            keep: Optional[torch.Tensor] = None, dropout: float = 0.0):
    """Logits (N, num_classes) f32 of one cloud: ``features`` (N, 3 + F)
    in the pyramid's level-0 order; per level its xyz, self neighbours,
    the kept points' neighbours and each point's nearest kept point.
    ``keep`` (N, 32) bool: the dropout keep mask before the head."""
    x = F.leaky_relu(batch_norm(P, "BatchNorm_0",
                                dense(P, "Dense_0", features.float(), prec),
                                train), 0.2)
    skips = []
    for i in range(num_layers):
        f_enc = res_block(P, f"DilatedResBlock_{i}", xyz[i], x, neigh[i], prec,
                          train)
        x = _rows(f_enc, sub[i]).amax(-2)
        if i == 0:
            skips.append(f_enc)
        skips.append(x)
    x = mlp(P, "SharedMLP_0", x, prec, train)
    for j in range(num_layers):
        level = num_layers - 1 - j
        up = x[interp[level][:, 0].long()]
        x = mlp(P, f"SharedMLP_{j + 1}", torch.cat([skips[-j - 2], up], -1),
                prec, train)
    x = mlp(P, f"SharedMLP_{num_layers + 1}", x, prec, train)
    x = mlp(P, f"SharedMLP_{num_layers + 2}", x, prec, train)
    if train and keep is not None and dropout > 0:
        x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
    return dense(P, "Dense_1", x, prec)


def class_weights(class_counts):
    total = float(sum(class_counts))
    return [1.0 / (c / total + 0.02) for c in class_counts]


def weighted_ce(logits, labels, weights):
    """Mean over the points of the class-weighted softmax cross-entropy."""
    w = torch.tensor(weights, dtype=torch.float32, device=logits.device)
    ce = -F.log_softmax(logits.float(), -1).gather(1, labels[:, None].long())[:, 0]
    return (ce * w[labels.long()]).sum() / labels.numel()


def train_steps(cfg: dict, w0: Dict[str, torch.Tensor], clouds, dropout_seed: int,
                prec=F32(), lr_scale: float = 1.0) -> dict:
    """The first ``len(clouds)`` train steps from weights ``w0``: each
    builds its cloud's pyramid, runs the training forward (batch
    statistics, dropout drawn as the program draws it: one (1, N, 32)
    Bernoulli draw a step from a generator seeded ``dropout_seed`` on the
    cloud's device), the class-weighted cross-entropy, its gradient and an
    Adam update at the configuration's learning rate (times ``lr_scale``:
    0 leaves the weights as they were). Returns the losses, the first
    forward's logits,
    the first gradient's norm and each leaf's change after the steps."""
    from . import pyramid
    from .judge_train import Adam, norms

    p = cfg["pointseg"]
    params = {k: v.detach().clone().float() for k, v in w0.items()
              if not k.endswith(("running_mean", "running_var"))}
    opt = Adam(params)
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    weights = class_weights(p["class_counts"])
    losses, first = [], None
    for i, (xyz, feats, labels) in enumerate(clouds):
        pyr = pyramid.build(xyz[0], p["k_n"], p["sub_sampling_ratio"])
        n = xyz.shape[1]
        keep = torch.empty((1, n, 32), device=dev).bernoulli_(
            1.0 - p["dropout_rate"], generator=gen)[0].bool()
        for v in params.values():
            v.requires_grad_(True)
        logits = forward(params, p["num_layers"], feats[0][pyr.order], pyr.xyz,
                         pyr.neigh, pyr.sub, pyr.interp, prec, train=True,
                         keep=keep, dropout=p["dropout_rate"])
        if i == 0:
            logits0 = logits.detach().clone()
        loss = weighted_ce(logits, labels[0][pyr.order], weights)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        for v in params.values():
            v.requires_grad_(False)
        if first is None:
            first = norms(grads)
        losses.append(float(loss.detach()))
        lr = p["learning_rate"] * p["lr_decay"] ** (i // max(p["train_steps"], 1))
        opt.step(grads, lr * lr_scale)
    return {"losses": losses, "grad_norms": first,
            "update_norms": norms({k: params[k] - w0[k] for k in params}),
            "logits0": logits0}
