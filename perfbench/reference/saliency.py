"""Plain reference of the saliency-attention 3-D U-Net (Point-Unet stage 1).

A function of a flat parameter dict, named as the port's state dict names
them, so that one set of seeded tensors feeds both. Channels-first: input
(B, C, D, H, W), logits (B, num_class, D, H, W) in float32. Every conv and
dense operand goes through ``prec`` (``precision.py``). Layers, as the
paper's attention U-Net has them:

* encoder: init 3x3x3 conv, then per scale a residual block of two 3x3x3
  convs and a stride-2 3x3x3 down conv (XLA's SAME padding: (0, 1) on an
  even axis); every conv is followed by instance norm (eps 1e-5) and relu;
* context blocks on the three deepest scales: a 1x1x1 conv and 3x3x3
  convs dilated 3, 5, 7, without bias, concatenated;
* the two deepest upsampled (nearest, x4 and x2) by a 3x3x3 conv,
  concatenated with the third; channel attention (mean, dense C/4 relu,
  dense C sigmoid, multiply); a 1x1x1 conv to 64; nearest x4 and a conv;
* the spatial gate: three separable pairs of 9-tap convs, each followed by
  instance norm and relu, summed, sigmoid; at ``sa_gate_stride`` s > 1 on
  the s^3 mean-pooled input, resized back trilinearly;
* the low level: 3x3x3 convs of scales 0 and 1 (the second upsampled x2),
  concatenated, a conv, times the gate; with the high level, the head
  conv to the classes.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import F32


def _same_pads(size, kernel, stride, dilation):
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv(P, name, x, stride=1, dilation=1, upsample=1, prec=F32()):
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias")
    if upsample > 1:
        x = F.interpolate(x, scale_factor=upsample, mode="nearest")
    k = tuple(w.shape[2:])
    st, dl = (stride,) * 3, (dilation,) * 3
    pads = _same_pads(x.shape[2:], k, st, dl)
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    y = F.conv3d(prec(x), prec(w), None, st, 0, dl)
    return y if b is None else y + b.float().view(1, -1, 1, 1, 1)


def norm_relu(P, name, x):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    return F.relu(F.group_norm(x, x.shape[1], w.float(), b.float(), 1e-5))


def cnr(P, name, x, prec, **kw):
    h = conv(P, f"{name}.Conv_0", x, prec=prec, **kw)
    return norm_relu(P, f"{name}.NormRelu_0.GroupNorm_0", h)


def encoder(P, cfg: dict, x, prec):
    """Per-scale features of ``_Encoder_0``."""
    e = "_Encoder_0"
    n_cnr = 0
    x = cnr(P, f"{e}.ConvNormRelu_{n_cnr}", x, prec)
    n_cnr += 1
    ch = cfg["base_filter"]
    down = []
    for d in range(cfg["depth"]):
        filters = cfg["base_filter"] * (2 ** d if cfg["filter_grow"] else 1)
        if cfg["residual"] and ch != filters:
            x = cnr(P, f"{e}.ConvNormRelu_{n_cnr}", x, prec)
            n_cnr += 1
            ch = filters
        h = x
        for j in range(2):
            h = cnr(P, f"{e}.UNetBlock_{d}.ConvNormRelu_{j}", h, prec)
        x = x + h if cfg["residual"] else h
        down.append(x)
        if d != cfg["depth"] - 1:
            x = cnr(P, f"{e}.ConvNormRelu_{n_cnr}", x, prec, stride=2)
            n_cnr += 1
            ch = filters * 2
    return down


def _spatial_gate(P, x, prec):
    g = None
    for i in range(3):
        h = conv(P, f"SpatialAttention3D_0.Conv_{2 * i}", x, prec=prec)
        h = norm_relu(P, f"SpatialAttention3D_0.NormRelu_{2 * i}.GroupNorm_0", h)
        h = conv(P, f"SpatialAttention3D_0.Conv_{2 * i + 1}", h, prec=prec)
        h = norm_relu(
            P, f"SpatialAttention3D_0.NormRelu_{2 * i + 1}.GroupNorm_0", h)
        g = h if g is None else g + h
    return torch.sigmoid(g)                                   # (B, 1, ...)


def forward(P: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            prec=F32()) -> torch.Tensor:
    """Logits (B, num_class, D, H, W) f32 of a (B, C, D, H, W) input."""
    x = x.float()
    down = encoder(P, cfg, x, prec)
    c1 = cnr(P, "ConvNormRelu_0", down[0], prec)
    c2 = cnr(P, "ConvNormRelu_1", down[1], prec)
    cfe = []
    for i, d in enumerate(down[2:5]):
        branches = [cnr(P, f"CFE3D_{i}.ConvNormRelu_0", d, prec)]
        for j, rate in enumerate((3, 5, 7)):
            branches.append(cnr(P, f"CFE3D_{i}.ConvNormRelu_{j + 1}", d, prec,
                                dilation=rate))
        cfe.append(torch.cat(branches, 1))
    c3, c4, c5 = cfe
    c5 = cnr(P, "UpsampleConv_0.ConvNormRelu_0", c5, prec, upsample=4)
    c4 = cnr(P, "UpsampleConv_1.ConvNormRelu_0", c4, prec, upsample=2)
    c345 = torch.cat([c3, c4, c5], 1)
    if cfg["ca_attention"]:
        a = c345.mean(dim=(2, 3, 4))
        a = F.relu(F.linear(prec(a), prec(P["ChannelWiseAttention3D_0.Dense_0.weight"]),
                            P["ChannelWiseAttention3D_0.Dense_0.bias"].float()))
        a = torch.sigmoid(F.linear(
            prec(a), prec(P["ChannelWiseAttention3D_0.Dense_1.weight"]),
            P["ChannelWiseAttention3D_0.Dense_1.bias"].float()))
        c345 = c345 * a[:, :, None, None, None]
    c345 = cnr(P, "ConvNormRelu_2", c345, prec)
    c345 = cnr(P, "UpsampleConv_2.ConvNormRelu_0", c345, prec, upsample=4)
    sa = None
    if cfg["sa_attention"]:
        s = cfg["sa_gate_stride"]
        if s > 1:
            b, c, d, h, w = c345.shape
            pooled = c345[:, :, :d // s * s, :h // s * s, :w // s * s].reshape(
                b, c, d // s, s, h // s, s, w // s, s).mean(dim=(3, 5, 7))
            sa = F.interpolate(_spatial_gate(P, pooled, prec),
                               size=c345.shape[2:], mode="trilinear",
                               align_corners=False)
        else:
            sa = _spatial_gate(P, c345, prec)
    c2 = cnr(P, "UpsampleConv_3.ConvNormRelu_0", c2, prec, upsample=2)
    c12 = cnr(P, "ConvNormRelu_3", torch.cat([c1, c2], 1), prec)
    if sa is not None:
        c12 = sa * c12
    return conv(P, "Conv_0", torch.cat([c12, c345], 1), prec=prec)


def dice_loss(logits, weight, labels):
    """Batch mean of the weighted V-Net soft dice (squared denominator)
    over the softmax: logits (B, C, D, H, W), weight and labels (B, D, H,
    W)."""
    b, c = logits.shape[:2]
    probs = torch.softmax(logits.float().reshape(b, c, -1), 1).transpose(1, 2)
    onehot = F.one_hot(labels.reshape(b, -1).long(), c).float()
    w = weight.reshape(b, -1, 1).float()
    num = 2.0 * (w * onehot * probs).sum(1)
    den = (w * probs * probs).sum(1) + (onehot * w).sum(1)
    return (1.0 - (num / (den + 1e-5)).mean(-1)).mean()


DECAYED = ("Conv_", "Dense_")


def decayed(name: str) -> bool:
    """Conv and dense kernels take weight decay; biases and norms do not."""
    parts = name.split(".")
    return parts[-1] == "weight" and parts[-2].startswith(DECAYED)


def lr_at(s: dict, step: int) -> float:
    """The stepped learning rate of the update after ``step`` updates."""
    lr = s["base_lr"]
    for epoch, value in s["lr_schedule"]:
        if step >= int(epoch * s["steps_per_epoch"]):
            lr = value
    return lr


def train_steps(cfg: dict, w0: Dict[str, torch.Tensor], batches, prec=F32(),
                lr_scale: float = 1.0) -> dict:
    """The first ``len(batches)`` train steps from weights ``w0``: each
    micro-batch of one patch runs the forward and the weighted soft dice,
    the gradients are summed over the batch and divided by its size, and
    momentum SGD (0.9) with weight decay on the conv and dense kernels
    updates the weights (the rate times ``lr_scale``). Returns the losses
    (batch means), the first
    gradient as the optimizer took it (decay added) and each leaf's change
    after the steps."""
    from .judge_train import MomentumSGD, norms

    s = cfg["saliency"]
    params = {k: v.detach().clone().float() for k, v in w0.items()}
    opt = MomentumSGD(params, [k for k in params if decayed(k)], s["weight_decay"])
    losses, first = [], None
    for i, (images, weights, labels) in enumerate(batches):
        b = images.shape[0]
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for j in range(b):
            for v in params.values():
                v.requires_grad_(True)
            x = images[j:j + 1].permute(0, 4, 1, 2, 3).float()
            logits = forward(params, s, x, prec)
            if i == 0 and j == 0:
                logits0 = logits.detach().clone()
            loss = dice_loss(logits, weights[j:j + 1], labels[j:j + 1])
            for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                grads[k] += g
            for v in params.values():
                v.requires_grad_(False)
            total += float(loss.detach())
        grads = {k: g / b for k, g in grads.items()}
        took = opt.step(grads, lr_at(s, i) * lr_scale)
        if first is None:
            first = norms(took)
        losses.append(total / b)
    return {"losses": losses, "grad_norms": first,
            "update_norms": norms({k: params[k] - w0[k] for k in params}),
            "logits0": logits0}
