"""Training and evaluation of the saliency-attention 3-D U-Net, stage 1
(``pointunet_tpu/train/saliency.py``).

* Momentum SGD (0.9, no dampening, not Nesterov) with weight decay
  ``cfg.weight_decay`` added to the gradients of the conv and dense
  kernels only (the reference's ``_kernel_mask``: every ``Conv.weight``
  and ``nn.Linear.weight``; biases and norm affines take none).
  optax adds the decay to the gradient before the momentum trace, and so
  does ``torch.optim.SGD``.
* The reference's stepped learning rate: ``base_lr``, then each
  ``(epoch, value)`` of ``cfg.lr_schedule`` from update
  ``int(epoch * steps_per_epoch)`` on, read at the update count before
  the update. optax multiplies the ratios of consecutive values in f32;
  ``lr_at`` does the same arithmetic, so the two are equal.
* One train step accumulates the gradients of size-1 micro-batches (the
  reference's ``lax.scan``): per-sample losses and gradients are summed,
  then divided by the batch size. The weighted soft-dice loss, or its
  mixup form when the labels carry a class axis.
* Whole-volume prediction through the sliding window (``ops/window.py``),
  with the reference's view transposes, flip and multi-view averaging.

The model's convs run ``F.conv3d`` in training unless
``POINTUNET_FASTCONV`` picks a fold (``fold1``, ``k9``, ``all``: 2-D
``F.conv2d``, differentiable): the reference's train step uses XLA's
convs, never its Pallas conv, which has no gradient. With
``POINTUNET_FASTCONV=pallas`` a train step on the card raises
(``ops/conv_cuda.py:refuse_autograd``); prediction and evaluation run
under ``torch.inference_mode`` and take kernel 3 there.

Volumes are channels-first, (C, D, H, W); batches arrive in the sampler's
(B, D, H, W, C) layout and the channels move on the device. The state
(``SaliencyTrainState``: model, optimizer, step) is mutated in place, as
the point trainer's is; the port runs on one card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import trace
from ..core.config import SaliencyConfig, TrainConfig
from ..models.fastconv import Conv
from ..models.losses import saliency_dice_loss, saliency_dice_loss_mixup
from ..models.saliency_unet import init_saliency_unet
from ..ops.window import sliding_window_inference
from .metrics import binary_dice

MOMENTUM = 0.9


def decay_split(model: nn.Module) -> Tuple[List[str], List[str]]:
    """Parameter names, in ``named_parameters`` order: those that take
    weight decay (conv and dense weights) and the rest."""
    decayed = {
        f"{name}.weight" for name, m in model.named_modules()
        if isinstance(m, (Conv, nn.Linear))
    }
    names = [name for name, _ in model.named_parameters()]
    return ([n for n in names if n in decayed],
            [n for n in names if n not in decayed])


def make_optimizer(
    model: nn.Module, weight_decay: float, lr: float = 0.0
) -> torch.optim.SGD:
    """SGD with momentum 0.9 over two groups: ``decay_split``'s decayed
    parameters (``weight_decay``) and the rest (0)."""
    params = dict(model.named_parameters())
    decayed, rest = decay_split(model)
    return torch.optim.SGD(
        [{"params": [params[n] for n in decayed],
          "weight_decay": weight_decay},
         {"params": [params[n] for n in rest], "weight_decay": 0.0}],
        lr=lr, momentum=MOMENTUM, dampening=0.0, nesterov=False,
    )


@dataclass
class SaliencyTrainState:
    model: nn.Module
    optimizer: torch.optim.SGD
    step: int

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, d: dict) -> None:
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])

    def load_reference(self, flat: dict) -> None:
        """Load a flat reference ``SaliencyTrainState`` (``params/``,
        ``batch_stats/`` for the batch-norm flavour, ``trace/``,
        ``count``, ``step``, ``rng``: what ``export_jax_checkpoint.py``
        writes) through ``convert_saliency_train_state``; the
        ``jax.random`` key ``rng`` is skipped."""
        from ..convert import convert_saliency_train_state

        self.load_state_dict(convert_saliency_train_state(flat, self.model))


class SaliencyTrainer:
    """Owns the config, the step functions and the loops; the model and
    optimizer live in the ``SaliencyTrainState`` it makes. ``attention``
    picks ``SaliencyUNet`` (True) or ``UNet3D``."""

    # view transposes of (D, H, W): into a direction's training view, and
    # back
    _DIR_FWD = {"axial": (0, 1, 2), "sagittal": (2, 0, 1), "coronal": (1, 0, 2)}
    _DIR_INV = {"axial": (0, 1, 2), "sagittal": (1, 2, 0), "coronal": (1, 0, 2)}

    def __init__(
        self,
        config: SaliencyConfig,
        train_config: Optional[TrainConfig] = None,
        attention: bool = True,
        device: str = "cuda",
    ):
        self.cfg = config
        self.tcfg = train_config or TrainConfig()
        self.attention = attention
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SaliencyTrainer: no CUDA device; pass device='cpu' to run "
                "on the CPU"
            )
        if self.tcfg.debug_nans:
            from ..core.debug import enable_nan_trap

            enable_nan_trap(True)
        # (first update, ratio to the previous rate), as optax's
        # piecewise_constant_schedule takes them
        cfg, prev, scales = self.cfg, self.cfg.base_lr, {}
        for epoch, value in cfg.lr_schedule:
            scales[int(epoch * cfg.steps_per_epoch)] = value / prev
            prev = value
        self._scales = sorted(scales.items())

    def lr_at(self, step: int) -> float:
        """The learning rate of the update after ``step`` updates: the
        product of the ratios of every boundary reached, in f32."""
        v = np.float32(self.cfg.base_lr)
        for first, scale in self._scales:
            if step >= first:
                v = np.float32(scale) * v
        return float(v)

    def init_state(self, seed: int = 0) -> SaliencyTrainState:
        model = init_saliency_unet(
            self.cfg, torch.Generator().manual_seed(seed), self.attention
        ).to(self.device)
        opt = make_optimizer(model, self.cfg.weight_decay, self.lr_at(0))
        return SaliencyTrainState(model, opt, 0)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def prepare(self, images, weights, labels):
        """A sampler batch -> port tensors on the device: images (B, C, D,
        H, W) f32, weights (B, D, H, W) f32, labels (B, D, H, W) int or,
        for mixup targets (B, D, H, W, C), (B, C, D, H, W) f32."""
        images = self._tensor(images, torch.float32).permute(0, 4, 1, 2, 3)
        labels = self._tensor(labels)
        if labels.ndim == images.ndim:
            labels = labels.float().permute(0, 4, 1, 2, 3)
        return (images.contiguous(), self._tensor(weights, torch.float32),
                labels.contiguous())

    def forward_loss(self, state: SaliencyTrainState, images, weights,
                     labels) -> torch.Tensor:
        """The training forward and the loss of prepared tensors."""
        logits = state.model.train()(images)
        if labels.ndim == logits.ndim:
            return saliency_dice_loss_mixup(logits, weights, labels)
        return saliency_dice_loss(logits, weights, labels)

    def apply_update(self, state: SaliencyTrainState, batch: int) -> None:
        """Divide the summed gradients by ``batch`` and take one SGD step
        at the learning rate of the update count before it."""
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.div_(batch)
        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_at(state.step)
        state.optimizer.step()
        state.step += 1

    def train_step(self, state: SaliencyTrainState, images, weights, labels,
                   mark: Optional[Callable[[str], None]] = None):
        """One update from a sampler batch, accumulated over size-1
        micro-batches; returns (state, {"loss": float}). ``mark``, when
        given, is called with the name of each part as the host finishes
        queueing it: "prepare", then "forward_loss" and "backward" for each
        micro-batch, then "optimizer" (``chip_smoke.py`` records a CUDA
        event at each to split the step). The same parts are device spans
        of a ``train_saliency`` record of the tracer (``core/trace.py``):
        ``train.forward_loss`` and ``train.backward`` a micro-batch, then
        ``train.update``."""
        mark = mark or (lambda name: None)
        cuda = self.device.type == "cuda"
        with trace.request("train_saliency"):
            images, weights, labels = self.prepare(images, weights, labels)
            mark("prepare")
            state.optimizer.zero_grad(set_to_none=True)
            b = images.shape[0]
            total = torch.zeros((), device=self.device)
            for i in range(b):
                with trace.span("train.forward_loss", device=cuda):
                    loss = self.forward_loss(state, images[i:i + 1],
                                             weights[i:i + 1], labels[i:i + 1])
                mark("forward_loss")
                with trace.span("train.backward", device=cuda):
                    loss.backward()
                mark("backward")
                total += loss.detach()
            with trace.span("train.update", device=cuda):
                self.apply_update(state, b)
            mark("optimizer")
            trace.count("host_sync")          # the loss read back below
            return state, {"loss": float(total / b)}

    @torch.inference_mode()
    def predict_patch(self, state: SaliencyTrainState, images) -> torch.Tensor:
        """Softmax probabilities (B, num_class, D, H, W) of a (B, C, D, H,
        W) batch."""
        images = self._tensor(images, torch.float32)
        return torch.softmax(state.model.eval()(images), dim=1)

    @torch.inference_mode()
    def predict_volume(
        self, state: SaliencyTrainState, volume, dynamic_shape: bool = False,
    ) -> np.ndarray:
        """Sliding-window softmax probabilities (num_class, D, H, W) f32 of
        one (C, D, H, W) volume. ``dynamic_shape`` grows the patch to
        cover the whole volume (each axis rounded up to 16) in one
        window."""
        cfg = self.cfg
        vol = self._tensor(volume, torch.float32)
        if dynamic_shape:
            patch = tuple(
                max(((s + 15) // 16) * 16, p)
                for s, p in zip(vol.shape[1:], cfg.inference_patch_size)
            )
        else:
            patch = tuple(cfg.inference_patch_size)
        model = state.model.eval()
        return sliding_window_inference(
            vol,
            lambda window: torch.softmax(model(window), dim=1),
            patch,
            (cfg.xstep, cfg.ystep, cfg.zstep),
            cfg.num_class,
        ).cpu().numpy()

    def predict_volume_tta(
        self,
        state: SaliencyTrainState,
        volume,
        direction: str = "axial",
        test_flip: bool = False,
    ) -> np.ndarray:
        """``predict_volume`` in ``direction``'s view, the probabilities
        transposed back; ``test_flip`` averages in the prediction of the
        volume flipped along W."""
        vol = np.asarray(volume, np.float32)
        fwd = (0,) + tuple(a + 1 for a in self._DIR_FWD[direction])
        inv = (0,) + tuple(a + 1 for a in self._DIR_INV[direction])
        probs = self.predict_volume(
            state, np.ascontiguousarray(np.transpose(vol, fwd))
        ).transpose(inv)
        if test_flip:
            flipped = self.predict_volume(
                state, np.ascontiguousarray(np.transpose(vol[..., ::-1], fwd))
            ).transpose(inv)[..., ::-1]
            probs = 0.5 * (probs + flipped)
        return probs

    def predict_volume_multiview(
        self, states, volume, test_flip: bool = False
    ) -> np.ndarray:
        """The mean of ``predict_volume_tta`` over three states, trained in
        the axial, sagittal and coronal views (that order)."""
        directions = ("axial", "sagittal", "coronal")
        probs = None
        for state, direction in zip(states, directions):
            p = self.predict_volume_tta(state, volume, direction, test_flip)
            probs = p if probs is None else probs + p
        return probs / len(states)

    def evaluate(
        self, state: SaliencyTrainState, records, log: Callable = print
    ) -> float:
        """Mean whole-volume binary dice of the argmax over ``records``."""
        dices = []
        for rec in records:
            pred = self.predict_volume(state, rec.image).argmax(0)
            dices.append(binary_dice(pred, rec.label))
        mean = float(np.mean(dices)) if dices else 0.0
        log(f"eval mean dice: {mean:.4f} over {len(dices)} volumes")
        return mean

    def fit(
        self,
        state: SaliencyTrainState,
        batch_iter: Iterable,
        eval_records=None,
        checkpointer=None,
        log: Callable = print,
        max_steps: Optional[int] = None,
        metrics=None,
    ) -> SaliencyTrainState:
        """Train ``max_steps`` (default ``steps_per_epoch * max_epoch``)
        steps from ``batch_iter`` (prefetched on a host thread): a
        snapshot every 20 epochs, ``evaluate`` every ``eval_epoch``
        epochs and a best-dice checkpoint. ``metrics`` (a
        ``core.metrics_sink.MetricsLogger``) receives loss, lr and
        ms/batch every ``log_every`` steps and the dice per evaluation."""
        from ..data.prefetch import PrefetchIterator, prefetch

        cfg = self.cfg
        total = max_steps or cfg.steps_per_epoch * cfg.max_epoch
        best = -1.0
        t0 = time.time()
        batches = prefetch(batch_iter, self.tcfg.prefetch_buffers)
        try:
            for i, (images, weights, labels) in enumerate(batches):
                if i >= total:
                    break
                state, m = self.train_step(state, images, weights, labels)
                step = state.step
                if step % self.tcfg.log_every == 0:
                    dt = (time.time() - t0) * 1000 / self.tcfg.log_every
                    log(f"Step {step:08d} dice_loss={m['loss']:.4f} "
                        f"---{dt:8.2f} ms/batch")
                    if metrics is not None:
                        metrics.log(step, loss=m["loss"], lr=self.lr_at(step),
                                    ms_per_batch=dt)
                    t0 = time.time()
                if step % cfg.steps_per_epoch:
                    continue
                epoch = step // cfg.steps_per_epoch
                if checkpointer is not None and epoch % 20 == 0:
                    checkpointer.save(state, step)
                if eval_records is not None and epoch % cfg.eval_epoch == 0:
                    dice = self.evaluate(state, eval_records, log)
                    if metrics is not None:
                        metrics.log(step, eval_dice=dice, epoch=epoch)
                    if dice > best:
                        best = dice
                        if checkpointer is not None:
                            checkpointer.save(state, step, dice)
        finally:
            if isinstance(batches, PrefetchIterator):
                batches.close()
        return state
