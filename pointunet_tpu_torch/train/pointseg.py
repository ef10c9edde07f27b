"""Training and evaluation of the RandLA-Net point net
(``pointunet_tpu/train/pointseg.py``).

One train step builds the KNN pyramid on the card (kernel 1), gathers
the row-aligned features and labels into its level-0 order, runs the
training forward, the class-weighted cross-entropy, the backward (whose
K-neighbour gathers run the sorted scatter, kernel 2, on the large
levels) and an Adam update with optax's defaults (b1 0.9, b2 0.999, eps
1e-8). The learning rate is ``lr * lr_decay ** (step // train_steps)``,
read at the update count before the update, as optax's schedule does.

Unlike the reference's pure functions, the state (``TrainState``: model,
optimizer, step, dropout generator) is mutated in place: ``train_step``
updates it and returns it; there is no buffer donation.

Under a mesh (``parallel/mesh.py``; the reference's ``mesh=``, which
GSPMD shards), one process runs each rank and ``train_step`` takes the
rank's clouds of the batch (``shard_batch``):

* data axis: each rank holds other clouds of the global batch;
* point axis: the ranks of a point group hold the same clouds, share the
  large levels' pyramid searches (``build_pyramid_sharded`` from
  ``point_shard_min`` rows) and split the point net's activations: rank
  p runs slab p of every level's rows, forward and backward
  (``RandLANet(point_group=)``), and takes slab p of the level-0
  features and labels.

The rows of the global batch are thus spread over the whole mesh: the
batch norms take the global batch's statistics over the mesh group and
the dropout mask is the global batch's; each rank divides its rows'
weighted CE sum by the global valid count, backpropagates that share,
and the parameter gradients are summed (not averaged) over the mesh in
one all-reduce before the Adam update, so the parameters stay bit-equal
on every rank; the reported loss and accuracy are global.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import trace
from ..core.config import PointSegConfig, TrainConfig
from ..models.losses import weighted_cross_entropy_terms
from ..models.randlanet import RandLANet, init_randlanet
from ..ops.pyramid import Pyramid, build_pyramid_batch, take_level0
from ..ops.pyramid_sharded import build_pyramid_sharded
from ..parallel import collectives
from ..parallel.mesh import DATA_AXIS, POINT_AXIS, Mesh, shard_batch
from .metrics import confusion_matrix, iou_from_confusion

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    model: RandLANet
    optimizer: torch.optim.Adam
    step: int
    generator: torch.Generator     # dropout keep-masks

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])
        if "generator" in d:
            self.generator.set_state(d["generator"])

    def load_reference(self, flat: dict) -> None:
        """Load a flat reference ``TrainState`` (``params/``,
        ``batch_stats/``, ``mu/``, ``nu/``, ``count``, ``step``, ``rng``:
        what ``export_jax_checkpoint.py`` writes) through
        ``convert_train_state``. The reference's ``rng`` is a
        ``jax.random`` key that torch cannot continue: it is skipped and
        the dropout generator keeps its state."""
        from ..convert import convert_train_state

        self.load_state_dict(convert_train_state(flat, self.model))


class PointSegTrainer:
    """Owns the config, the step functions and the epoch loop; the model
    and optimizer live in the ``TrainState`` it makes."""

    def __init__(
        self,
        config: PointSegConfig,
        train_config: Optional[TrainConfig] = None,
        device: str = "cuda",
        mesh: Optional[Mesh] = None,
        point_shard_min: int = 32_768,
    ):
        """``mesh``: run as this rank of a (data, point) mesh, on the
        mesh's device (``device`` is then not read).
        ``point_shard_min``: the smallest pyramid level whose searches
        the point group shares; smaller levels search on every rank."""
        self.cfg = config
        self.tcfg = train_config or TrainConfig()
        self.mesh = mesh
        self.point_shard_min = point_shard_min
        self.device = torch.device(device) if mesh is None else mesh.device
        # the data and point groups when they have other ranks, and the
        # group of the whole mesh when it has several; None on one process
        self.data_group, self.point_group = (
            mesh.groups[axis]
            if mesh is not None and mesh.shape[axis] > 1 else None
            for axis in (DATA_AXIS, POINT_AXIS)
        )
        self.mesh_group = None if (
            self.data_group is None and self.point_group is None
        ) else mesh.group
        self.is_main = mesh is None or (
            mesh.coords[DATA_AXIS] == 0 and mesh.coords[POINT_AXIS] == 0)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PointSegTrainer: no CUDA device; pass device='cpu' to run "
                "on the CPU"
            )
        if self.tcfg.debug_nans:
            from ..core.debug import enable_nan_trap

            enable_nan_trap(True)
        self._best_miou = 0.0

    def lr_at(self, step: int) -> float:
        """The per-epoch decayed learning rate after ``step`` updates."""
        cfg = self.cfg
        return cfg.learning_rate * cfg.lr_decay ** (
            step // max(cfg.train_steps, 1)
        )

    def init_state(self, seed: int = 0) -> TrainState:
        model = init_randlanet(
            self.cfg, torch.Generator().manual_seed(seed), self.data_group,
            self.point_group, self.mesh_group)
        model = model.to(self.device)
        opt = torch.optim.Adam(
            model.parameters(), lr=self.lr_at(0), betas=ADAM_BETAS,
            eps=ADAM_EPS,
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(model, opt, 0, gen)

    def pyramid_fn(self, xyz: torch.Tensor) -> Pyramid:
        cfg = self.cfg
        with torch.no_grad():
            if self.mesh is not None and self.mesh.shape[POINT_AXIS] > 1:
                return build_pyramid_sharded(
                    xyz, cfg.k_n, cfg.sub_sampling_ratio, self.mesh,
                    shard_min=self.point_shard_min,
                )
            return build_pyramid_batch(xyz, cfg.k_n, cfg.sub_sampling_ratio)

    def shard_batch(self, *arrays):
        """This rank's rows of each (B, ...) array (``parallel.mesh
        .shard_batch``); the arrays as they are without a mesh."""
        if self.mesh is None:
            return arrays
        return shard_batch(self.mesh, *arrays)

    @staticmethod
    def _sum(t: torch.Tensor, group) -> torch.Tensor:
        """``t`` summed over ``group`` (None: itself), outside autograd."""
        t = t.detach().clone()
        if group is not None:
            collectives.all_reduce_(t, group)
        return t

    def mesh_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh (over the rows of the global batch),
        outside autograd."""
        return self._sum(t, self.mesh_group)

    def _loss_fn(self, state: TrainState, pyramid, feats, labels):
        """(this rank's share of the loss, global accuracy): the weighted
        CE sum of its rows over the global batch's valid count."""
        logits = state.model(feats, pyramid, state.generator)
        cfg = self.cfg
        total, count = weighted_cross_entropy_terms(
            logits, labels, cfg.class_weights(), cfg.num_classes,
            cfg.ignored_label_inds,
        )
        loss = total / self.mesh_sum(count).clamp(min=1)
        hits = (logits.argmax(-1) == labels).sum()
        seen = torch.tensor(labels.numel(), device=hits.device)
        hits, seen = self.mesh_sum(torch.stack([hits, seen]))
        return loss, hits.float() / seen.float()

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def forward_loss(self, state: TrainState, pyramid: Pyramid, feats, labels):
        """The training forward and loss on a built pyramid: (loss, acc).
        ``feats`` (B, N, 3 + F) and ``labels`` (B, N) are row-aligned with
        the input cloud; the model takes this rank's slab of their level-0
        rows (all of them without a point group)."""
        feats, labels = take_level0(pyramid, feats, labels)
        rows = state.model.slab(pyramid.xyz[0].shape[1]).rows
        feats, labels = feats[:, rows], labels[:, rows]
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        return self._loss_fn(state, pyramid, feats, labels)

    def apply_update(self, state: TrainState) -> None:
        """One Adam update from the parameters' ``.grad`` (under a mesh,
        first summed over it: ``_sync_gradients``), at the learning rate of
        the update count before it."""
        if self.mesh_group is not None:
            self._sync_gradients(state.model)
        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_at(state.step)
        state.optimizer.step()
        state.step += 1

    def _sync_gradients(self, model: torch.nn.Module) -> None:
        """Every parameter's ``.grad``, flattened into one buffer and
        summed over the mesh in one all-reduce: each rank's is the
        gradient of its rows' share of the loss, so the sum is the global
        batch's, the same bytes on every rank."""
        params = list(model.parameters())
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in params
        ])
        collectives.all_reduce_(flat, self.mesh_group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def train_core(self, state: TrainState, pyramid: Pyramid, feats, labels):
        """Forward, loss, backward and Adam update on a built pyramid;
        the gradients stay in the parameters' ``.grad``. The loss is the
        global batch's. A ``train_point`` record of the tracer, with the
        device spans ``train.forward_loss``, ``train.backward`` and
        ``train.update`` (``core/trace.py``)."""
        cuda = self.device.type == "cuda"
        with trace.request("train_point"):
            with trace.span("train.forward_loss", device=cuda):
                loss, acc = self.forward_loss(state, pyramid, feats, labels)
            with trace.span("train.backward", device=cuda):
                loss.backward()
            with trace.span("train.update", device=cuda):
                self.apply_update(state)
        return state, {"loss": self.mesh_sum(loss), "acc": acc.detach()}

    def train_step(self, state: TrainState, xyz, feats, labels):
        """One step from a cloud: the pyramid (device span
        ``train.pyramid``), then ``train_core``, in one record."""
        with trace.request("train_point"):
            xyz = self._tensor(xyz, torch.float32)
            with trace.span("train.pyramid", device=self.device.type == "cuda"):
                pyramid = self.pyramid_fn(xyz)
            return self.train_core(
                state, pyramid, self._tensor(feats, torch.float32),
                self._tensor(labels, torch.long),
            )

    def eval_step(self, state: TrainState, xyz, feats, labels=None):
        """Softmax probabilities (B, N, C) in the caller's row order (of
        this rank's clouds, under a mesh: the point group's slabs are
        gathered)."""
        xyz = self._tensor(xyz, torch.float32)
        pyramid = self.pyramid_fn(xyz)
        feats = take_level0(pyramid, self._tensor(feats, torch.float32))
        slab = state.model.slab(pyramid.xyz[0].shape[1])
        state.model.eval()
        with torch.no_grad():
            probs = torch.softmax(
                state.model(feats[:, slab.rows], pyramid), dim=-1)
            probs = slab.whole(probs)
        inv = torch.argsort(pyramid.order.long(), dim=-1)
        return probs.gather(1, inv[..., None].expand_as(probs))

    def evaluate(
        self, state: TrainState, val_iter: Iterable, log: Callable = print
    ) -> float:
        """Confusion-matrix mean IoU (%) over a validation iterator of
        global batches; under a mesh each rank scores its rows and the
        confusion matrix is summed over the data group (the point ranks of
        a cloud score it whole, each)."""
        nc = self.cfg.num_classes
        conf = np.zeros((nc, nc), np.int64)
        correct = seen = 0
        ignored = tuple(self.cfg.ignored_label_inds)
        # predictions live in the ignored-collapsed class space (the loss
        # remaps labels); apply the same remap to the raw labels
        total = nc + len(ignored)
        remap = np.zeros(total, np.int64)
        nxt = 0
        for lab_val in range(total):
            if lab_val not in ignored:
                remap[lab_val] = nxt
                nxt += 1
        for xyz, feats, labels in val_iter:
            xyz, feats, labels = self.shard_batch(xyz, feats, labels)
            probs = self.eval_step(state, xyz, feats, labels).cpu().numpy()
            pred = probs.argmax(-1).reshape(-1)
            lab = np.asarray(torch.as_tensor(labels).cpu()).reshape(-1)
            valid = np.ones_like(lab, bool)
            for ign in ignored:
                valid &= lab != ign
            pred, lab = pred[valid], remap[lab[valid]]
            conf += confusion_matrix(lab, pred, nc)
            correct += int((pred == lab).sum())
            seen += lab.size
        if self.data_group is not None:
            totals = self._sum(torch.as_tensor(
                np.append(conf.reshape(-1), [correct, seen]),
                device=self.device), self.data_group)
            totals = totals.cpu().numpy()
            conf = totals[:-2].reshape(nc, nc)
            correct, seen = int(totals[-2]), int(totals[-1])
        iou = iou_from_confusion(conf)
        miou = float(iou.mean()) * 100.0
        log(
            f"eval accuracy: {correct / max(seen, 1):.4f}  "
            f"mean IoU: {miou:.1f}%  per-class "
            + " ".join(f"{100 * v:5.2f}" for v in iou)
        )
        return miou

    def fit(
        self,
        state: TrainState,
        train_epoch_iter: Callable[[], Iterable],
        val_iter_fn: Optional[Callable[[], Iterable]] = None,
        checkpointer=None,
        log: Callable = print,
        metrics=None,
    ) -> TrainState:
        """Epoch loop: train steps, epoch-end eval, best-mIoU checkpoint.
        ``metrics`` (a ``core.metrics_sink.MetricsLogger``) receives
        loss/acc/lr every ``log_every`` steps and the mIoU per epoch.
        Under a mesh every rank reads the same global batches and takes
        its rows; rank 0 alone logs, records metrics and saves, and the
        ranks wait for its checkpoint at a barrier."""
        from ..core.debug import StepTimer, format_eta
        from ..data.prefetch import prefetch

        if not self.is_main:
            log, metrics, checkpointer = (lambda *a, **k: None), None, None
        timer = StepTimer(self.cfg.max_epoch * max(self.cfg.train_steps, 1))
        for epoch in range(self.cfg.max_epoch):
            log(f"****EPOCH {epoch}****")
            epoch_iter = prefetch(
                train_epoch_iter(), self.tcfg.prefetch_buffers
            )
            for i, (xyz, feats, labels) in enumerate(epoch_iter):
                xyz, feats, labels = self.shard_batch(xyz, feats, labels)
                state, m = self.train_step(state, xyz, feats, labels)
                if (i + 1) % self.tcfg.log_every == 0:
                    t = timer.tick(self.tcfg.log_every)
                    log(
                        f"Step {state.step:08d} "
                        f"L_out={float(m['loss']):5.3f} "
                        f"Acc={float(m['acc']):4.2f} "
                        f"---{t['ms_per_batch']:8.2f} ms/batch "
                        f"ETA {format_eta(t['eta_sec'])}"
                    )
                    if metrics is not None:
                        metrics.log(
                            state.step,
                            loss=float(m["loss"]),
                            accuracy=float(m["acc"]),
                            lr=self.lr_at(state.step),
                            ms_per_batch=t["ms_per_batch"],
                        )
            if val_iter_fn is not None:
                miou = self.evaluate(state, val_iter_fn(), log)
                if metrics is not None:
                    metrics.log(state.step, miou=miou, epoch=epoch)
                if miou > self._best_miou:
                    self._best_miou = miou
                    if checkpointer is not None:
                        checkpointer.save(state, state.step, miou)
                    if self.mesh is not None:
                        dist.barrier()
                log(f"Best m_IoU is: {self._best_miou:5.3f}")
        return state
