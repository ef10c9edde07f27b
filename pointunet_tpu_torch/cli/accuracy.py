"""Accuracy of the fused path on the reference's seeded synthetic volumes
(``bench.py --preset accuracy`` and ``--preset accuracy_pancreas``,
``bench_accuracy`` and ``bench_accuracy_pancreas``).

    python -m pointunet_tpu_torch.cli.accuracy --dataset brats|pancreas \
        [--saliency_steps 400] [--pointseg_steps 800] [--acc_full] \
        [--acc_bf16] [--saliency_bf16] [--sa_stride S] [--att_downscale S] \
        [--seed N] [--saliency_init DIR] [--pointseg_init DIR] \
        [--device cuda|cpu]

Trains both nets on 4 synthetic volumes (``data/synthetic.py``, drawn
from ``default_rng(0)`` as the reference draws them, then 2 held-out
ones), runs ``FusedPointUnet`` on the held-out volumes and scores its
labels: WT/TC/ET Dice and HD95 for BraTS, binary Dice and HD95 for
Pancreas, raw and after ``postprocess_brats``/``postprocess_pancreas``,
beside the per-voxel QDA control (class-conditional Gaussians of the
voxel intensities: what no spatial context can beat). Step by step:

1. volumes: the reduced task, (96, 96, 64) at 65,536 points with
   (32, 96, 96) patches (BraTS: ROI (88, 88, 60), lesions of r_div 10),
   or with ``--acc_full`` the reference's contract: BraTS (240, 240,
   155), 365,000 points, (64, 160, 160), ROI (192, 208, 155), r_div 16;
   Pancreas (256, 256, 160), 180,000 points, no ROI;
2. the saliency net, batch 1 at lr 0.01 on ``patch_batches`` from
   ``default_rng(1)`` ("one_positive"), trained in f32 (on the card
   with cuDNN's default TF32 convs and its deterministic algorithms), as
   the reference trains it on any backend but a TPU; ``--saliency_bf16``
   trains it in bf16 on the card, the reference's recipe on its TPU
   (over the reference's draws neither recipe is ahead: ROADMAP
   queue 3);
3. one cloud a training volume, sampled on the device around its true
   tumour mask by ``sample_cloud_device`` from a generator seeded with
   its index;
4. the point net on the clouds in turn (BraTS at lr 1e-3, Pancreas at its
   config's), f32 unless ``--acc_bf16`` (bf16 then on the card only, as
   the reference's is on its accelerator only);

5. the fused path (threshold 0.5; the saliency net in bf16 on the card,
   as the port serves it, in f32 on the CPU, whatever type trained it):
   one warm-up request (seed 99), then
   held-out volume i (seed 100 + i) timed from its synced upload to a
   synced label; BraTS labels 3 are written as 4 before scoring; HD95 is
   clamped to the volume's diagonal;
6. ``--sa_stride`` s > 1 evaluates the stride-1-trained weights again
   with the gate at stride s; ``--att_downscale`` s > 1 evaluates with
   the attention at 1/s resolution, once with the mask dilated by s and
   once with a boundary band of 4.

Both nets start from the port's initialisation drawn from ``--seed``
(0), or from a train state of the JAX package exported by ``python
export_jax_checkpoint.py --init K --stage saliency|pointseg --out DIR``
(``--saliency_init DIR``, ``--pointseg_init DIR``). Training is
bit-reproducible on the card: the same flags give the same weights and
the same Dice on every run.

Prints the reference's one-line JSON, plus ``card`` (``nvidia-smi``'s
name and power limit; null on the CPU) and ``launches`` (each CUDA
kernel's launches by stage); each stage's seconds and, on the card, peak
device memory go to stderr. The point samples come from ``torch``
generators, not from ``jax.random``: the points differ from the
reference's, the volumes do not. Runs on the card unless ``--device
cpu``; with no card it fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checkpoint import BestMetricCheckpointer
from ..core.config import (
    TrainConfig,
    brats_pointseg_config,
    brats_saliency_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from ..data.sampler import VolumeRecord, patch_batches
from ..data.synthetic import synth_brats_volume, synth_pancreas_volume
from ..models.saliency_unet import init_saliency_unet
from ..ops.launches import read_launches
from ..ops.sampling import DeviceCloud, sample_cloud_device
from ..pipeline.fused import FusedPointUnet
from ..pipeline.postprocess import postprocess_brats, postprocess_pancreas
from ..train.metrics import (
    binary_dice,
    brats_region_dice,
    brats_region_hd95,
    hausdorff95,
)
from ..train.pointseg import PointSegTrainer
from ..train.saliency import SaliencyTrainer

# the denominators of vs_baseline: the reference's BraTS20 offline mean
# Dice (BASELINE.md) and the ~0.80 its paper reports on NIH Pancreas-CT
BRATS_BASELINE_DICE = 0.8302
PANCREAS_BASELINE_DICE = 0.80
REGIONS = ("WT", "TC", "ET")


@dataclass(frozen=True)
class Task:
    """The sizes of one accuracy run."""

    shape: Tuple[int, int, int]            # (X, Y, Z)
    n_points: int
    patch: Tuple[int, int, int]            # (D, H, W) saliency patches
    roi: Optional[Tuple[int, int, int]]    # (X, Y, Z) attention window
    r_div: int = 10                        # BraTS lesion size divisor


def brats_task(full: bool) -> Task:
    if full:
        return Task((240, 240, 155), 365_000, (64, 160, 160),
                    (192, 208, 155), 16)
    return Task((96, 96, 64), 65_536, (32, 96, 96), (88, 88, 60), 10)


def pancreas_task(full: bool) -> Task:
    if full:
        return Task((256, 256, 160), 180_000, (64, 160, 160), None)
    return Task((96, 96, 64), 65_536, (32, 96, 96), None)


def make_volumes(dataset: str, task: Task):
    """(4 training, 2 held-out) (modalities, labels) pairs, in the
    reference's order of draws from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    if dataset == "brats":
        make = lambda: synth_brats_volume(rng, task.shape, task.r_div)  # noqa: E731
    else:
        make = lambda: synth_pancreas_volume(rng, task.shape)  # noqa: E731
    train = [make() for _ in range(4)]
    test = [make() for _ in range(2)]
    return train, test


def saliency_records(vols, dataset: str) -> List[VolumeRecord]:
    """(C, Z, Y, X) records of the training volumes; BraTS labels become
    the binary tumour mask."""
    records = []
    for mods, seg in vols:
        vol = np.transpose(mods, (0, 3, 2, 1))
        lab = np.transpose(seg, (2, 1, 0))
        lab = (lab > 0 if dataset == "brats" else lab).astype(np.int32)
        records.append(VolumeRecord(vol, np.ones_like(lab, np.float32), lab))
    return records


def train_saliency(trainer: SaliencyTrainer, state, records, steps: int,
                   log: Callable = print):
    """``steps`` updates on ``patch_batches`` of ``records`` from
    ``default_rng(1)``; returns (state, the loss of every step)."""
    cfg = trainer.cfg
    batches = patch_batches(records, cfg.patch_size, cfg.batch_size,
                            np.random.default_rng(1), "one_positive")
    losses = []
    for k, (im, w, lab) in zip(range(steps), batches):
        state, m = trainer.train_step(state, im, w, lab)
        losses.append(m["loss"])
        if k % 100 == 0:
            log(f"[accuracy] saliency step {k}/{steps} loss={m['loss']:.4f}")
    return state, np.asarray(losses, np.float64)


@contextlib.contextmanager
def tf32_convs():
    """cuDNN's default for f32 convs (TF32 products, f32 sums) within,
    whatever the caller set (``chip_smoke.py`` turns TF32 off for its
    bars): the saliency net's f32 training recipe on the card."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms within (``cudnn.deterministic``),
    as they were after: with cuDNN's own choice, two runs of the
    saliency stage from one state end in other weights."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def sample_clouds(vols, n_points: int, device) -> List[DeviceCloud]:
    """One cloud a volume on ``device``, around its true tumour mask,
    cloud i from a generator seeded with i."""
    clouds = []
    for i, (mods, seg) in enumerate(vols):
        clouds.append(sample_cloud_device(
            torch.as_tensor(mods, device=device),
            torch.as_tensor((seg > 0).astype(np.uint8), device=device),
            torch.Generator(device=device).manual_seed(i), n_points,
            labels=torch.as_tensor(seg, device=device),
        ))
    return clouds


def train_pointseg(trainer: PointSegTrainer, state, clouds, steps: int,
                   log: Callable = print):
    """``steps`` updates on ``clouds`` in turn, features = (xyz,
    intensities); returns (state, the loss of every step). The losses
    stay on the device until the end."""
    losses = []
    for k in range(steps):
        c = clouds[k % len(clouds)]
        feats = torch.cat([c.xyz, c.features], -1)[None]
        state, m = trainer.train_step(state, c.xyz[None], feats,
                                      c.labels[None])
        losses.append(m["loss"].detach().reshape(()))
        if k % 200 == 0:
            log(f"[accuracy] pointseg step {k}/{steps} "
                f"loss={float(m['loss']):.4f}")
    if not losses:
        return state, np.zeros(0)
    return state, torch.stack(losses).double().cpu().numpy()


def fit_qda(train_vols, max_fit=2_000_000):
    """Per-voxel QDA: full-covariance Gaussians of each class's C-channel
    intensity vectors with log class priors, fitted on the training
    volumes' nonzero voxels (at most ``max_fit`` of them, drawn from
    ``default_rng(7)``)."""
    feats, labs = [], []
    for mods, seg in train_vols:
        m = np.any(mods != 0, axis=0)
        feats.append(mods[:, m].T)
        labs.append(seg[m])
    X = np.concatenate(feats)
    yv = np.concatenate(labs)
    if X.shape[0] > max_fit:
        sel = np.random.default_rng(7).choice(
            X.shape[0], max_fit, replace=False
        )
        X, yv = X[sel], yv[sel]
    classes = np.unique(yv)
    params = []
    for c in classes:
        Xc = X[yv == c]
        mu = Xc.mean(0)
        cov = np.atleast_2d(np.cov(Xc.T)) + 1e-4 * np.eye(X.shape[1])
        params.append((
            float(np.log(len(Xc) / len(X))), mu,
            np.linalg.inv(cov), float(np.linalg.slogdet(cov)[1]),
        ))
    return classes, params


def qda_predict(classes, params, mods):
    """The argmax-posterior class of every nonzero voxel; background 0."""
    m = np.any(mods != 0, axis=0)
    Xt = mods[:, m].T
    scores = np.empty((Xt.shape[0], len(classes)), np.float32)
    for j, (logp, mu, icov, logdet) in enumerate(params):
        d = Xt - mu
        scores[:, j] = logp - 0.5 * (logdet + ((d @ icov) * d).sum(1))
    pred = np.zeros(m.shape, np.int32)
    pred[m] = classes[np.argmax(scores, 1)]
    return pred


def pervoxel_gmm_baseline(train_vols, test_vols) -> dict:
    """The BraTS QDA control: mean WT/TC/ET Dice over the held-out
    volumes, in BraTS labels."""
    classes, params = fit_qda(train_vols)
    dices = []
    for mods, seg in test_vols:
        pred = qda_predict(classes, params, mods)
        pred[pred == 3] = 4
        truth = np.where(seg == 3, 4, seg)
        dices.append(brats_region_dice(pred, truth))
    return {k: float(np.mean([d[k] for d in dices])) for k in REGIONS}


def pancreas_gmm_baseline(train_vols, test_vols) -> float:
    """The Pancreas QDA control: mean binary Dice over the held-out
    volumes."""
    classes, params = fit_qda(train_vols)
    return float(np.mean([
        binary_dice(qda_predict(classes, params, ct) > 0, seg > 0)
        for ct, seg in test_vols
    ]))


def score_brats(preds, test_vols, shape) -> dict:
    """WT/TC/ET Dice and HD95 (clamped to the diagonal) of (X, Y, Z)
    predictions in BraTS labels, means over the volumes, raw and after
    ``postprocess_brats`` (rounded as the reference rounds them)."""
    dices, hd95s, post_dices, post_hd95s = [], [], [], []
    for pred, (_, seg) in zip(preds, test_vols):
        truth = np.where(seg == 3, 4, seg)
        dices.append(brats_region_dice(pred, truth))
        hd95s.append(brats_region_hd95(pred, truth))
        ppred = postprocess_brats(pred)
        post_dices.append(brats_region_dice(ppred, truth))
        post_hd95s.append(brats_region_hd95(ppred, truth))
    diag = float(np.linalg.norm(shape))
    out = {f"dice_{k.lower()}": float(np.mean([d[k] for d in dices]))
           for k in REGIONS}
    out.update({f"hd95_{k.lower()}": float(np.mean(
        [min(h[k], diag) for h in hd95s])) for k in REGIONS})
    post = {f"dice_{k.lower()}": round(float(np.mean(
        [d[k] for d in post_dices])), 4) for k in REGIONS}
    post.update({f"hd95_{k.lower()}": round(float(np.mean(
        [min(h[k], diag) for h in post_hd95s])), 2) for k in REGIONS})
    post["dice_mean"] = round(float(np.mean(
        [post["dice_wt"], post["dice_tc"], post["dice_et"]])), 4)
    out["postprocessed"] = post
    return out


def score_pancreas(preds, test_vols, shape) -> dict:
    """Binary Dice and HD95 (clamped to the diagonal) of (X, Y, Z)
    predictions, means over the volumes, raw and after
    ``postprocess_pancreas``."""
    diag = float(np.linalg.norm(shape))
    dices, hd95s, post_dices, post_hd95s = [], [], [], []
    for pred, (_, seg) in zip(preds, test_vols):
        dices.append(binary_dice(pred > 0, seg > 0))
        hd95s.append(min(hausdorff95(pred > 0, seg > 0), diag))
        ppred = postprocess_pancreas(pred)
        post_dices.append(binary_dice(ppred > 0, seg > 0))
        post_hd95s.append(min(hausdorff95(ppred > 0, seg > 0), diag))
    return {
        "dice": float(np.mean(dices)),
        "hd95": float(np.mean(hd95s)),
        "postprocessed": {
            "dice": round(float(np.mean(post_dices)), 4),
            "hd95": round(float(np.mean(post_hd95s)), 2),
        },
    }


def card_name(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card; None on the
    CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class _Stages:
    """Each stage's seconds (synced), peak device memory and launches."""

    def __init__(self, device, log):
        self.device, self.log = device, log
        self.seconds, self.peak_gb, self.launches = {}, {}, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.seconds[name] = time.perf_counter() - t0
        after = read_launches()
        self.launches[name] = {k: after[k] - before[k] for k in after}
        msg = f"[accuracy] {name} took {self.seconds[name]:.3f} s"
        if on_card:
            self.peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
            msg += f", peak {self.peak_gb[name]:.3f} GB"
        self.log(msg)


@dataclass
class Evaluation:
    """The fused path's (X, Y, Z) labels of the held-out volumes (BraTS
    labels for BraTS) and each one's latency in ms."""

    preds: List[np.ndarray]
    latency_ms: List[float]


@dataclass
class Run:
    """A trained accuracy run: its volumes, configs (``scfg`` the
    saliency net's in the fused path, ``strainer.cfg`` its training
    one), trainers and states, each step's losses, each stage's seconds,
    peak device memory (GB, on the card) and kernel launches, and the
    default evaluation."""

    dataset: str
    task: Task
    device: torch.device
    train_vols: list
    test_vols: list
    scfg: object
    pcfg: object
    strainer: SaliencyTrainer
    sstate: object
    ptrainer: PointSegTrainer
    pstate: object
    saliency_losses: np.ndarray
    pointseg_losses: np.ndarray
    stage: _Stages
    evaluation: Optional[Evaluation] = None

    @property
    def seconds(self) -> dict:
        return self.stage.seconds

    @property
    def peak_gb(self) -> dict:
        return self.stage.peak_gb

    @property
    def launches(self) -> dict:
        return self.stage.launches

    def pipe(self, sa_gate_stride: int = 1, **opts) -> FusedPointUnet:
        """The fused path over the trained nets. The trained saliency
        weights go into a net of ``scfg`` (its compute type) whose gate
        runs at ``sa_gate_stride``, unless the trained net is that net."""
        scfg, smodel = self.scfg, self.sstate.model
        if sa_gate_stride != 1:
            scfg = dataclasses.replace(scfg, sa_gate_stride=sa_gate_stride)
        if scfg != self.strainer.cfg:
            smodel = init_saliency_unet(scfg, torch.Generator())
            smodel.load_state_dict(self.sstate.model.state_dict())
        return FusedPointUnet(
            smodel, self.pstate.model, scfg, self.pcfg, threshold=0.5,
            volume_shape=self.task.shape, roi_shape=self.task.roi,
            device=self.device, **opts,
        )

    def evaluate(self, sa_gate_stride: int = 1, **opts) -> Evaluation:
        """One warm-up request (seed 99), then held-out volume i (seed
        100 + i), timed from its synced upload to a synced label."""
        pipe = self.pipe(sa_gate_stride, **opts)
        dev = self.device

        def request(mods, seed):
            return pipe.segment_device(
                mods, torch.Generator(device=dev).manual_seed(seed))

        _sync(dev)
        request(torch.as_tensor(self.test_vols[0][0], device=dev), 99)
        preds, lat = [], []
        for i, (mods, _) in enumerate(self.test_vols):
            mods_dev = torch.as_tensor(mods, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            labels = request(mods_dev, 100 + i)
            int(labels.max())                      # a 1-byte sync
            lat.append((time.perf_counter() - t0) * 1000)
            pred = np.transpose(labels.cpu().numpy(), (2, 1, 0)).copy()
            if self.dataset == "brats":
                pred[pred == 3] = 4
            preds.append(pred)
        return Evaluation(preds, lat)

    def score(self, ev: Evaluation) -> dict:
        score = score_brats if self.dataset == "brats" else score_pancreas
        return score(ev.preds, self.test_vols, self.task.shape)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def initial_state(trainer, seed: int, directory: Optional[str] = None):
    """The trainer's state drawn from ``seed``, or restored from an
    exported JAX train state in ``directory``."""
    state = trainer.init_state(seed)
    if directory is not None:
        if BestMetricCheckpointer(directory).restore_latest(state) is None:
            raise FileNotFoundError(f"accuracy: no train state in {directory}")
    return state


def train(dataset: str, args, task: Optional[Task] = None,
          log: Callable = _log) -> Run:
    """Steps 1-4 of the module docstring: the volumes and both nets
    trained. ``task`` defaults to the reference's for ``--acc_full``."""
    if dataset not in ("brats", "pancreas"):
        raise ValueError(f"dataset must be brats or pancreas, got {dataset!r}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("accuracy: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    brats = dataset == "brats"
    if task is None:
        task = (brats_task if brats else pancreas_task)(args.acc_full)
    stage = _Stages(dev, log)
    with stage("volumes"):
        train_vols, test_vols = make_volumes(dataset, task)

    on_card = dev.type == "cuda"
    saliency_config = brats_saliency_config if brats else pancreas_saliency_config
    scfg = saliency_config(patch_size=task.patch, batch_size=1, base_lr=0.01,
                           use_bfloat16=on_card)
    train_cfg = dataclasses.replace(
        scfg, use_bfloat16=bool(args.saliency_bf16) and on_card)
    strainer = SaliencyTrainer(train_cfg, TrainConfig(), device=dev)
    sstate = initial_state(strainer, args.seed, args.saliency_init)
    log("[accuracy] saliency net trained in "
        f"{'bf16' if train_cfg.use_bfloat16 else 'f32'}, run in "
        f"{'bf16' if scfg.use_bfloat16 else 'f32'} in the fused path")
    with stage("saliency_train"), tf32_convs(), deterministic_convs():
        sstate, s_losses = train_saliency(
            strainer, sstate, saliency_records(train_vols, dataset),
            args.saliency_steps, log)

    point_bf16 = bool(args.acc_bf16) and on_card
    if brats:
        pcfg = brats_pointseg_config(num_points=task.n_points,
                                     learning_rate=1e-3,
                                     use_bfloat16=point_bf16)
    else:
        pcfg = pancreas_pointseg_config(num_points=task.n_points,
                                        use_bfloat16=point_bf16)
    ptrainer = PointSegTrainer(pcfg, TrainConfig(), device=dev)
    pstate = initial_state(ptrainer, args.seed, args.pointseg_init)
    with stage("clouds"):
        clouds = sample_clouds(train_vols, task.n_points, dev)
    with stage("pointseg_train"):
        pstate, p_losses = train_pointseg(ptrainer, pstate, clouds,
                                          args.pointseg_steps, log)
    del clouds
    return Run(dataset, task, dev, train_vols, test_vols, scfg, pcfg,
               strainer, sstate, ptrainer, pstate, s_losses, p_losses, stage)


def _last(losses: np.ndarray) -> float:
    return float(losses[-1]) if len(losses) else float("nan")


def _median_ms(ev: Evaluation) -> float:
    return round(float(np.median(ev.latency_ms)), 1)


def _brats_dice(s: dict) -> dict:
    """The mean and the WT/TC/ET Dice of a BraTS score, rounded."""
    return {"dice_mean": round(float(np.mean(
                [s["dice_wt"], s["dice_tc"], s["dice_et"]])), 4),
            **{f"dice_{k}": round(s[f"dice_{k}"], 4)
               for k in ("wt", "tc", "et")}}


def _brats_hd95(s: dict) -> dict:
    return {f"hd95_{k}": round(s[f"hd95_{k}"], 2) for k in ("wt", "tc", "et")}


def _brats_ab(key: str, head: dict, s: dict, ev: Evaluation) -> dict:
    """A BraTS A/B pass's entry, keyed as the reference's."""
    if key == "stride_ab":
        return {**head, **_brats_dice(s), "latency_ms_median": _median_ms(ev)}
    return {"postprocessed": s["postprocessed"], **head, **_brats_dice(s),
            **_brats_hd95(s), "latency_ms_median": _median_ms(ev)}


def _pancreas_ab(key: str, head: dict, s: dict, ev: Evaluation) -> dict:
    """A Pancreas A/B pass's entry, keyed as the reference's."""
    return {**head, "dice": round(s["dice"], 4), "hd95": round(s["hd95"], 2),
            "postprocessed": s["postprocessed"],
            "latency_ms_median": _median_ms(ev)}


def _ab_passes(run: Run, args, summarize: Callable, order) -> dict:
    """The A/B passes asked for, in ``order``, each evaluated in a stage
    of its own: ``--sa_stride`` s > 1 the stride-s gate (``stride_ab``),
    ``--att_downscale`` s > 1 the attention at 1/s with the mask dilated
    by s (``downscale_ab``) and with a boundary band of 4
    (``downscale_band_ab``). {key: ``summarize(key, the pass's options,
    its score, its evaluation)``}."""
    heads = {}
    if (args.sa_stride or 1) > 1:
        heads["stride_ab"] = {"sa_gate_stride": int(args.sa_stride)}
    if (args.att_downscale or 1) > 1:
        scale = int(args.att_downscale)
        heads["downscale_ab"] = {"att_downscale": scale, "mask_dilate": scale}
        heads["downscale_band_ab"] = {"att_downscale": scale, "mask_band": 4,
                                      "band_threshold": 0.125}
    out = {}
    for key in (k for k in order if k in heads):
        head = heads[key]
        opts = {k: v for k, v in head.items() if k != "band_threshold"}
        with run.stage(key):
            ev = run.evaluate(**opts)
        out[key] = summarize(key, head, run.score(ev), ev)
    return out


def accuracy_brats(args, task: Optional[Task] = None,
                   log: Callable = _log) -> Tuple[dict, Run]:
    """The reference's ``bench_accuracy`` line of a BraTS run, and the
    run."""
    run = train("brats", args, task, log)
    stage = run.stage
    log("[accuracy] training done; evaluating fused pipeline")
    with stage("evaluate"):
        ev = run.evaluation = run.evaluate()
    s = run.score(ev)
    with stage("qda"):
        gmm = pervoxel_gmm_baseline(run.train_vols, run.test_vols)
    gmm_mean = float(np.mean(list(gmm.values())))
    dice = _brats_dice(s)
    mean_dice = float(np.mean([s["dice_wt"], s["dice_tc"], s["dice_et"]]))
    out = {
        "metric": "brats_synth_fused_dice_mean",
        "value": dice.pop("dice_mean"),
        "unit": "dice",
        "vs_baseline": round(mean_dice / BRATS_BASELINE_DICE, 3),
        **dice,
        **_brats_hd95(s),
        "postprocessed": s["postprocessed"],
        "gmm_baseline_dice_mean": round(gmm_mean, 4),
        "gmm_baseline_dice_wt": round(gmm["WT"], 4),
        "gmm_baseline_dice_tc": round(gmm["TC"], 4),
        "gmm_baseline_dice_et": round(gmm["ET"], 4),
        "latency_ms_median": _median_ms(ev),
        "saliency_final_loss": round(_last(run.saliency_losses), 4),
        "pointseg_final_loss": round(_last(run.pointseg_losses), 4),
        "volume_shape": list(run.task.shape),
        "n_points": run.task.n_points,
        "pointseg_bf16": bool(args.acc_bf16),
        "note": "synthetic multi-focal cross-modality task, held-out "
        "volumes; classes separable only via cross-modality signatures + "
        "spatial context; vs_baseline divides by reference BraTS20 "
        "offline mean dice",
    }
    out.update(_ab_passes(run, args, _brats_ab,
                          ("stride_ab", "downscale_ab", "downscale_band_ab")))
    out["card"] = card_name(run.device)
    out["launches"] = run.launches
    return out, run


def accuracy_pancreas(args, task: Optional[Task] = None,
                      log: Callable = _log) -> Tuple[dict, Run]:
    """The reference's ``bench_accuracy_pancreas`` line of a Pancreas run,
    and the run."""
    run = train("pancreas", args, task, log)
    stage = run.stage
    with stage("evaluate"):
        ev = run.evaluation = run.evaluate()
    s = run.score(ev)
    with stage("qda"):
        gmm = pancreas_gmm_baseline(run.train_vols, run.test_vols)
    out = {
        "metric": "pancreas_synth_fused_dice",
        "value": round(s["dice"], 4),
        "unit": "dice",
        "vs_baseline": round(s["dice"] / PANCREAS_BASELINE_DICE, 3),
        "hd95": round(s["hd95"], 2),
        "postprocessed": s["postprocessed"],
        "gmm_baseline_dice": round(gmm, 4),
        "latency_ms_median": _median_ms(ev),
        "saliency_final_loss": round(_last(run.saliency_losses), 4),
        "pointseg_final_loss": round(_last(run.pointseg_losses), 4),
        "volume_shape": list(run.task.shape),
        "n_points": run.task.n_points,
        "note": "synthetic low-contrast pancreas sweep task, held-out "
        "volumes; vs_baseline divides by reference Pancreas mean dice",
    }
    out.update(_ab_passes(run, args, _pancreas_ab,
                          ("downscale_ab", "downscale_band_ab", "stride_ab")))
    out["card"] = card_name(run.device)
    out["launches"] = run.launches
    return out, run


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=("brats", "pancreas"),
                   default="brats")
    p.add_argument("--saliency_steps", type=int, default=400)
    p.add_argument("--pointseg_steps", type=int, default=800)
    p.add_argument("--acc_full", action="store_true",
                   help="the reference's contract sizes")
    p.add_argument("--acc_bf16", action="store_true",
                   help="train and run the point net in bf16 (on the card)")
    p.add_argument("--saliency_bf16", action="store_true",
                   help="train the saliency net in bf16 (on the card), as "
                   "the reference does on a TPU; default f32")
    p.add_argument("--sa_stride", type=int, default=None,
                   help="also evaluate with the gate at this stride")
    p.add_argument("--att_downscale", type=int, default=None,
                   help="also evaluate with attention at 1/s resolution")
    p.add_argument("--seed", type=int, default=0,
                   help="the seed of both nets' initialisation")
    p.add_argument("--saliency_init", default=None,
                   help="start the saliency net from an exported JAX "
                   "train state in this directory")
    p.add_argument("--pointseg_init", default=None,
                   help="start the point net from an exported JAX train "
                   "state in this directory")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    run = accuracy_brats if args.dataset == "brats" else accuracy_pancreas
    out, _ = run(args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
