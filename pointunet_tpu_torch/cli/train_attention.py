"""Saliency-attention network driver: train / evaluate / predict
(``pointunet_tpu/cli/train_attention.py``).

    python -m pointunet_tpu_torch.cli.train_attention --basedir cases/ \
        [--dataset brats|pancreas] [--label_dir DIR] [--logdir DIR] \
        [--checkpoint_path DIR] [--evaluate | --predict --outPros_path DIR] \
        [--max_epoch N] [--val_fraction F] [--direction VIEW] \
        [--device cuda|cpu]

The reference's flags, plus ``--device`` (default ``cuda``; the CPU only
when asked); ``--gpu`` is accepted and ignored. Training transposes the
records into ``--direction``'s view, holds out the first
``--val_fraction`` of them for the per-epoch dice, resumes from the
newest checkpoint under ``--checkpoint_path`` (default
``<logdir>/snapshots``) and logs scalars to ``<logdir>/scalars.jsonl``.
``--evaluate`` restores the best checkpoint and reports the dice in the
training view. ``--predict`` writes one ``<case_id>.npy`` per case into
``--outPros_path``: (X, Y, Z, 2) f32 probabilities, axial-aligned
whatever the view, and for a cropped BraTS case placed back at its
bounding box in the original shape (zeros outside), ready for
``gen_binary_map``. Checkpoints are the port's torch format, or a
directory that ``export_jax_checkpoint.py`` wrote from the JAX package's
orbax checkpoints (``core/checkpoint.py``): evaluated, predicted from or
resumed (momentum and step carried over) alike.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from ..core.checkpoint import BestMetricCheckpointer
from ..core.config import (
    TrainConfig,
    brats_saliency_config,
    pancreas_saliency_config,
)
from ..core.metrics_sink import MetricsLogger
from ..data.loader import (
    find_brats_cases,
    find_pancreas_cases,
    load_brats_case,
    load_pancreas_case,
)
from ..data.sampler import patch_batches, transpose_record
from ..train.saliency import SaliencyTrainer
from .run_brats import make_logger


def _load_records(args, with_label=True):
    if args.dataset == "brats":
        records, metas = [], []
        for case in find_brats_cases(args.basedir):
            rec, meta = load_brats_case(case, with_label=with_label)
            records.append(rec)
            metas.append(meta)
        return records, metas
    cases = find_pancreas_cases(args.basedir, args.label_dir)
    records = [load_pancreas_case(ct, lab) for _, ct, lab in cases]
    metas = [{"case_id": cid} for cid, _, _ in cases]
    return records, metas


def _to_original(probs: np.ndarray, meta: dict) -> np.ndarray:
    """(num_class, D, H, W) probabilities -> (X, Y, Z, num_class), placed
    at the crop's bounding box in the original shape when cropped."""
    probs_xyz = np.transpose(probs, (3, 2, 1, 0))
    if "bbox" not in meta or "original_shape" not in meta:
        return probs_xyz
    full = np.zeros(
        tuple(reversed(meta["original_shape"])) + (probs.shape[0],),
        np.float32,
    )
    (zlo, zhi), (ylo, yhi), (xlo, xhi) = meta["bbox"]
    full[xlo:xhi, ylo:yhi, zlo:zhi] = probs_xyz
    return full


def main(argv=None):
    """Run one mode; returns the trainer's state."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", choices=["brats", "pancreas"],
                        default="brats")
    parser.add_argument("--basedir", type=str, required=True)
    parser.add_argument("--label_dir", type=str, default=None,
                        help="pancreas label dir")
    parser.add_argument("--logdir", type=str, default="./train_log/unet3d")
    parser.add_argument("--gpu", type=str, default="0", help="ignored")
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--outPros_path", type=str, default="./attention_maps")
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--val_fraction", type=float, default=0.2)
    parser.add_argument(
        "--direction", choices=["axial", "sagittal", "coronal"],
        default=None,
        help="train a view-transposed model for the multi-view ensemble",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = (
        brats_saliency_config() if args.dataset == "brats"
        else pancreas_saliency_config()
    )
    if args.max_epoch:
        cfg = dataclasses.replace(cfg, max_epoch=args.max_epoch)
    if args.direction:
        cfg = dataclasses.replace(cfg, direction=args.direction)

    log = make_logger(args.logdir)
    trainer = SaliencyTrainer(cfg, TrainConfig(), device=args.device)
    state = trainer.init_state()
    ckpt_dir = args.checkpoint_path or os.path.join(args.logdir, "snapshots")
    checkpointer = BestMetricCheckpointer(ckpt_dir, max_to_keep=10)

    if args.predict or args.evaluate:
        if checkpointer.restore_best(state) is None:
            raise SystemExit(f"no checkpoint under {ckpt_dir}")
        records, metas = _load_records(args, with_label=args.evaluate)
        if args.evaluate:
            # a sagittal or coronal model sees its records in its
            # training view
            records = [transpose_record(r, cfg.direction) for r in records]
            trainer.evaluate(state, records, log)
            return state
        os.makedirs(args.outPros_path, exist_ok=True)
        for rec, meta in zip(records, metas):
            # predict_volume_tta predicts in the model's view and
            # transposes back, so every map is axial-aligned
            probs = trainer.predict_volume_tta(
                state, rec.image, direction=cfg.direction
            )
            np.save(os.path.join(args.outPros_path, f"{meta['case_id']}.npy"),
                    _to_original(probs, meta))
            log(f"predicted {meta['case_id']}")
        return state

    records, _ = _load_records(args, with_label=True)
    records = [transpose_record(r, cfg.direction) for r in records]
    n_val = max(1, int(len(records) * args.val_fraction))
    val_records, train_records = records[:n_val], records[n_val:]
    if not train_records:
        train_records = val_records
    batches = patch_batches(
        train_records, cfg.patch_size, cfg.batch_size,
        np.random.default_rng(0), cfg.data_sampling,
    )
    if checkpointer.restore_latest(state) is not None:
        log(f"resumed from step {state.step}")
    with MetricsLogger(args.logdir) as sink:
        trainer.fit(state, batches, val_records, checkpointer, log,
                    metrics=sink)
    return state


if __name__ == "__main__":
    main()
