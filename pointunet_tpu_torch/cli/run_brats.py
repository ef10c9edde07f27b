"""BraTS point-segmentation entry point: train / test
(``pointunet_tpu/cli/run_brats.py``).

    python -m pointunet_tpu_torch.cli.run_brats --mode train|test \
        --data_PC_path <tree> [--device cuda|cpu] [...]

The reference's flags, plus ``--device`` (default ``cuda``; the CPU only
when asked). ``--gpu`` is accepted and ignored. Train mode resumes from
the newest checkpoint under ``--checkpoint_path`` (default
``<logdir>/snapshots``) and runs ``fit``, keeping the best-mIoU
checkpoint. Test mode restores the best checkpoint and writes, per
validation cloud, a (Z, Y, X, num_classes) probability volume
``<results_path>/<ID>.npy`` ((155, 240, 240, 4) for BraTS). The
checkpoint directory may be one that ``export_jax_checkpoint.py`` wrote
from the JAX package's: training then resumes from its latest step, Adam
moments and step carried over (``core/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.checkpoint import BestMetricCheckpointer
from ..core.config import TrainConfig, brats_pointseg_config
from ..core.metrics_sink import MetricsLogger
from ..data.datasets import BraTSPointDataset
from ..ops.scatter import scatter_probs_to_volume
from ..train.metrics import per_class_dice
from ..train.pointseg import PointSegTrainer


def _read_ids(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def make_logger(logdir):
    os.makedirs(logdir, exist_ok=True)
    log_path = os.path.join(logdir, "train_summary.txt")

    def log(msg):
        with open(log_path, "a") as f:
            f.write(str(msg) + "\n")
        print(msg, flush=True)

    return log


def run_test(trainer, state, dataset, results_path, log,
             volume_shape=(240, 240, 155)):
    """Inference over the validation clouds -> scattered probability
    volumes, one ``.npy`` each, indexed [z, y, x, class]."""
    x, y, z = volume_shape
    os.makedirs(results_path, exist_ok=True)
    for name, xyz, feats, labels, origin in dataset.test_iter():
        probs = trainer.eval_step(state, xyz, feats, labels)[0]
        pred = probs.argmax(-1).cpu().numpy()
        dice = per_class_dice(pred, np.asarray(labels)[0],
                              trainer.cfg.num_classes)
        log(f"{name}: dice " + " ".join(f"{d:.4f}" for d in dice))
        vol = scatter_probs_to_volume(
            probs, torch.as_tensor(origin, device=probs.device), (z, y, x)
        )
        np.save(os.path.join(results_path, f"{name}.npy"), vol.cpu().numpy())
        log(f"saved {name}.npy")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gpu", type=int, default=0, help="ignored")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "test"])
    parser.add_argument("--n_epoch", type=int, default=100)
    parser.add_argument("--logdir", type=str,
                        default="./model_logs/BraTS20")
    parser.add_argument("--data_PC_path", type=str, required=True)
    parser.add_argument("--train_ids", type=str, default=None,
                        help="txt of training IDs (default: <data>/train_BraTS20.txt)")
    parser.add_argument("--val_ids", type=str, default=None)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--results_path", type=str,
                        default="./predict_npy")
    parser.add_argument("--n_point", type=int, default=365000)
    parser.add_argument("--volume_shape", type=int, nargs=3,
                        default=[240, 240, 155], metavar=("X", "Y", "Z"),
                        help="voxel grid for scatter-back in test mode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    root = args.data_PC_path
    train_txt = args.train_ids or os.path.join(root, "train_BraTS20.txt")
    val_txt = args.val_ids or os.path.join(root, "valOffline_BraTS20.txt")
    train_ids = _read_ids(train_txt) if os.path.exists(train_txt) else []
    val_ids = _read_ids(val_txt) if os.path.exists(val_txt) else None

    cfg = brats_pointseg_config(
        max_epoch=args.n_epoch, num_points=args.n_point
    )
    dataset = BraTSPointDataset(root, train_ids, val_ids, cfg)
    log = make_logger(args.logdir)
    trainer = PointSegTrainer(cfg, TrainConfig(), device=args.device)
    state = trainer.init_state()

    ckpt_dir = args.checkpoint_path or os.path.join(args.logdir, "snapshots")
    checkpointer = BestMetricCheckpointer(ckpt_dir)

    if args.mode == "train":
        if checkpointer.restore_latest(state) is not None:
            log(f"resumed from step {state.step}")
        with MetricsLogger(args.logdir) as sink:
            trainer.fit(
                state, dataset.train_iter, dataset.val_iter, checkpointer,
                log, metrics=sink,
            )
    else:
        if checkpointer.restore_best(state) is None:
            raise SystemExit(f"no checkpoint found under {ckpt_dir}")
        run_test(
            trainer, state, dataset, args.results_path, log,
            tuple(args.volume_shape),
        )
    return state


if __name__ == "__main__":
    main()
