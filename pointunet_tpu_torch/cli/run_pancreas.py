"""Pancreas point-segmentation entry point: train / test with 4-fold
cross-validation (``pointunet_tpu/cli/run_pancreas.py``).

    python -m pointunet_tpu_torch.cli.run_pancreas --mode train|test \
        --data_PC_path <tree> [--fold 3] [--data_3D_path ct/] \
        [--device cuda|cpu] [...]

The reference's flags, plus ``--device`` (default ``cuda``; the CPU only
when asked). ``--gpu`` is accepted and ignored. The tree is
``data_prepare_pancreas``'s; loops whose ID is ``--fold`` modulo 4
validate. Checkpoints live in ``--checkpoint_path`` (default
``<logdir>/fold<k>``). Train mode resumes from the newest one and runs
``fit``, keeping the best-mIoU checkpoint. Test mode restores the best
one and writes, per validation loop, the probabilities scattered into the
CT's grid: a (Z, Y, X, 2) volume ``<results_path>/<ID>_loop_<k>.npy``,
the shape read from ``<data_3D_path>/PANCREAS_<ID>.nii.gz``'s header;
it logs each loop's binary point Dice. The checkpoint directory may be
one that ``export_jax_checkpoint.py`` wrote from the JAX package's
(``core/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.checkpoint import BestMetricCheckpointer
from ..core.config import TrainConfig, pancreas_pointseg_config
from ..core.metrics_sink import MetricsLogger
from ..data import nifti
from ..data.datasets import PancreasPointDataset
from ..ops.scatter import scatter_probs_to_volume
from ..train.metrics import binary_dice
from ..train.pointseg import PointSegTrainer
from .run_brats import make_logger


def run_test(trainer, state, dataset, data_3d_path, results_path, log):
    """Inference over the validation loops -> scattered probability
    volumes, one ``.npy`` each, indexed [z, y, x, class]."""
    os.makedirs(results_path, exist_ok=True)
    dices = []
    for name, xyz, feats, labels, origin in dataset.test_iter():
        case_id = name.split("_loop_")[0]
        vol_path = os.path.join(data_3d_path, f"PANCREAS_{case_id}.nii.gz")
        shape = nifti.load(vol_path).shape          # (X, Y, Z)
        probs = trainer.eval_step(state, xyz, feats, labels)[0]
        dice = binary_dice(probs.argmax(-1).cpu().numpy(),
                           np.asarray(labels)[0])
        dices.append(dice)
        log(f"{name}: point dice {dice:.4f}")
        # the origins are uint16 on disk, which torch takes only in part
        origin = torch.as_tensor(origin.astype(np.int64), device=probs.device)
        vol = scatter_probs_to_volume(probs, origin,
                                      (shape[2], shape[1], shape[0]))
        np.save(os.path.join(results_path, f"{name}.npy"), vol.cpu().numpy())
    if dices:
        log(f"mean point dice: {float(np.mean(dices)):.4f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gpu", type=int, default=0, help="ignored")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "test"])
    parser.add_argument("--fold", type=int, default=3)
    parser.add_argument("--n_epoch", type=int, default=100)
    parser.add_argument("--logdir", type=str,
                        default="./model_logs/Pancreas")
    parser.add_argument("--data_PC_path", type=str, required=True)
    parser.add_argument("--data_3D_path", type=str, default=None)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--results_path", type=str, default="./results")
    parser.add_argument("--n_point", type=int, default=180000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = pancreas_pointseg_config(
        max_epoch=args.n_epoch, num_points=args.n_point
    )
    dataset = PancreasPointDataset(args.data_PC_path, args.fold, cfg)
    log = make_logger(args.logdir)
    trainer = PointSegTrainer(cfg, TrainConfig(), device=args.device)
    state = trainer.init_state()

    ckpt_dir = args.checkpoint_path or os.path.join(
        args.logdir, f"fold{args.fold}"
    )
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
        if args.data_3D_path is None:
            raise SystemExit("--data_3D_path required for test mode")
        run_test(trainer, state, dataset, args.data_3D_path,
                 args.results_path, log)
    return state


if __name__ == "__main__":
    main()
