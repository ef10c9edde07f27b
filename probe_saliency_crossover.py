"""Train the reference's saliency net with JAX on this host's CPU, as the
reference bench's accuracy presets train it off a TPU, for the crossover
that separates the port's training from its inference.

    JAX_PLATFORMS=cpu python probe_saliency_crossover.py \
        --dataset brats|pancreas [--acc_full] [--steps 400] --out DIR
    python export_jax_checkpoint.py --src DIR --out NPZ_DIR --stage saliency \
        [--dataset pancreas]

Stage 1 of ``bench.py:bench_accuracy`` (``bench_accuracy_pancreas`` for
Pancreas): the seeded synthetic volumes from ``default_rng(0)``, the
config (``patch_size`` of the task, batch 1, lr 0.01, f32: the
reference's rule on any backend but a TPU), the net from
``init_state()`` (the draw ``export_jax_checkpoint.py --init 0``
writes), ``--steps`` updates on ``patch_batches`` from
``default_rng(1)``. The trained state is saved with the JAX package's
own checkpointer under ``DIR`` (step ``--steps``); the export makes it
an ``.npz`` that ``cli/accuracy.py --saliency_init NPZ_DIR
--saliency_steps 0`` runs through the port's fused path on the card,
beside ``--saliency_init`` of the draw trained by the port. It prints
the loss every 50 steps and the seconds; a CPU probe that imports JAX
(the port never imports it).
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from pointunet_tpu.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu.core.config import (
    TrainConfig,
    brats_saliency_config,
    pancreas_saliency_config,
)
from pointunet_tpu.data.sampler import VolumeRecord, patch_batches
from pointunet_tpu.train.saliency import SaliencyTrainer


def task(dataset: str, full: bool):
    """(volume shape, patch) of bench.py's accuracy presets."""
    if dataset == "brats":
        return ((240, 240, 155), (64, 160, 160), 16) if full else (
            (96, 96, 64), (32, 96, 96), 10)
    return ((256, 256, 160), (64, 160, 160), None) if full else (
        (96, 96, 64), (32, 96, 96), None)


def records(dataset: str, shape, r_div):
    """The 4 training volumes' records, as the presets make them."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        if dataset == "brats":
            mods, seg = bench._synth_brats_volume(rng, shape, r_div)
            lab = (np.transpose(seg, (2, 1, 0)) > 0).astype(np.int32)
        else:
            mods, seg = bench._synth_pancreas_volume(rng, shape)
            lab = np.transpose(seg, (2, 1, 0)).astype(np.int32)
        vol = np.transpose(mods, (0, 3, 2, 1))
        out.append(VolumeRecord(vol, np.ones_like(lab, np.float32), lab))
    return out


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=("brats", "pancreas"),
                   default="brats")
    p.add_argument("--acc_full", action="store_true")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    shape, patch, r_div = task(args.dataset, args.acc_full)
    make = (brats_saliency_config if args.dataset == "brats"
            else pancreas_saliency_config)
    cfg = make(patch_size=patch, batch_size=1, base_lr=0.01,
               use_bfloat16=False)
    trainer = SaliencyTrainer(cfg, TrainConfig(donate_state=False))
    state = trainer.init_state()
    batches = patch_batches(records(args.dataset, shape, r_div), cfg.patch_size,
                            cfg.batch_size, np.random.default_rng(1),
                            "one_positive")
    t0 = time.perf_counter()
    loss = float("nan")
    for k, (im, w, lab) in zip(range(args.steps), batches):
        state, m = trainer.train_step(state, jnp.asarray(im), jnp.asarray(w),
                                      jnp.asarray(lab))
        loss = float(m["loss"])
        if k % 50 == 0 or k == args.steps - 1:
            print(f"step {k} loss {loss:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    ckpt = BestMetricCheckpointer(args.out)
    ckpt.save(state, args.steps)
    ckpt.close()
    print(f"saved step {args.steps} to {args.out} ({jax.default_backend()}, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return loss


if __name__ == "__main__":
    main()
