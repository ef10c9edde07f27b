"""Repeat runs of the accuracy path (``cli/accuracy.py``) on one CUDA card,
each with the split of its Dice: the run's JSON line, then its attention
masks (voxels, tumour recall, Dice against the tumour) and the oracle
(the held-out volumes segmented with the true tumour mask as the
attention: the point net's own Dice).

    python3 probe_accuracy_runs.py [RUN ...]

A RUN is ``dataset[:flag,flag...]``, the flags those of ``cli/accuracy.py``
without their dashes, a value after ``=``, e.g. ``brats:saliency_bf16
brats brats pancreas`` (the default: the saliency net trained bf16, then
twice f32, on the reduced BraTS task, then the reduced Pancreas task) or
``brats:acc_full,seed=1`` or ``pancreas:acc_full,saliency_init=DIR,
pointseg_init=DIR`` (the JAX package's initial draws, exported by
``export_jax_checkpoint.py --init 0``). The runs of one process share
each task's volumes, made once. Where the fused
path runs the saliency net in another type than it was trained in, the
run is also scored in the training type (``fused_eval_as_trained``).
Prints the card's name and power limit, then a ``DIAG`` JSON line a run.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from pointunet_tpu_torch.cli import accuracy
import probe_accuracy

DEFAULT_RUNS = ("brats:saliency_bf16", "brats", "brats", "pancreas")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def one_run(spec: str) -> dict:
    dataset, _, flags = spec.partition(":")
    extra = []
    for flag in filter(None, flags.split(",")):
        name, eq, value = flag.partition("=")
        extra += [f"--{name}"] + ([value] if eq else [])
    t0 = time.perf_counter()
    args = accuracy.parse_args(["--dataset", dataset] + extra)
    fn = (accuracy.accuracy_brats if dataset == "brats"
          else accuracy.accuracy_pancreas)
    line, run = fn(args, log=_log)
    row = {"dataset": dataset, "extra": extra, "value": line["value"],
           "post": line["postprocessed"],
           "qda": line.get("gmm_baseline_dice_mean",
                           line.get("gmm_baseline_dice")),
           "saliency_final_loss": line["saliency_final_loss"],
           "sal_loss_last50": float(run.saliency_losses[-50:].mean()),
           "pt_loss_last50": float(run.pointseg_losses[-50:].mean()),
           "stage_s": run.seconds, "peak": run.peak_gb}
    _, row["masks_eval"] = probe_accuracy._masks(run)
    row["oracle"] = probe_accuracy._mean_dice(run,
                                              probe_accuracy._oracle(run))
    if run.scfg != run.strainer.cfg:
        run.scfg = run.strainer.cfg
        row["fused_eval_as_trained"] = probe_accuracy._mean_dice(
            run, run.score(run.evaluate()))
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None) -> None:
    runs = (sys.argv[1:] if argv is None else argv) or DEFAULT_RUNS
    if not torch.cuda.is_available():
        raise SystemExit("probe_accuracy_runs: no CUDA device")
    accuracy.make_volumes = functools.lru_cache(maxsize=2)(
        accuracy.make_volumes)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    for spec in runs:
        print("DIAG " + json.dumps(one_run(spec)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
