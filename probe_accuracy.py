"""Where the accuracy path's Dice goes, at the reference's BraTS contract on
one CUDA card: the point net from several initial draws, scored with the
true tumour mask as the attention, then the saliency net from several
draws through the fused path.

    python3 probe_accuracy.py [--seeds 0 2 3] [--reference DIR ...] \
        [--saliency_reference DIR] [--saliency_dtypes bf16 f32] \
        [--dataset brats|pancreas]

The volumes, clouds, steps and configs are ``cli/accuracy.py --acc_full``'s
(400 saliency and 800 point steps). A start is a seed of the port's
initialisation (``--seeds``) or a draw of the JAX package's, exported on a
host with JAX by ``python export_jax_checkpoint.py --init K --stage
pointseg --out DIR`` (``--stage saliency`` for ``--saliency_reference``;
both load through ``load_reference``). For each point-net start: train,
then segment each held-out volume with its true tumour mask in place of
the attention mask (the oracle: the point net's own Dice, whatever the
saliency net does). Then, for the saliency net from the port's seed 0
(``--seeds`` empty: only the exported draw) and from
``--saliency_reference``, in each of ``--saliency_dtypes`` (bf16, the
reference's recipe on its TPU, and f32, with cuDNN's TF32 off; each for
training and the fused path):
train, and score the
fused path with the point net of the first ``--reference`` start (of the
first seed without one), with each attention mask's voxels, tumour
recall and Dice against the tumour, and its intersection over union with
the first dtype's mask of the same start. It prints
the card's name and power limit, a JSON line a start, and, last, a JSON
object of them all.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.train.metrics import binary_dice
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from pointunet_tpu_torch.train.saliency import SaliencyTrainer


def _load_reference(state, directory: str) -> None:
    state.load_reference(dict(np.load(os.path.join(directory, "0.npz"))))


@contextlib.contextmanager
def _full_f32(on: bool):
    """With ``on``, f32 convs and matmuls in full f32 (cuDNN's default
    runs f32 convs in TF32) within; as they were after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _progress(msg: str) -> None:
    print(f"{time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def _mean_dice(run, s) -> float:
    if run.dataset == "brats":
        return float(np.mean([s["dice_wt"], s["dice_tc"], s["dice_et"]]))
    return s["dice"]


def _oracle(run) -> dict:
    """Each held-out volume segmented with its true tumour mask as the
    attention (seed 100 + i), scored as the accuracy path scores."""
    pipe, dev = run.pipe(), run.device
    preds = []
    for i, (mods, seg) in enumerate(run.test_vols):
        lab = pipe.segment_device(
            torch.as_tensor(mods, device=dev),
            torch.Generator(device=dev).manual_seed(100 + i),
            mask=torch.as_tensor(seg > 0, device=dev))
        pred = np.transpose(lab.cpu().numpy(), (2, 1, 0)).copy()
        if run.dataset == "brats":
            pred[pred == 3] = 4
        preds.append(pred)
    return run.score(accuracy.Evaluation(preds, []))


def _masks(run) -> tuple:
    """Each held-out volume's attention mask (X, Y, Z) and its voxels,
    tumour recall and Dice against the tumour."""
    pipe, masks, rows = run.pipe(), [], []
    for i, (mods, seg) in enumerate(run.test_vols):
        _, mask, _ = pipe.segment_device(
            torch.as_tensor(mods, device=run.device),
            torch.Generator(device=run.device).manual_seed(100 + i),
            return_stages=True)
        mask = mask.cpu().numpy().astype(bool)
        tumour = seg > 0
        masks.append(mask)
        rows.append({"voxels": int(mask.sum()), "tumour": int(tumour.sum()),
                     "recall": float((mask & tumour).sum() / tumour.sum()),
                     "dice": binary_dice(mask, tumour)})
    return masks, rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=("brats", "pancreas"),
                   default="brats")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 2, 3])
    p.add_argument("--reference", nargs="*", default=[],
                   help="exported JAX init_state directories (point net)")
    p.add_argument("--saliency_reference", default=None,
                   help="an exported JAX init_state directory (saliency)")
    p.add_argument("--saliency_dtypes", nargs="+", default=["bf16"],
                   choices=("bf16", "f32"),
                   help="the saliency net's training and inference types")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_accuracy: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cli = accuracy.parse_args(["--dataset", args.dataset, "--acc_full",
                               "--saliency_steps", "0",
                               "--pointseg_steps", "0"])
    run = accuracy.train(args.dataset, cli, log=lambda *a: None)
    clouds = accuracy.sample_clouds(run.train_vols, run.task.n_points,
                                    run.device)
    starts = ([("port seed %d" % s, s, None) for s in args.seeds]
              + [("reference %s" % d, 0, d) for d in args.reference])
    results, fused_point = [], None
    for name, seed, directory in starts:
        t0 = time.perf_counter()
        trainer = PointSegTrainer(run.pcfg, device=run.device)
        state = trainer.init_state(seed)
        if directory is not None:
            _load_reference(state, directory)
        state, losses = accuracy.train_pointseg(
            trainer, state, clouds, 800, log=lambda *a: None)
        run.ptrainer, run.pstate = trainer, state
        s = _oracle(run)
        row = {"point_start": name, "oracle_dice": _mean_dice(run, s),
               "oracle": {k: v for k, v in s.items() if k != "postprocessed"},
               "loss_first": float(losses[0]),
               "loss_last50": float(losses[-50:].mean()),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        results.append(row)
        if fused_point is None or (directory is not None
                                   and fused_point[2] is None):
            fused_point = (trainer, state, directory, name)
    run.ptrainer, run.pstate = fused_point[:2]
    saliency_starts = [("port seed 0", None)] if args.seeds else []
    if args.saliency_reference:
        saliency_starts.append(("reference " + args.saliency_reference,
                                args.saliency_reference))
    records = accuracy.saliency_records(run.train_vols, args.dataset)
    for name, directory in saliency_starts:
        first_masks = None
        for dtype in args.saliency_dtypes:
            t0 = time.perf_counter()
            run.scfg = dataclasses.replace(
                run.scfg, use_bfloat16=dtype == "bf16")
            run.strainer = SaliencyTrainer(run.scfg, device=run.device)
            state = run.strainer.init_state()
            if directory is not None:
                _load_reference(state, directory)
            with _full_f32(dtype == "f32"):
                state, losses = accuracy.train_saliency(
                    run.strainer, state, records, 400, log=_progress)
                run.sstate = state
                ev = run.evaluate()
                s = run.score(ev)
                masks, mask_rows = _masks(run)
                oracle = _mean_dice(run, _oracle(run))
            if first_masks is None:
                first_masks = masks
            row = {"saliency_start": name, "saliency_dtype": dtype,
                   "point_start": fused_point[3],
                   "fused_dice": _mean_dice(run, s),
                   "fused": {k: v for k, v in s.items()
                             if k != "postprocessed"},
                   "postprocessed": s["postprocessed"],
                   "oracle_dice": oracle,
                   "masks": mask_rows,
                   "mask_iou_with_" + args.saliency_dtypes[0]: [
                       float((a & b).sum() / max(1, (a | b).sum()))
                       for a, b in zip(masks, first_masks)],
                   "loss_last50": float(losses[-50:].mean()),
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            results.append(row)
    out = {"card": card, "dataset": args.dataset,
           "task": dataclasses.asdict(run.task), "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
