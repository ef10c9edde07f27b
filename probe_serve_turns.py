"""The Serve stage split, or the bf16 saliency train step, of two trees in
turns on one CUDA card.

    python3 probe_serve_turns.py TREE_A TREE_B [--order ABBA]
        [--phase serve|saliency_bf16]

Each letter of ``--order`` runs, in a process of its own from that tree's
root, a part of that tree's ``chip_smoke.py`` and prints the tree, what
it measured and the card. ``serve`` (the default): phases 1 and 5 (build
the kernels, serve 3 synthetic BraTS cases, then time one request's
stages with CUDA events, mean of 3, on cuDNN and with
``POINTUNET_FASTCONV=pallas``). ``saliency_bf16``: phase 9's
``bf16_remat`` variant (``brats_saliency_config`` in bf16, batch 2 of
(64, 160, 160), remat, TF32 off): 10 ``train_step``s of a fresh trainer
on one batch, made once here from phase 9's cases and seed and loaded
by every run; the losses, the mean split of steps 1-9 (CUDA events),
their peak memory and one profiled step's busy share. Two trees, e.g. a
``git archive`` of the parent unpacked into a directory the repo
ignores and ``.``, compared in turns (A, B, B, A) so that a drift of the
card falls on both. The last line is one JSON object of every run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

RUN = {"serve": r"""
import json, torch, chip_smoke
chip_smoke._full_f32()
card, _ = chip_smoke.phase_build()
serve, _, _ = chip_smoke.phase_serve(torch.device("cuda", 0))
print("SERVE " + json.dumps({"card": card, "stages_ms": serve["stages_ms"],
                             "stages_pallas_ms": serve["stages_pallas_ms"]}))
""", "saliency_bf16": r"""
import dataclasses, json, subprocess, sys, numpy as np, torch, chip_smoke
from pointunet_tpu_torch.core.config import brats_saliency_config
chip_smoke._full_f32()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip()
with np.load(sys.argv[1]) as f:
    batch = tuple(f[k] for k in ("images", "weights", "labels"))
cfg = dataclasses.replace(brats_saliency_config(), use_bfloat16=True)
res = chip_smoke._saliency_steps(cfg, batch)
print("SERVE " + json.dumps({
    "card": card, "losses": res["losses"], "split_ms": res["split_ms"],
    "peak_gb": res["peak_gb"],
    "busy_share": res["busy_ms"] / res["profiled_wall_ms"]}))
"""}


def _saliency_batch(path: str) -> None:
    """Phase 9's batch (its 3 cases, the first 2, ``default_rng(0)``),
    saved to ``path``."""
    import chip_smoke
    from pointunet_tpu_torch.core.config import brats_saliency_config
    from pointunet_tpu_torch.data.loader import (
        find_brats_cases,
        load_brats_case,
    )
    from pointunet_tpu_torch.data.sampler import patch_batches

    cfg = brats_saliency_config()
    with tempfile.TemporaryDirectory() as tmp:
        basedir = os.path.join(tmp, "brats")
        chip_smoke._write_cases(basedir, chip_smoke.N_CASES, tumour=True)
        records = [load_brats_case(c)[0] for c in find_brats_cases(basedir)]
    batch = next(patch_batches(records[:2], cfg.patch_size, cfg.batch_size,
                               np.random.default_rng(0), cfg.data_sampling))
    np.savez(path, **dict(zip(("images", "weights", "labels"),
                              map(np.asarray, batch))))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--phase", choices=tuple(RUN), default="serve")
    args = p.parse_args(argv)
    trees = {"A": args.tree_a, "B": args.tree_b}
    runs = []
    tmp = tempfile.TemporaryDirectory()
    batch = os.path.join(tmp.name, "batch.npz")
    if args.phase == "saliency_bf16":
        _saliency_batch(batch)
    for letter in args.order:
        tree = os.path.abspath(trees[letter])
        out = subprocess.run([sys.executable, "-c", RUN[args.phase], batch],
                             cwd=tree, capture_output=True, text=True)
        line = next((ln for ln in out.stdout.splitlines()
                     if ln.startswith("SERVE ")), None)
        if out.returncode or line is None:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"probe_serve_turns: {tree} failed "
                             f"(exit {out.returncode})")
        run = {"tree": trees[letter], **json.loads(line[6:])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(json.dumps(runs), flush=True)
    tmp.cleanup()
    return runs


if __name__ == "__main__":
    main()
