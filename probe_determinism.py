"""Whether the accuracy path's training is bit-reproducible on one CUDA
card, and where it is not.

    python3 probe_determinism.py [--steps 20] [--datasets brats pancreas]
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 probe_determinism.py --warn_only

On each dataset's reduced task (``cli/accuracy.py``'s volumes, clouds and
configs):

1. point net: one step of ``train_pointseg`` on cloud 0, twice from one
   state (``init_state(0)``), every parameter's gradient diffed layer by
   layer (bit-equal or its max |difference| over max |g|); then
   ``--steps`` steps on the clouds in turn, twice, the parameters
   compared bit for bit;
2. saliency net: ``--steps`` steps of ``train_saliency`` twice from one
   state, as ``cli/accuracy.py:train`` runs them (f32, TF32 convs, the
   stage's cuDNN settings), the weights compared bit for bit and each
   run's seconds; then the same with ``cudnn.deterministic`` off and on
   explicitly; then every conv of one training forward (its input,
   weight and options, captured) differentiated twice with cuDNN's own
   choice of algorithms: which gradients (input, weight) differ;
3. ``train_attention``'s step (``brats_saliency_config()``: batch 2 of
   (64, 160, 160), f32, remat, torch's default TF32 convs) on a seeded
   batch, a warm-up and ``--timed`` steps with ``cudnn.deterministic``
   off, on, on, off: ms a step (host clock, synced);
4. the gradient's row sum (``ops/gather.py:row_sum``) and ``index_add_``
   each launched twice on the card at the contract's level-0 up-sample
   (365,000 rows of width 32 into 91,250) and at the reduced task's
   level-1 neighbour gather (262,144 rows of width 32 into 16,384): bit
   equal or not.

``--warn_only`` instead runs one point step and one saliency step under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
each distinct warning (the ops with no deterministic CUDA implementation
that the steps reach), then, under the flag, ``--steps`` point and
saliency steps twice each, compared bit for bit. It exits 1 when the
default run (without ``--warn_only``) finds the point steps or the
saliency stage not bit-reproducible. It prints the card's name and
power limit first and a JSON object of everything last (with ``--out
DIR`` also written to ``DIR/determinism*.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.train.pointseg import PointSegTrainer


def _quiet(*_args) -> None:
    pass


def _setup(dataset: str):
    """The reduced task's run (volumes, configs, the saliency trainer)
    with no step taken, and its clouds."""
    cli = accuracy.parse_args(["--dataset", dataset, "--saliency_steps", "0",
                               "--pointseg_steps", "0"])
    run = accuracy.train(dataset, cli, log=_quiet)
    clouds = accuracy.sample_clouds(run.train_vols, run.task.n_points,
                                    run.device)
    return run, clouds


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _compare(a: dict, b: dict) -> dict:
    """Each tensor of ``a`` against ``b``'s: bit-equal, or its max
    |difference| over its max |value|."""
    out = {}
    for name, x in a.items():
        y = b[name]
        if torch.equal(x, y):
            out[name] = 0.0
        else:
            top = float(x.abs().max()) or 1.0
            out[name] = float((x.float() - y.float()).abs().max()) / top
    return out


def _summary(diff: dict) -> dict:
    differing = [n for n, d in diff.items() if d != 0.0]
    return {"tensors": len(diff), "differing": len(differing),
            "max_relative": max(diff.values(), default=0.0),
            "first_differing": differing[:8]}


def point_step_grads(run, clouds) -> tuple:
    """One step on cloud 0 from ``init_state(0)``: the gradients and the
    loss."""
    trainer = PointSegTrainer(run.pcfg, device=run.device)
    state = trainer.init_state()
    state, losses = accuracy.train_pointseg(trainer, state, clouds[:1], 1,
                                            _quiet)
    grads = {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters()}
    return grads, float(losses[0])


def point_steps(run, clouds, steps: int) -> tuple:
    trainer = PointSegTrainer(run.pcfg, device=run.device)
    state = trainer.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = accuracy.train_pointseg(trainer, state, clouds, steps,
                                            _quiet)
    torch.cuda.synchronize()
    return _params(state.model), time.perf_counter() - t0, losses


def _stage_settings() -> contextlib.ExitStack:
    """The saliency stage's cuDNN settings, as the tree's
    ``accuracy.train`` enters them."""
    stack = contextlib.ExitStack()
    stack.enter_context(accuracy.tf32_convs())
    if hasattr(accuracy, "deterministic_convs"):
        stack.enter_context(accuracy.deterministic_convs())
    return stack


def saliency_steps(run, steps: int, deterministic=None) -> tuple:
    """``steps`` saliency steps from ``init_state()`` inside the stage's
    own settings, with ``cudnn.deterministic`` forced to
    ``deterministic`` when given."""
    records = accuracy.saliency_records(run.train_vols, run.dataset)
    state = run.strainer.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _stage_settings(), _cudnn_deterministic(deterministic):
        state, losses = accuracy.train_saliency(run.strainer, state, records,
                                                steps, _quiet)
        torch.cuda.synchronize()
    return _params(state.model), time.perf_counter() - t0, losses


@contextlib.contextmanager
def _cudnn_deterministic(value):
    old = torch.backends.cudnn.deterministic
    if value is not None:
        torch.backends.cudnn.deterministic = value
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def conv_grads(run) -> list:
    """Every ``F.conv3d`` call of one training forward of the saliency
    net on a patch, differentiated twice (TF32 convs, cuDNN's own
    choice): whether the input's and the weight's gradients are
    bit-equal, a distinct call shape each."""
    import torch.nn.functional as F

    records = accuracy.saliency_records(run.train_vols, run.dataset)
    batches = accuracy.patch_batches(
        records, run.strainer.cfg.patch_size, 1, np.random.default_rng(1),
        "one_positive")
    images, _, _ = run.strainer.prepare(*next(batches))
    model = run.strainer.init_state().model.train()
    calls, real = [], F.conv3d

    def record(x, w, b=None, **opts):
        calls.append((x.detach(), w.detach(),
                      None if b is None else b.detach(), opts))
        return real(x, w, b, **opts)

    F.conv3d = record
    try:
        with torch.no_grad():
            model(images)
    finally:
        F.conv3d = real
    out, seen = [], set()
    with accuracy.tf32_convs(), _cudnn_deterministic(False):
        for x, w, b, opts in calls:
            key = (tuple(x.shape), tuple(w.shape), repr(opts))
            if key in seen:
                continue
            seen.add(key)
            gy = torch.randn_like(real(x, w, b, **opts))
            grads = []
            for _ in range(2):
                xg = x.clone().requires_grad_(True)
                wg = w.clone().requires_grad_(True)
                grads.append(torch.autograd.grad(
                    real(xg, wg, b, **opts), (xg, wg), gy))
            out.append({"x": list(x.shape), "w": list(w.shape),
                        "options": repr(opts),
                        "input_grad_equal": torch.equal(grads[0][0],
                                                        grads[1][0]),
                        "weight_grad_equal": torch.equal(grads[0][1],
                                                         grads[1][1])})
    bad = [r for r in out
           if not (r["input_grad_equal"] and r["weight_grad_equal"])]
    print(f"{run.dataset} convs: {len(out)} call shapes, "
          f"{sum(not r['input_grad_equal'] for r in out)} with an input "
          f"gradient and {sum(not r['weight_grad_equal'] for r in out)} "
          f"with a weight gradient that differ across two launches",
          flush=True)
    for r in bad:
        print(f"  differs: {json.dumps(r)}", flush=True)
    return out


def train_attention_step(dev, timed: int) -> dict:
    """ms a step of ``train_attention``'s config with
    ``cudnn.deterministic`` off, on, on, off (a warm-up step before
    each)."""
    from pointunet_tpu_torch.core.config import TrainConfig, brats_saliency_config
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    cfg = brats_saliency_config()
    trainer = SaliencyTrainer(cfg, TrainConfig(), device=str(dev))
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    b, (d, h, w) = cfg.batch_size, cfg.patch_size
    images = rng.standard_normal((b, d, h, w, cfg.in_channels)).astype(
        np.float32)
    weights = np.ones((b, d, h, w), np.float32)
    labels = (rng.uniform(size=(b, d, h, w)) < 0.1).astype(np.int32)
    out = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        with _cudnn_deterministic(label == "on"):
            trainer.train_step(state, images, weights, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed):
                trainer.train_step(state, images, weights, labels)
            torch.cuda.synchronize()
        out[label].append((time.perf_counter() - t0) * 1e3 / timed)
    print(f"train_attention step ms, cudnn.deterministic off {out['off']}, "
          f"on {out['on']}", flush=True)
    return out


def row_sum_relaunch(dev) -> list:
    """The row sum and ``index_add_`` launched twice each at two shapes:
    bit-equal or the max |difference|."""
    from pointunet_tpu_torch.ops import gather

    out = []
    g = torch.Generator(device=dev).manual_seed(0)
    for name, rows, n, c in (("contract L0 up-sample", 365_000, 91_250, 32),
                             ("reduced L1 gather", 262_144, 16_384, 32)):
        ct = torch.randn(rows, c, device=dev, generator=g)
        idx = torch.randint(0, n, (rows,), device=dev, generator=g)
        row = {"case": name, "rows": rows, "n": n, "c": c}
        fns = {"index_add_": lambda: torch.zeros(n, c, device=dev).index_add_(
            0, idx, ct)}
        if hasattr(gather, "row_sum"):
            fns["row_sum"] = lambda: gather.row_sum(ct, idx, n)
            fns["row_sum_bf16"] = lambda: gather.row_sum(ct.bfloat16(), idx, n)
        for key, fn in fns.items():
            a, b = fn(), fn()
            row[key] = 0.0 if torch.equal(a, b) else float((a - b).abs().max())
        out.append(row)
        print(f"relaunch {json.dumps(row)}", flush=True)
    return out


def warn_only(datasets, steps: int) -> dict:
    """One point step and one saliency step a dataset under
    ``use_deterministic_algorithms(True, warn_only=True)``: the distinct
    warnings; then ``steps`` point and saliency steps twice each under
    the flag, compared."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen, repeats = {}, {}
    for dataset in datasets:
        run, clouds = _setup(dataset)
        (p1, _, _), (p2, _, _) = (point_steps(run, clouds, steps)
                                  for _ in range(2))
        (s1, _, _), (s2, _, _) = (saliency_steps(run, steps)
                                  for _ in range(2))
        repeats[dataset] = {"point": _summary(_compare(p1, p2)),
                            "saliency": _summary(_compare(s1, s2))}
        print(f"{dataset} under the flag, {steps} steps twice: "
              f"{json.dumps(repeats[dataset])}", flush=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            point_step_grads(run, clouds)
            n_point = len(caught)
            saliency_steps(run, 1)
        for i, w in enumerate(caught):
            key = str(w.message).split("\n")[0]
            where = "point" if i < n_point else "saliency"
            seen.setdefault(key, set()).add(f"{dataset} {where}")
    out = {k: sorted(v) for k, v in seen.items()}
    for k, v in out.items():
        print(f"nondeterministic: {k} [{', '.join(v)}]", flush=True)
    return {"warnings": out, "repeats_under_the_flag": repeats,
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--datasets", nargs="+", default=["brats", "pancreas"],
                   choices=("brats", "pancreas"))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warn_only", action="store_true")
    p.add_argument("--out", default=None,
                   help="a directory to write the JSON object to")
    p.add_argument("--timed", type=int, default=3,
                   help="timed train_attention steps a setting")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_determinism: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "torch": torch.__version__}
    if args.warn_only:
        out.update(warn_only(args.datasets, args.steps))
        name = "determinism_warn_only.json"
    else:
        out["relaunch"] = row_sum_relaunch(torch.device("cuda", 0))
        for dataset in args.datasets:
            run, clouds = _setup(dataset)
            res = {}
            (g1, l1), (g2, l2) = (point_step_grads(run, clouds)
                                  for _ in range(2))
            diff = _compare(g1, g2)
            res["point_step_grads"] = {"losses": [l1, l2], "by_layer": diff,
                                       **_summary(diff)}
            print(f"{dataset} point step gradients: "
                  f"{json.dumps(_summary(diff))}; losses {l1!r} {l2!r}",
                  flush=True)
            (p1, s1, _), (p2, s2, _) = (point_steps(run, clouds, args.steps)
                                        for _ in range(2))
            res["point_steps"] = {"seconds": [s1, s2],
                                  **_summary(_compare(p1, p2))}
            print(f"{dataset} {args.steps} point steps: "
                  f"{json.dumps(res['point_steps'])}", flush=True)
            for label, det in (("stage", None), ("deterministic_off", False),
                               ("deterministic_on", True)):
                (p1, s1, l1), (p2, s2, _) = (
                    saliency_steps(run, args.steps, det) for _ in range(2))
                res[f"saliency_{label}"] = {
                    "seconds": [s1, s2], "loss_last": float(l1[-1]),
                    **_summary(_compare(p1, p2))}
                print(f"{dataset} {args.steps} saliency steps ({label}): "
                      f"{json.dumps(res[f'saliency_{label}'])}", flush=True)
            res["convs"] = conv_grads(run)
            out[dataset] = res
            del run, clouds
            torch.cuda.empty_cache()
        out["train_attention_step_ms"] = train_attention_step(
            torch.device("cuda", 0), args.timed)
        name = "determinism.json"
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("brats", "pancreas")}), flush=True)
    return out


def reproducible(out: dict) -> bool:
    """The default run's verdict: every dataset's point steps and its
    saliency stage bit-equal across two runs."""
    return all(out[d]["point_steps"]["differing"] == 0
               and out[d]["saliency_stage"]["differing"] == 0
               for d in ("brats", "pancreas") if d in out)


if __name__ == "__main__":
    sys.exit(0 if reproducible(main()) else 1)
