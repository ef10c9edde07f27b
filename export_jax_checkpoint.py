"""Export the JAX package's train-state checkpoints for the PyTorch port.

    python export_jax_checkpoint.py (--src DIR | --init SEED) --out DIR \
        --stage {pointseg,saliency} [--dataset {brats,pancreas}] \
        [--net {attention,unet3d}] [--instance_norm | --batch_norm]

``--init SEED`` writes the reference trainer's fresh ``init_state(SEED)``
as ``<out>/0.npz`` instead: the JAX package's initial draw, which
``probe_accuracy.py`` trains the port from.

Runs on a host with JAX: ``--src`` is a directory that the JAX package's
``BestMetricCheckpointer`` (orbax) wrote, e.g. ``run_brats``'s
``<logdir>/snapshots`` or ``train_attention``'s. The reference trainer of
``--stage`` (``--dataset``'s config; for ``saliency``, ``--net`` and the
norm flavour) gives the template state; every step is restored into it
with the reference's own checkpointer and written flat, as
``pointunet_tpu_torch/convert.py`` takes it:

* ``pointseg``: ``params/...``, ``batch_stats/...``, Adam's ``mu/...``
  and ``nu/...``, its ``count``, ``step``;
* ``saliency``: ``params/...``, ``batch_stats/...`` (batch-norm flavour
  only), the momentum ``trace/...``, the schedule's ``count``, ``step``;

and the state's ``rng`` (a ``jax.random`` key, which the port skips).
Output, the port's checkpoint layout with ``.npz`` (compressed) where
the port writes ``.pt``: ``<out>/<step>.npz`` for each step, ``<out>/best/<step>.npz``
for the best one and a copy of ``best.json``. Every CLI of the port
restores from ``<out>`` through its existing checkpoint flag
(``--saliency_checkpoint``, ``--pointseg_checkpoint``,
``--checkpoint_path``). This file is the one that imports both JAX and
the JAX package; the port never imports it.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Any, Dict

import jax
import numpy as np
from flax import traverse_util

from pointunet_tpu.core.checkpoint import BestMetricCheckpointer


def _flat(tree, prefix: str) -> Dict[str, np.ndarray]:
    return {
        f"{prefix}/{k}": np.asarray(v)
        for k, v in traverse_util.flatten_dict(tree, sep="/").items()
    }


def _rng(key) -> np.ndarray:
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key)


def flatten_state(state: Any, stage: str) -> Dict[str, np.ndarray]:
    """A reference ``TrainState`` (``stage`` pointseg) or
    ``SaliencyTrainState`` (saliency) -> the flat dict the port reads."""
    flat = _flat(state.params, "params")
    flat.update(_flat(state.batch_stats, "batch_stats"))
    if stage == "pointseg":
        adam = state.opt_state[0]                  # optax ScaleByAdamState
        flat.update(_flat(adam.mu, "mu"))
        flat.update(_flat(adam.nu, "nu"))
        count = adam.count
    else:
        trace, sched = state.opt_state[1]          # after the decay mask
        flat.update(_flat(trace.trace, "trace"))
        count = sched.count
    flat["count"] = np.asarray(count)
    flat["step"] = np.asarray(state.step)
    flat["rng"] = _rng(state.rng)
    return flat


def _save(flat: Dict[str, np.ndarray], path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


def export(src: str, out: str, template: Any, stage: str) -> Dict[str, int]:
    """Write every step of the orbax directory ``src`` (and its best one)
    under ``out``, restored into ``template``; {"steps", "best"} counts."""
    if not os.path.isdir(src):
        raise SystemExit(f"no checkpoint directory {src}")
    steps = sorted(int(n) for n in os.listdir(src)
                   if n.isdigit() and os.path.isdir(os.path.join(src, n)))
    if not steps:
        raise SystemExit(f"no orbax checkpoint under {src}")
    ckpt = BestMetricCheckpointer(src)
    try:
        os.makedirs(os.path.join(out, "best"), exist_ok=True)
        for step in steps:
            state = ckpt.restore(step, template)
            _save(flatten_state(state, stage),
                  os.path.join(out, f"{step}.npz"))
        best = ckpt.best_step()
        if best is not None:
            state = ckpt.restore_best(template)
            _save(flatten_state(state, stage),
                  os.path.join(out, "best", f"{best}.npz"))
            shutil.copyfile(os.path.join(src, "best.json"),
                            os.path.join(out, "best.json"))
    finally:
        ckpt.close()
    return {"steps": len(steps), "best": int(best is not None)}


def template_state(args, seed: int = 0) -> Any:
    """The reference trainer's ``init_state(seed)`` for the flags.
    Parameter shapes do not depend on the point count or the patch, and
    both ``init_*`` functions init at a minimal cloud or patch."""
    from pointunet_tpu.core import config

    if args.stage == "pointseg":
        from pointunet_tpu.train.pointseg import PointSegTrainer

        cfg = getattr(config, f"{args.dataset}_pointseg_config")()
        return PointSegTrainer(cfg).init_state(seed)
    from pointunet_tpu.train.saliency import SaliencyTrainer

    cfg = getattr(config, f"{args.dataset}_saliency_config")(
        instance_norm=args.instance_norm
    )
    return SaliencyTrainer(
        cfg, attention=args.net == "attention"
    ).init_state(seed)


def main(argv=None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description=__doc__)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--src", type=str,
                     help="orbax checkpoint directory of the JAX package")
    src.add_argument("--init", type=int,
                     help="write the fresh init_state(INIT) as step 0")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--stage", choices=["pointseg", "saliency"],
                        required=True)
    parser.add_argument("--dataset", choices=["brats", "pancreas"],
                        default="brats")
    parser.add_argument("--net", choices=["attention", "unet3d"],
                        default="attention", help="the saliency net")
    norm = parser.add_mutually_exclusive_group()
    norm.add_argument("--instance_norm", dest="instance_norm",
                      action="store_true", default=True)
    norm.add_argument("--batch_norm", dest="instance_norm",
                      action="store_false")
    args = parser.parse_args(argv)
    if args.init is not None:
        os.makedirs(args.out, exist_ok=True)
        _save(flatten_state(template_state(args, args.init), args.stage),
              os.path.join(args.out, "0.npz"))
        print(f"exported init_state({args.init}) to {args.out}/0.npz")
        return {"steps": 1, "best": 0}
    counts = export(args.src, args.out, template_state(args), args.stage)
    print(f"exported {counts['steps']} steps"
          f"{' and the best one' if counts['best'] else ''} to {args.out}")
    return counts


if __name__ == "__main__":
    main()
