"""Point-net training: ``PointSegTrainer.train_step`` on seeded clouds, one
cloud a step, drawn in turn from a pool, as a researcher's stage-2 run
takes its clouds.

Traffic parameters (``traffic/<mix>.json``): ``pool``, the tumour-ball
voxel counts of the seeded clouds (each the configuration's point count:
the ball plus random background); ``checked_steps``, the first steps,
taken in set-up on clouds that all differ, which the reference follows;
``trace``, the steps run under the profiler after the window.

Set-up builds the trainer and its state (model and Adam), fills the
weights from the seed on the device, makes the pool on the device and
runs the checked steps through ``train_step`` itself; that same state
goes on into the window, which runs steps until ``seconds`` have passed.
"""
from __future__ import annotations

import time

import torch

from .. import device as device_mod
from .. import phantoms, spans as spans_mod, weights
from ..reference import judge_train, randlanet
from ..reference.precision import strict_f32
from .serve_volumes import _tuples

ADAM_B1 = 0.9
SPANS = (("pyramid_fn", "pyramid"), ("forward_loss", "forward_loss"),
         ("apply_update", "apply_update"))


def build(cfg: dict, seed: int, dev):
    from pointunet_tpu_torch.core.config import PointSegConfig
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    trainer = PointSegTrainer(PointSegConfig(**_tuples(cfg["pointseg"])),
                              device=str(dev))
    state = trainer.init_state()
    w0 = {k: v.clone() for k, v in
          weights.fill(state.model, weights.sub_seed(seed, 1)).items()}
    state.generator.manual_seed(weights.sub_seed(seed, 12))
    return trainer, state, w0


def pool(cfg: dict, traffic: dict, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(weights.sub_seed(seed, 3))
    return [phantoms.cloud(cfg, v, g, dev) for v in traffic["pool"]]


def _norm(t) -> float:
    """The norm of an optimizer state tensor; 0 where the optimizer has
    none (it never stepped)."""
    return 0.0 if t is None else float(t.norm())


def first_steps(trainer, state, clouds, w0, steps: int, step) -> dict:
    """Run ``steps`` steps through ``step(i)``: the losses, the first
    gradient's norms (Adam's first moment after one step over 1 - b1),
    each leaf's change after them and the first forward's logits (in the
    pyramid's level-0 order)."""
    losses, grads, first = [], None, []
    hook = state.model.register_forward_hook(
        lambda _m, _i, out: first.append(out.detach().clone()) if not first else None)
    for i in range(steps):
        losses.append(float(step(i)["loss"]))
        hook.remove()
        if grads is None:
            grads = {k: _norm(state.optimizer.state[p].get("exp_avg")) / (1 - ADAM_B1)
                     for k, p in state.model.named_parameters()}
    update = {k: float((p.detach() - w0[k]).norm())
              for k, p in state.model.named_parameters()}
    return {"losses": losses, "grad_norms": grads, "update_norms": update,
            "logits0": first[0][0]}


def run(cell) -> dict:
    cfg, traffic, seed, dev = cell.cfg, cell.traffic, cell.seed, cell.device
    trainer, state, w0 = build(cfg, seed, dev)
    phases = {"built": time.perf_counter() - cell.t0}
    clouds = pool(cfg, traffic, seed, dev)
    phases["pool"] = time.perf_counter() - cell.t0
    sp = spans_mod.Spans(timed=cell.trace)
    for method, name in SPANS:
        sp.wrap(trainer, method, name)

    def step(i: int):
        return trainer.train_step(state, *clouds[i % len(clouds)])[1]

    checked = traffic["checked_steps"]
    port = first_steps(trainer, state, clouds, w0, checked, step)
    device_mod.sync(dev)
    setup_s = time.perf_counter() - cell.t0

    steps, start = 0, time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        sp.begin()
        step(checked + steps)
        steps += 1
    device_mod.sync(dev)
    window_s = time.perf_counter() - start
    peak = device_mod.peak(dev)
    out = {
        "phases": phases, "attempted": steps, "failed": 0, "errors": [], "setup_s": setup_s,
        "peak": peak,
        "e2e": {"train_step_ms": window_s * 1e3 / steps, "setup_s": setup_s},
        "record": {"step_s": window_s / steps, "path": "train_point",
                   "work": cell.counter.train_point(cfg), "cfg": cfg},
    }
    if cell.trace:
        out["record"]["rows"] = sp.rows()
        prof = spans_mod.profile(lambda: step(0), traffic["trace"],
                                 stages={n for _, n in SPANS})
        out["profile"] = out["record"]["profile"] = prof
    del trainer, state
    device_mod.release(dev)
    with strict_f32():
        ref = randlanet.train_steps(cfg, w0, clouds[:checked],
                                    weights.sub_seed(seed, 12))
    out["checks"] = judge_train.judge(port, ref)
    return out
